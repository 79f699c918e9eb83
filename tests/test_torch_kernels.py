"""The port's kernel modules on the CPU: each wrapper's plain version held
against ``repro``'s kernel oracle and its Pallas kernel in interpret mode.

The CUDA kernels themselves run only on the card (tests/test_torch_gpu.py
and chip_smoke.py); here the wrappers take their plain versions because
the tensors lie on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noise import DEFAULT as J_DEFAULT
from repro.core.slicing import RESIDUAL_GAIN as J_RESIDUAL_GAIN
from repro.core.slicing import plan_asl as j_plan_asl
from repro.kernels.dual_compute.ops import fused_linear_acam as j_fused_linear
from repro.kernels.dual_compute.ref import fused_crossbar_acam_ref as j_fused_ref
from repro.kernels.dual_compute.ops import (
    logdomain_flash_attention as j_logdomain_flash)
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.paged_attention.ops import paged_attention as j_paged
from repro.nn.attention import blockwise_attention as j_blockwise

from repro_torch.core.acam import get_table, table_thresholds
from repro_torch.core.slicing import RESIDUAL_GAIN
from repro_torch.kernels import build
from repro_torch.kernels.dual_compute.ops import (fused_crossbar_acam,
                                                  fused_linear_acam,
                                                  logdomain_flash_attention,
                                                  program)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (num_splits,
                                                     paged_attention,
                                                     smem_bytes)
from repro_torch.kernels.paged_attention.ops import plan as paged_plan

torch.set_num_threads(1)

PAGED_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 einsums in another order


def _paged_case(seed, b=3, hq=4, hkv=2, p=12, nb=4, ps=5, d=16, q_len=1,
                sentinels=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, q_len, d)).astype(np.float32)
    kp = rng.normal(size=(p, hkv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(p, hkv, ps, d)).astype(np.float32)
    bt = rng.permutation(p)[:b * nb].reshape(b, nb).astype(np.int32)
    if sentinels:
        bt[0, -1] = p               # unmapped sentinel
        bt[1, 2] = -1               # negative sentinel mid-table
    # staircase bases: row j attends [0, len + j), len + q_len - 1 <= nb*ps
    lengths = rng.integers(ps + 1, nb * ps - q_len + 2, b).astype(np.int32)
    return q, kp, vp, bt, lengths


def _both(q, kp, vp, bt, lengths, interpret=False):
    mine = paged_attention(*(torch.from_numpy(a) for a in
                             (q, kp, vp, bt, lengths)))
    kw = {"interpret": True} if interpret else {"use_ref": True}
    ref = j_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, lengths)), **kw)
    return mine.numpy(), np.asarray(ref)


@pytest.mark.parametrize("q_len", [1, 3, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_paged_attention_matches_repro_ref(q_len, seed):
    """Decode (Q=1) and the chunk staircase (Q>1), sentinel entries in the
    table: the plain version equals ``paged_attention(use_ref=True)``."""
    mine, ref = _both(*_paged_case(seed, q_len=q_len))
    np.testing.assert_allclose(mine, ref, **PAGED_TOL)


def test_plain_paged_attention_matches_pallas_interpret():
    """...and ``repro``'s Pallas kernel run in interpret mode."""
    mine, ref = _both(*_paged_case(2, q_len=4), interpret=True)
    np.testing.assert_allclose(mine, ref, **PAGED_TOL)


def test_plain_paged_attention_bf16_pool():
    """A bf16 pool is read as bf16 and widened per element — the values
    ``repro``'s wrapper gets by upcasting the pool."""
    q, kp, vp, bt, lengths = _paged_case(3, q_len=2)
    kb = torch.from_numpy(kp).to(torch.bfloat16)
    vb = torch.from_numpy(vp).to(torch.bfloat16)
    mine = paged_attention(torch.from_numpy(q), kb, vb, torch.from_numpy(bt),
                           torch.from_numpy(lengths))
    ref = j_paged(jnp.asarray(q), jnp.asarray(kb.float().numpy()),
                  jnp.asarray(vb.float().numpy()), jnp.asarray(bt),
                  jnp.asarray(lengths), use_ref=True)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **PAGED_TOL)


def test_plain_paged_attention_sentinel_page_is_never_read():
    """Poisoning the page a sentinel would alias changes nothing for the
    slot holding the sentinel (tests/test_kernel_conformance.py:245)."""
    q, kp, vp, bt, lengths = _paged_case(4, sentinels=False)
    p = kp.shape[0]
    bt[1, -1] = p
    lengths[1] = bt.shape[1] * kp.shape[2]       # overrun into the sentinel
    victim = bt[0, 0]
    base, _ = _both(q, kp, vp, bt, lengths)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[victim] += 100.0
    vp2[victim] += 100.0
    assert victim not in bt[1]                   # slot 1 never maps it
    poisoned, _ = _both(q, kp2, vp2, bt, lengths)
    np.testing.assert_array_equal(poisoned[1], base[1])
    assert not np.allclose(poisoned[0], base[0])


def test_plain_paged_attention_fully_masked_row_is_zero():
    q = torch.ones((1, 2, 1, 8))
    kp = torch.ones((2, 1, 4, 8))
    out = paged_attention(q, kp, kp, torch.tensor([[2, 2]], dtype=torch.int32),
                          torch.tensor([3], dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


def test_cpu_tensors_never_launch():
    wrappers = (paged_attention, fused_crossbar_acam, flash_attention,
                logdomain_flash_attention)
    before = [w.launches for w in wrappers]
    paged_attention(*(torch.from_numpy(a) for a in _paged_case(5)))
    fused_linear_acam(torch.ones((2, 8)), torch.ones((8, 4)), "silu")
    q = torch.ones((1, 2, 3, 8))
    flash_attention(q, q[:, :1], q[:, :1])
    logdomain_flash_attention(q, q[:, :1], q[:, :1])
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("units,steps,want", [
    (32, 2, 16),   # full-width decode: 1024 positions = 32 block steps
    (16, 2, 8),    # chunk prefill: 1024 positions = 16 stages
    (33, 2, 17),   # a ragged last split
    (1, 2, 1),     # a short table: one split
    (0, 2, 1),     # never no split
])
def test_split_heuristic(units, steps, want):
    """The grid's splits of a block table of ``units`` steps, at most
    ``steps`` a split."""
    assert num_splits(units, steps) == want


@pytest.mark.parametrize("q_len,g,want", [
    (1, 8, ("decode", 8, 1)),      # a decode tick of Qwen2.5-3B
    (1, 1, ("decode", 8, 1)),
    (2, 8, ("decode", 16, 1)),     # 16 rows: the largest decode tile
    (9, 1, ("decode", 16, 1)),
    (17, 1, ("chunk", 64, 1)),
    (5, 8, ("chunk", 64, 1)),      # 40 rows
    (64, 1, ("chunk", 64, 1)),
    (65, 1, ("chunk", 128, 1)),
    (64, 8, ("chunk", 128, 4)),    # chunk prefill: 512 rows, 4 tiles
    (65, 8, ("chunk", 128, 5)),
])
def test_plan_instance_rows_and_tiles(q_len, g, want):
    """G*Q <= 16 takes the decode instance (rows rounded up to 8), more
    the chunk instance (64 rows up to 64, else 128-row tiles); K/V are
    staged once per tile: ceil(G*Q / rows) times per (sequence, head)."""
    pl = paged_plan(8, 2, g * q_len, 64, 16, 128, 0)
    assert (pl.instance, pl.rows, pl.tiles) == want


def test_plan_stages_and_splits_at_full_width():
    """Qwen2.5-3B's kernel-A calls (8 slots, 2 KV heads, 64 pages of 16):
    the decode ring is 2, 3, 4 stages deep for f32, bf16 and code pools,
    the chunk ring 2; decode cuts the table into 16 splits of 64
    positions; chunk gives the grid the splits of the longest sequence
    the table holds (at most 1024 + G*Q - 1 positions: 24 stages at 512
    rows, 17 at 40), 3 stages a split at 128-row tiles (8 splits) and 2 at
    64-row ones (9 splits), and the kernel takes each sequence's busy
    splits from its own length."""
    for kind, stages in ((0, 2), (1, 3), (2, 4)):
        dec = paged_plan(8, 2, 8, 64, 16, 128, kind)
        assert (dec.stages, dec.splits) == (stages, 16)
        ch = paged_plan(8, 2, 512, 64, 16, 128, kind)
        assert (ch.stages, ch.splits) == (2, 8)
        verify = paged_plan(8, 2, 40, 64, 16, 128, kind)
        assert (verify.rows, verify.splits) == (64, 9)
    # a short table keeps at least two steps a split; a long one at most
    # CH_MAX_SPLITS splits
    assert paged_plan(8, 2, 8, 4, 16, 128, 0).splits == 1
    assert paged_plan(1, 2, 512, 8, 16, 128, 0).splits == 4
    assert paged_plan(1, 2, 512, 4096, 16, 128, 0).splits == 16


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["f32", "bf16", "codes"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_plan_shared_memory_fits_every_page_size(d, kind):
    """Every instance fits the card's 227 KB of shared memory per block
    for every page size up to 32 (a stage holds positions, not pages, so
    the page size does not enter it); f32 chunk at D = 128 is the
    largest, 230912 B of 232448."""
    for ps in range(1, 33):
        for n_rows in (1, 8, 9, 16, 17, 40, 64, 65, 512):
            pl = paged_plan(8, 2, n_rows, -(-1024 // ps), ps, d, kind)
            assert 0 < pl.smem <= 227 * 1024
    assert smem_bytes(128, 128, 0) == 230912


def _fused_inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("m,k,n", [(8, 64, 96), (13, 100, 37)])
def test_plain_fused_crossbar_acam_matches_repro_ref(m, k, n):
    """Same cells, inv and table as ``fused_crossbar_acam_ref``: equal ACAM
    codes.  The f32 matmul's sum order could move a pre-activation across
    an interval edge, so one output may be one code apart; measured: 0 of
    768 and 0 of 481 outputs differ."""
    x, w = _fused_inputs(m, m, k, n)
    table = get_table("silu", 8)
    cells, inv = program(torch.from_numpy(w))
    lo, hi = table_thresholds(table, "cpu")
    step = float(table.out_spec.step)
    mine = fused_crossbar_acam(torch.from_numpy(x), *cells, inv, lo, hi,
                               out_lo=float(table.out_spec.lo),
                               out_step=step).numpy()
    ref = np.asarray(j_fused_ref(
        jnp.asarray(x), *(jnp.asarray(c.numpy()) for c in cells),
        jnp.asarray(inv.numpy()), jnp.asarray(table.lo),
        jnp.asarray(table.hi), 8, float(table.out_spec.lo), step,
        J_RESIDUAL_GAIN))
    diff = np.abs(mine - ref)
    assert diff.max() <= step * 1.0001
    assert (diff > 1e-6).sum() <= 1


@pytest.mark.parametrize("m,k,n", [(5, 40, 24), (16, 128, 130)])
def test_plain_fused_linear_acam_matches_repro_interpret(m, k, n):
    """Model level, ragged shapes: ``fused_linear_acam`` against
    ``repro``'s (programming + Pallas kernel in interpret mode, which pads
    to 128 with g_min cells where the port masks).  At most one output one
    code apart, as above; measured: 0 of 120 and 0 of 2080 outputs differ
    (the largest difference, 3.7e-6 of a code, is the decode's rounding)."""
    x, w = _fused_inputs(100 + m, m, k, n)
    table = get_table("silu", 8)
    step = float(table.out_spec.step)
    mine = fused_linear_acam(torch.from_numpy(x), torch.from_numpy(w),
                             "silu").numpy()
    ref = np.asarray(j_fused_linear(jnp.asarray(x), jnp.asarray(w), "silu",
                                    interpret=True))
    diff = np.abs(mine - ref)
    assert diff.max() <= step * 1.0001
    assert (diff > 1e-6).sum() <= 1


def test_programming_matches_repro_cells():
    x, w = _fused_inputs(7, 4, 32, 48)
    cells, _ = program(torch.from_numpy(w))
    jw = jnp.asarray(w)
    plan, _ = j_plan_asl(jw, jnp.maximum(jnp.max(jnp.abs(jw)), 1e-9),
                         J_DEFAULT, prog_rng=None)
    for got, want in zip(cells, [plan.g_pos_main, plan.g_neg_main,
                                 plan.g_pos_res, plan.g_neg_res]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert RESIDUAL_GAIN == J_RESIDUAL_GAIN


def test_build_targets_hopper_from_repo_sources():
    """Every kernel source exists and compiles for sm_90a into the
    ignored build directory (the compile itself runs on the card)."""
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build._target(name).parent == build.BUILD_DIR
    assert build.ARCH_FLAGS == ("-gencode", "arch=compute_90a,code=sm_90a")
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")


# (B, Hq, Hkv, Lq, Lk, D): tests/test_kernel_conformance.py's ATTN_SHAPES —
# GQA groups 1, 2 and 4, odd lengths, Lq < Lk
ATTN_SHAPES = [(1, 2, 2, 16, 16, 8), (2, 4, 2, 32, 32, 16),
               (1, 4, 1, 8, 40, 32), (1, 2, 2, 1, 24, 16),
               (2, 2, 1, 12, 20, 8)]
FLASH_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums in another order
EXP_LSB = 1.0 / 255                      # one exp-grid LSB


def _attn_inputs(shape, seed=0):
    b, hq, hkv, lq, lk, d = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_plain_flash_attention_matches_repro(shape):
    """Plain F against ``repro``'s ``flash_attention`` (the Pallas kernel
    in interpret mode, 8x8 blocks) and, where Lq == Lk, against
    ``blockwise_attention`` (the lax twin its OFF prefill runs).  The
    Pallas kernel scales q by 1/(d**0.5), ``blockwise_attention`` divides
    by sqrt(d): both within 1e-5 (measured <= 5.4e-7)."""
    q, k, v = _attn_inputs(shape)
    mine = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = j_flash(*map(jnp.asarray, (q, k, v)), bq=8, bk=8, interpret=True)
    np.testing.assert_allclose(mine, np.asarray(ref), **FLASH_TOL)
    if shape[3] == shape[4]:
        bw = j_blockwise(*map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(mine, np.asarray(bw), **FLASH_TOL)


def test_plain_flash_attention_bf16_and_masked_rows():
    """bf16 inputs are upcast and the output cast back, as ``repro``'s
    wrapper does; rows with no visible key (Lq > Lk) give 0."""
    q, k, v = _attn_inputs((1, 4, 2, 6, 6, 16), seed=1)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    mine = flash_attention(qb, kb, vb)
    assert mine.dtype == torch.bfloat16
    ref = j_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                    for t in (qb, kb, vb)), bq=2, bk=2, interpret=True)
    assert ref.dtype == jnp.bfloat16
    # the same f32 result may round to neighbouring bf16 values
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2 ** -7,
                               atol=1e-5)
    q, k, v = _attn_inputs((1, 2, 1, 7, 3, 8), seed=2)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_plain_logdomain_flash_matches_repro(shape):
    """Plain C (the materialized NL-DPE attention) against ``repro``'s
    ``logdomain_flash_attention``: its Pallas kernel in interpret mode on
    every shape, and its ``use_ref=True`` oracle on the two with GQA
    groups (2 and 4; ``repro``'s own tests hold kernel and oracle together
    on the rest), within one exp-grid LSB, 1/255 (``repro``'s own
    tolerance; measured <= 2.2e-6)."""
    q, k, v = _attn_inputs(shape, seed=3)
    mine = logdomain_flash_attention(*map(torch.from_numpy,
                                          (q, k, v))).numpy()
    args = tuple(map(jnp.asarray, (q, k, v)))
    oracles = ({"interpret": True}, {"use_ref": True})
    for kw in oracles if shape in ATTN_SHAPES[1:3] else oracles[:1]:
        ref = np.asarray(j_logdomain_flash(*args, **kw))
        assert np.abs(mine - ref).max() <= EXP_LSB, kw


@pytest.mark.parametrize("shape", [ATTN_SHAPES[1], ATTN_SHAPES[2]])
def test_plain_logdomain_flash_bf16_matches_repro(shape):
    """bf16 inputs, as the configs' bf16 activations give kernel C: q, k
    and v are upcast to f32 before they are log-quantized, as ``repro``'s
    kernel path does, and the output is cast back.  Against its Pallas
    kernel in interpret mode: one exp-grid LSB, plus one bf16 step where
    the same f32 result rounds to neighbouring bf16 values."""
    q, k, v = _attn_inputs(shape, seed=4)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    mine = logdomain_flash_attention(qb, kb, vb)
    assert mine.dtype == torch.bfloat16
    ref = j_logdomain_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                              for t in (qb, kb, vb)), interpret=True)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    err = np.abs(mine.float().numpy() - ref)
    assert (err <= EXP_LSB + 2 ** -7 * np.abs(ref)).all(), err.max()


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "mask"])
@pytest.mark.parametrize("mode", ["OFF", "ON", "FUSED"])
def test_attention_dispatch_matches_repro(mode, masked):
    """``NLDPEConfig.attention`` with GQA inputs: maskless causal FUSED
    streams through kernel C's path, masked or ON calls repeat K/V into
    the materialized NL-DPE attention, OFF runs ``reference_attention`` —
    each against ``repro``'s dispatcher (FUSED through its Pallas kernel
    in interpret mode): f32 sums in another order, 1e-5 (OFF) and one
    exp-grid LSB (NL-DPE)."""
    from repro.core.engine import NLDPEConfig as JNLDPEConfig

    from repro_torch.core.engine import FUSED, OFF, ON
    mine_cfg = {"OFF": OFF, "ON": ON, "FUSED": FUSED}[mode]
    ref_cfg = JNLDPEConfig(enabled=mode != "OFF",
                           fused_dual_compute=mode == "FUSED")
    q, k, v = _attn_inputs((2, 4, 2, 6, 9, 16), seed=5)
    mask = None
    if masked:
        mask = np.random.default_rng(6).random((2, 1, 6, 9)) < 0.7
        mask[..., 0] = True
    mine = mine_cfg.attention(
        *map(torch.from_numpy, (q, k, v)), causal=not masked,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    ref = np.asarray(ref_cfg.attention(
        *map(jnp.asarray, (q, k, v)), causal=not masked,
        mask=None if mask is None else jnp.asarray(mask)))
    tol = 1e-5 if mode == "OFF" else EXP_LSB
    assert np.abs(mine - ref).max() <= tol

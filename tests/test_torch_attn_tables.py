"""Kernel C's tables and the attention kernels' plans, on the CPU.

Kernel C (``csrc/logdomain_flash.cu``) reads every exp from 256-entry
tables that its wrapper builds (``logdomain_tables``).  Here the tables are
held against the plain version's own grid crossings, bit for bit, for every
code, and the algorithm the kernel runs over them — emulated with torch ops
in the plain version's matmul and sum order — against the plain version
itself, bit for bit.  ``plan`` of kernels F and C gives each kernel's
instance, ring depth and shared memory at the shapes the serve paths and
``chip_smoke.py`` launch, Lk = 2048 included.  The kernels themselves run
only on the card (tests/test_torch_gpu.py).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.attention import causal_mask
from repro_torch.core.logdomain import (DEFAULT_CFG, LogDomainConfig,
                                        inv_sqrt, log_quantize,
                                        nldpe_log_softmax)
from repro_torch.core.quantization import QuantSpec
from repro_torch.kernels.dual_compute import ops as ld
from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
from repro_torch.kernels.flash_attention import ops as fa

CODES = torch.arange(256, dtype=torch.int32)
R = DEFAULT_CFG.score_range
SCORE = QuantSpec(lo=-R, hi=0.0)
EXPO = QuantSpec(lo=0.0, hi=1.0)
LOGP = QuantSpec(lo=-2 * R, hi=0.0)


def _tables(cfg=DEFAULT_CFG):
    return ld.logdomain_tables(cfg, "cpu")


def _in_code(spec: QuantSpec, rng, per_code: int) -> torch.Tensor:
    """(256, per_code) float32 values spread over each code's rounding
    interval of ``spec`` (within 0.49 of a step of its value)."""
    centre = spec.dequantize(CODES)[:, None].double()
    frac = torch.tensor(rng.uniform(-0.49, 0.49, (256, per_code)))
    return (centre + frac * spec.step).float()


def test_score_table_is_the_score_grid():
    """T0: each code's value on the score grid, as ``QuantSpec`` dequantizes
    it; quantizing it gives the code back."""
    t0 = _tables()[0]
    assert torch.equal(t0, SCORE.dequantize(CODES))
    assert torch.equal(SCORE.quantize(t0), CODES)


@pytest.mark.parametrize("seed", [0, 1])
def test_exp_table_is_the_plain_exp_acam_output(seed):
    """T1[c] is, bit for bit, what the plain softmax's exp ACAM emits for
    every score that quantizes to c: ``q8(exp(yq))`` on [0, 1]."""
    y = _in_code(SCORE, np.random.default_rng(seed), 16)
    codes = SCORE.quantize(y)
    plain = EXPO.apply(torch.exp(SCORE.apply(y)))
    assert torch.equal(plain, _tables()[1][codes.long()])


@pytest.mark.parametrize("seed", [0, 1])
def test_softmax_table_is_the_plain_log_softmax_exp(seed):
    """T2[c] is, bit for bit, the plain DMMul_2's weight for every
    log-softmax value that quantizes to c: ``exp(q8(.))`` on [-2r, 0]."""
    x = _in_code(LOGP, np.random.default_rng(seed), 16)
    plain = torch.exp(LOGP.apply(x))
    assert torch.equal(plain, _tables()[2][LOGP.quantize(x).long()])


def test_decode_table_is_log_quantize():
    """T3: the DMMul grid's magnitudes; ``log_quantize`` of any value is
    its sign times T3 at its code (0 under the flush threshold)."""
    spec = DEFAULT_CFG.mag_spec
    t3 = _tables()[3]
    assert torch.equal(t3, spec.decode(CODES, torch.ones(256)))
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.choice([-1.0, 1.0], 4096)
                     * np.exp(rng.uniform(math.log(1e-6), math.log(40.0),
                                          4096)), dtype=torch.float32)
    code, sign = spec.encode(x)
    dead = x.abs() < float(np.float32(math.exp(spec.log_lo)))
    want = torch.where(dead, 0.0, sign * t3[code.long()])
    assert torch.equal(log_quantize(x), want)


@pytest.mark.parametrize("lk", [1, 7, 64, 300])
def test_table_weights_are_the_plain_log_softmax_weights(lk):
    """Over every score code at once (a row holds scores on all 256 codes
    of the max-shifted grid), the kernel's per-row table arithmetic — code,
    T1 row sum, log-sum grid, log-softmax code, T2 — gives the plain
    ``nldpe_log_softmax`` + ``nldpe_matmul_loga`` weights bit for bit."""
    rng = np.random.default_rng(lk)
    y = torch.cat([torch.zeros(1), _in_code(SCORE, rng, 2).reshape(-1)])
    y = (y[torch.as_tensor(rng.permutation(y.numel()))][:lk]
         if lk < y.numel() else y)[None]
    y = y + 3.25                                 # any max; shifted back
    logp = nldpe_log_softmax(y, DEFAULT_CFG)
    plain = torch.exp(LOGP.apply(torch.where(torch.isfinite(logp), logp,
                                             -2 * R)))
    tab = _tables()
    score, _, logsum, logp_spec = ld._grid_specs(DEFAULT_CFG, y.shape[-1])
    c1 = score.quantize(y - torch.amax(y, -1, keepdim=True)).long()
    total = torch.sum(tab[1][c1].double(), -1, keepdim=True).float()
    lt = logsum.apply(torch.log(torch.clamp(total, min=1e-9)))
    weights = tab[2][logp_spec.quantize(tab[0][c1] - lt).long()]
    assert torch.equal(weights, plain)


def _table_path(q, k, v, cfg, causal):
    """Kernel C's algorithm with torch ops: the plain version's scores
    and P @ V in its own order, the row sums exact and rounded once (as
    both sum them), every exp read from the tables."""
    f32 = torch.float32
    g = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(g, 1) for t in (k, v))
    ql, kl, vl = ld.log_quantize_qkv(q, k, v, cfg)
    scores = torch.matmul(ql, kl.transpose(-1, -2))
    lq, lk = q.shape[2], k.shape[2]
    mask = (causal_mask(lq, lk) if causal
            else torch.ones(lq, lk, dtype=torch.bool))[None, None]
    y = torch.where(mask, scores, -torch.inf)
    mx = torch.amax(y, -1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    tab = ld.logdomain_tables(cfg, "cpu")
    score, _, logsum, logp = ld._grid_specs(cfg, lk)
    c1 = score.quantize(torch.where(mask, y - mx, -cfg.score_range)).long()
    total = torch.sum(torch.where(mask, tab[1][c1], 0.0).double(), -1,
                      keepdim=True).float()
    lt = logsum.apply(torch.log(torch.clamp(total, min=1e-9)))
    w = torch.where(mask, tab[2][logp.quantize(tab[0][c1] - lt).long()], 0.0)
    return torch.matmul(w, vl.to(f32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 2, 37, 53, 16),
                                   (1, 8, 1, 70, 70, 64),
                                   (1, 2, 1, 9, 4, 16),
                                   (1, 4, 2, 1, 90, 32)],
                         ids=["odd", "g8", "rows_without_keys", "decode"])
def test_table_path_is_the_plain_version_bitwise(shape, causal):
    """Kernel C's table algorithm gives the materialized plain version's
    bits wherever its scores, row sums and P @ V are summed in the plain
    order: the tables change no value."""
    b, hq, hkv, lq, lk, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    ref = logdomain_flash_ref(q, k, v, DEFAULT_CFG, causal)
    assert torch.equal(_table_path(q, k, v, DEFAULT_CFG, causal), ref)


def test_tables_are_built_once_per_grid_and_device():
    """The tables are cached: a second call returns the same tensor; a
    different score range builds its own."""
    assert ld.logdomain_tables(DEFAULT_CFG, "cpu") is _tables()
    other = LogDomainConfig(score_range=6.0)
    assert ld.logdomain_tables(other, "cpu")[0][0].item() == -6.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_log_quantize_qkv_on_cpu_is_log_quantize(dtype):
    """The quantize entry point's plain version: q scaled by 1/sqrt(d),
    each operand upcast and log-quantized."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32).to(dtype)
               for s in ((1, 4, 5, 32), (1, 2, 7, 32), (1, 2, 7, 32)))
    got = ld.log_quantize_qkv(q, k, v)
    want = (log_quantize(q.float() * inv_sqrt(32)), log_quantize(k.float()),
            log_quantize(v.float()))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


# -- plans --------------------------------------------------------------------

# (dtype, d) -> (keys a tile, dynamic shared memory): two stages of a K
# tile (rows of d + 4 floats; bf16 d + 32 halves above d = 32) and a V tile
# (d + 4 floats; bf16 d + 8 halves), then 128 scaled q rows of d + 2 floats
F_PLANS = {(torch.float32, 128): (32, 2 * 32 * (132 + 132) * 4 + 128 * 130 * 4),
           (torch.bfloat16, 128): (64, 2 * 64 * (160 + 136) * 2 + 128 * 130 * 4),
           (torch.float32, 16): (32, 2 * 32 * (20 + 20) * 4 + 128 * 18 * 4),
           (torch.bfloat16, 32): (64, 2 * 64 * (32 + 40) * 2 + 128 * 34 * 4)}


@pytest.mark.parametrize("key", list(F_PLANS), ids=str)
def test_flash_plan_is_the_kernel_layout(key):
    dtype, d = key
    pl = fa.plan(dtype, d)
    keys, smem = F_PLANS[key]
    assert (pl.rows, pl.keys, pl.stages, pl.smem) == (128, keys, 2, smem)
    assert pl.smem <= 227 * 1024


@pytest.mark.parametrize("bad", [(torch.float16, 128), (torch.float32, 48)])
def test_flash_plan_refuses_what_the_kernel_lacks(bad):
    with pytest.raises(ValueError):
        fa.plan(*bad)


RING = 2 * 32 * 132 * 4          # C at d = 128: two stages of 32 K or V rows
TABLES = 3 * 256 * 4


def _c_smem(sp=None):
    """Kernel C's shared memory at d = 128: the resident instance's with
    a score pitch of ``sp``, else the two-pass instance's."""
    rows = 64
    scores = 0 if sp is None else rows * sp * 4
    return RING + TABLES + rows * 4 + rows * 132 * 4 + scores


# lk -> (instance, smem) at d = 128: the lockstep FUSED prefill (256), the
# OFF shape (512), the largest resident (608), the first two-pass (640),
# Lk = 2048, and longer lengths (two-pass keeps its codes in the device
# scratch, so its shared memory does not grow)
C_PLANS = {256: ("resident", _c_smem(264)),
           512: ("resident", _c_smem(520)),
           608: ("resident", _c_smem(616)),
           640: ("two_pass", _c_smem()),
           2048: ("two_pass", _c_smem()),
           2496: ("two_pass", _c_smem()),
           3100: ("two_pass", _c_smem()),
           6100: ("two_pass", _c_smem())}


@pytest.mark.parametrize("lk", list(C_PLANS))
def test_logdomain_plan_is_the_kernel_layout(lk):
    pl = ld.logdomain_plan(lk, 128)
    instance, smem = C_PLANS[lk]
    assert (pl.instance, pl.rows, pl.keys, pl.stages, pl.smem) \
        == (instance, 64, 32, 2, smem)
    assert pl.smem <= 227 * 1024


def test_logdomain_plan_takes_any_length():
    """The two-pass instance keeps its codes in the device scratch, so it
    takes any length: one byte per (row, key) of every block's 64 rows,
    keys padded to the pitch; the resident instance needs none."""
    for lk in (2497, 11712, 131072):
        pl = ld.logdomain_plan(lk, 128)
        assert pl.instance == "two_pass"
        assert pl.smem == _c_smem()
    pl = ld.logdomain_plan(11712, 128)
    # 2 sequences x 2 KV heads x ceil(8 * 37 / 64) = 5 row tiles
    assert ld.logdomain_scratch_bytes(pl, 2, 16, 2, 37, 11712) == \
        2 * 2 * 5 * 64 * (11712 + 8)
    assert ld.logdomain_scratch_bytes(ld.logdomain_plan(512, 128),
                                      2, 16, 2, 37, 512) == 0


@pytest.mark.parametrize("instance, d", [("resident", 128), ("bogus", 128),
                                         ("two_pass", 48)],
                         ids=["resident", "bogus", "head_dim48"])
def test_logdomain_plan_refuses_an_instance_that_does_not_fit(instance, d):
    """An instance asked for must exist and fit: at 4096 keys the
    resident scores do not, the two-pass instance does (but at no head
    dim the kernel lacks)."""
    assert ld.logdomain_plan(4096, 128, "two_pass").smem == _c_smem()
    with pytest.raises(ValueError):
        ld.logdomain_plan(4096, d, instance)


def test_rows_aligned_reads_views_in_place():
    """A view whose rows start 16-byte aligned passes through; one that
    does not is copied (contiguous, same dtype, same values)."""
    x = torch.zeros(2, 40, 8, 64)
    t = x.transpose(1, 2)
    assert fa.rows_aligned(t) is t
    odd = x.reshape(-1)[1:1 + 2 * 8 * 40 * 63].reshape(2, 8, 40, 63)
    y = fa.rows_aligned(odd)
    assert y is not odd and y.is_contiguous() and torch.equal(y, odd)
    assert list(fa.strides(t)) == list(t.stride()[:3])

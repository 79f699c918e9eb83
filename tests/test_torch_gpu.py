"""Kernel-vs-plain checks of the port's CUDA kernels, run on the card.

Marked ``gpu``: they skip where CUDA is absent (decided inside the
fixture, never at import).  On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.acam import get_table, table_thresholds
from repro_torch.kernels.dual_compute.ops import (fused_crossbar_acam,
                                                  fused_linear_acam, program)
from repro_torch.kernels.dual_compute.ref import fused_crossbar_acam_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(rng, b, hq, hkv, p, nb, ps, d, q_len, dtype, dev):
    q = torch.tensor(rng.normal(size=(b, hq, q_len, d)), dtype=torch.float32)
    kp = torch.tensor(rng.normal(size=(p, hkv, ps, d)), dtype=torch.float32)
    vp = torch.tensor(rng.normal(size=(p, hkv, ps, d)), dtype=torch.float32)
    bt = torch.tensor(rng.permutation(p)[:b * nb].reshape(b, nb),
                      dtype=torch.int32)
    bt[0, nb // 2] = p          # sentinel mid-table
    bt[-1, -1] = -1             # negative sentinel
    lengths = torch.tensor(rng.integers(1, nb * ps - q_len + 2, b),
                           dtype=torch.int32)
    return [t.to(dev) for t in (q, kp.to(dtype), vp.to(dtype), bt, lengths)]


@pytest.mark.parametrize("q_len", [1, 2, 3, 5, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 2, 48, 20, 5, 16),
                                   (8, 16, 2, 512, 64, 16, 128),
                                   (8, 40, 8, 512, 64, 16, 128)],
                         ids=["small", "qwen3b", "llama4scout"])
def test_paged_attention_kernel_matches_plain(dev, shape, dtype, q_len):
    """Tolerance 1e-4 absolute: the same f32 math summed in another order
    (FMA dot products, online softmax across pages)."""
    rng = np.random.default_rng(0)
    args = _paged_case(rng, *shape, q_len, dtype, dev)
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_ref(*args)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


def test_paged_attention_sentinel_page_is_never_read(dev):
    """Poisoning a page that only a sentinel entry would alias changes
    nothing (mirror of tests/test_kernel_conformance.py's poison test)."""
    rng = np.random.default_rng(7)
    b, hq, hkv, p, nb, ps, d = 2, 4, 2, 6, 3, 5, 16
    q = torch.tensor(rng.normal(size=(b, hq, 1, d)), dtype=torch.float32)
    kp = torch.tensor(rng.normal(size=(p, hkv, ps, d)), dtype=torch.float32)
    vp = torch.tensor(rng.normal(size=(p, hkv, ps, d)), dtype=torch.float32)
    bt = torch.tensor([[3, 4, 5], [0, 1, p]], dtype=torch.int32)
    over = torch.tensor([nb * ps, nb * ps], dtype=torch.int32)
    q, kp, vp, bt, over = (t.to(dev) for t in (q, kp, vp, bt, over))
    o = paged_attention(q, kp, vp, bt, over)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[p - 1] += 100.0
    vp2[p - 1] += 100.0
    o2 = paged_attention(q, kp2, vp2, bt, over)
    assert torch.equal(o[1], o2[1])
    assert not torch.allclose(o[0], o2[0])


def test_paged_attention_fully_masked_row_is_zero(dev):
    q = torch.ones((1, 2, 1, 16), device=dev)
    kp = torch.ones((2, 1, 4, 16), device=dev)
    bt = torch.tensor([[2, 2]], dtype=torch.int32, device=dev)  # unmapped
    out = paged_attention(q, kp, kp, bt,
                          torch.tensor([3], dtype=torch.int32, device=dev))
    assert torch.equal(out, torch.zeros_like(out))


def _code_pools(args, mode):
    """The case's f32 pools put on ``mode``'s grid: codes + scales."""
    from repro_torch.nn.attention import _quantize_kv
    q, kp, vp, bt, lengths = args
    kc, ks = _quantize_kv(kp, mode)
    vc, vs = _quantize_kv(vp, mode)
    return (q, kc, vc, bt, lengths), dict(k_scale=ks, v_scale=vs,
                                          kv_quant=mode)


@pytest.mark.parametrize("q_len", [1, 2, 3, 5, 64])
@pytest.mark.parametrize("mode", ["int8", "log8"])
@pytest.mark.parametrize("shape", [(2, 4, 2, 48, 20, 5, 16),
                                   (8, 16, 2, 512, 64, 16, 128)],
                         ids=["small", "qwen3b"])
def test_paged_attention_code_pools_match_plain(dev, shape, mode, q_len):
    """int8 code pools (odd page size 5, sentinels mid-table and at the
    end): the kernel decodes through the table the plain version's formula
    built, so only the sum order differs — tolerance 1e-4 as for fp pools.
    Each launch is counted under its grid."""
    from repro_torch.core.quantization import kv_decode
    rng = np.random.default_rng(0)
    args, kw = _code_pools(_paged_case(rng, *shape, q_len, torch.float32,
                                       dev), mode)
    before = dict(paged_attention.pool_launches)
    out = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.pool_launches[mode] == before[mode] + 1
    ref = paged_attention_ref(*args, **kw)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4
    # an f32 pool holding the decoded values gives the same bits: the code
    # variant stages exactly those floats and shares every other step
    fp = (args[0], kv_decode(args[1], kw["k_scale"], mode),
          kv_decode(args[2], kw["v_scale"], mode), *args[3:])
    assert torch.equal(paged_attention(*fp), out)


@pytest.mark.parametrize("mode", ["int8", "log8"])
def test_kv_table_on_card_is_the_plain_decode(dev, mode):
    """The cached decode table, built on the card, indexed by every code
    and scaled: bit for bit ``kv_decode`` on the card."""
    from repro_torch.core.quantization import kv_decode, kv_table
    tab = kv_table(mode, dev)
    assert kv_table(mode, "cuda") is tab and tab.device.type == "cuda"
    codes = torch.arange(-128, 128, dtype=torch.int32, device=dev).to(
        torch.int8).repeat(40, 1)
    scale = torch.rand(40, device=dev) * 3 + 1e-3
    assert torch.equal(tab[codes.long() + 128] * scale[:, None],
                       kv_decode(codes, scale, mode))


def test_paged_attention_code_pools_sentinel_is_never_read(dev):
    """A page only a sentinel entry would alias, codes and scale row
    poisoned (NaN scales): the mapped rows' outputs do not move."""
    from repro_torch.nn.attention import _quantize_kv
    rng = np.random.default_rng(8)
    b, hq, hkv, p, nb, ps, d = 2, 4, 2, 6, 3, 5, 16
    q = torch.tensor(rng.normal(size=(b, hq, 1, d)), dtype=torch.float32,
                     device=dev)
    kc, ks = _quantize_kv(torch.tensor(rng.normal(size=(p, hkv, ps, d)),
                                       dtype=torch.float32, device=dev),
                          "log8")
    bt = torch.tensor([[3, 4, 5], [0, 1, p]], dtype=torch.int32, device=dev)
    over = torch.tensor([nb * ps, nb * ps], dtype=torch.int32, device=dev)
    o = paged_attention(q, kc, kc, bt, over, k_scale=ks, v_scale=ks,
                        kv_quant="log8")
    ks2 = ks.clone()
    ks2[p - 1] = float("nan")
    o2 = paged_attention(q, kc, kc, bt, over, k_scale=ks2, v_scale=ks2,
                         kv_quant="log8")
    assert torch.equal(o[1], o2[1])
    assert not torch.allclose(o[0], o2[0])


def test_paged_attention_fp_pools_unchanged_by_code_variant(dev):
    """f32 and bf16 pools give the same bits before and after code-pool
    launches, and no code path is taken for them."""
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.bfloat16):
        args = _paged_case(rng, 8, 16, 2, 512, 64, 16, 128, 1, dtype, dev)
        first = paged_attention(*args)
        codes, kw = _code_pools([a.float() if a.is_floating_point() else a
                                 for a in args], "log8")
        paged_attention(*codes, **kw)
        before = dict(paged_attention.pool_launches)
        assert torch.equal(paged_attention(*args), first)
        kind = str(dtype).split(".")[-1]
        assert paged_attention.pool_launches[kind] == before[kind] + 1


def _boundary_lengths(q_len, ps, span):
    """Base lengths whose last attended position (length + Q - 1) lands
    on, and one either side of, a page (ps), a decode warp step (8), a
    decode block step (32), a chunk stage (64) and the table's end."""
    out = set()
    for mark in (ps, 2 * ps, 3 * ps, 8, 32, 64, 128, span):
        for delta in (-1, 0, 1):
            out.add(min(max(mark + delta - q_len + 1, 1), span - q_len + 1))
    return sorted(out)


@pytest.mark.parametrize("route", ["unsplit", "split"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "log8"])
@pytest.mark.parametrize("ps", [5, 16, 32])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("q_len", [1, 5, 9, 64, 65])
def test_paged_attention_tile_boundaries(dev, monkeypatch, q_len, g, ps,
                                         pool, route):
    """Every tile boundary of both instances: G*Q from 1 to 520 (decode
    rows 8 and 16; chunk tiles of 64 and 128 rows, ragged last tiles),
    page sizes that do and do not divide a stage, lengths on and beside
    page, warp-step, block-step and stage boundaries, sentinels mid-table
    and at the end, with the position axis unsplit and split in 3 (chunk:
    short sequences leave splits idle).  Within 1e-4 of the plain version;
    a code pool gives the bits of an f32 pool holding its decoded
    values."""
    from repro_torch.core.quantization import kv_decode
    from repro_torch.kernels.paged_attention import ops
    monkeypatch.setattr(ops, "num_splits",
                        lambda units, steps: 1 if route == "unsplit" else 3)
    d = 128 if g == 8 else 64
    nb = -(-160 // ps)
    lengths = _boundary_lengths(q_len, ps, nb * ps)
    b = len(lengths)
    rng = np.random.default_rng(q_len * 7 + ps)
    q = torch.tensor(rng.normal(size=(b, 2 * g, q_len, d)),
                     dtype=torch.float32, device=dev)
    kf, vf = (torch.tensor(rng.normal(size=(b * nb + 2, 2, ps, d)),
                           dtype=torch.float32, device=dev)
              for _ in range(2))
    bt = torch.tensor(rng.permutation(b * nb + 2)[:b * nb].reshape(b, nb),
                      dtype=torch.int32, device=dev)
    bt[0, nb // 2] = b * nb + 2     # sentinel mid-table
    bt[-1, -1] = -1                 # negative sentinel at the end
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = {}
    if pool in ("int8", "log8"):
        from repro_torch.nn.attention import _quantize_kv
        (kp, ks), (vp, vs) = _quantize_kv(kf, pool), _quantize_kv(vf, pool)
        kw = dict(k_scale=ks, v_scale=vs, kv_quant=pool)
    else:
        kp, vp = kf.to(getattr(torch, pool)), vf.to(getattr(torch, pool))
    out = paged_attention(q, kp, vp, bt, lengths, **kw)
    ref = paged_attention_ref(q, kp, vp, bt, lengths, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4
    if kw:
        fp = paged_attention(q, kv_decode(kp, ks, pool),
                             kv_decode(vp, vs, pool), bt, lengths)
        assert torch.equal(fp, out)


def test_paged_attention_plan_matches_the_kernel_layout(dev):
    """The wrapper's shared-memory formula is the CUDA source's, byte for
    byte, for every instance, head dim and pool kind."""
    from repro_torch.kernels.paged_attention import ops
    lib = ops._lib()
    for rows in (8, 16, 64, 128):
        for d in (16, 32, 64, 128):
            for kind in (0, 1, 2):
                assert lib.paged_attention_smem_bytes(rows, d, kind) == \
                    ops.smem_bytes(rows, d, kind)


@pytest.mark.parametrize("mode", ["int8", "log8"])
def test_quantized_engine_on_card_matches_cpu_plain_path(dev, mode):
    """The reduced model with ``kv_quant`` on the card (kernel A's code
    variant on every attention call) and on the CPU (plain versions):
    the same greedy tokens, f32 activations."""
    import dataclasses

    from repro_torch.launch.engine import PagedServeEngine, Request
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(3)
    shared = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 8))
    reqs = [Request(rid=i, tokens=shared + tuple(
        int(t) for t in rng.integers(0, cfg.vocab_size, 1 + i)),
        max_new_tokens=6, arrival=i) for i in range(5)]
    out = {}
    for where in ("cpu", "cuda"):
        eng = PagedServeEngine(cfg, from_jax(_np(params), device=where),
                               max_slots=3, max_len=32, page_size=4,
                               prefill_chunk=4, decode_block=2,
                               kv_quant=mode, device=where)
        before = paged_attention.pool_launches[mode]
        out[where] = {c.rid: c.tokens for c in eng.run(reqs)}
        launched = paged_attention.pool_launches[mode] - before
        assert (launched > 0) == (where == "cuda")
    assert out["cpu"] == out["cuda"]


# Every tile variant of the crossbar family (csrc/xbar_tiles.cuh) and its
# ragged edges: small (M <= 16), mid, large (M >= 128); N = 11001 and
# K = 2047 are multiples of no tile width and unaligned to 16 bytes (the
# scalar copy path).
XBAR_RAGGED = [(1, 2048, 11008), (3, 2047, 11001), (16, 2048, 11001),
               (17, 2047, 11008), (130, 2047, 11001)]


@pytest.mark.parametrize("m,k,n", [(8, 2048, 11008), (512, 2048, 11008),
                                   (37, 100, 130), (4, 2048, 11008),
                                   (1024, 2048, 11008)] + XBAR_RAGGED)
def test_fused_crossbar_acam_kernel_matches_plain(dev, m, k, n):
    """ACAM codes may differ by one where the f32 sum order moves the
    pre-activation across an interval edge: at most one code step, on at
    most 1e-4 of the outputs (chip_smoke.py measured 0 at M=8 and 7.6e-6
    at M=512 on an H100)."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.normal(size=(k, n)) * k ** -0.5,
                     dtype=torch.float32, device=dev)
    table = get_table("silu", 8)
    cells, inv = program(w)
    lo, hi = table_thresholds(table, dev)
    kw = dict(out_lo=float(table.out_spec.lo),
              out_step=float(table.out_spec.step))
    out = fused_crossbar_acam(x, *cells, inv, lo, hi, **kw)
    ref = fused_crossbar_acam_ref(x, *cells, inv, lo, hi, **kw)
    diff = (out - ref).abs()
    step = float(table.out_spec.step)
    assert diff.max().item() <= step * 1.0001
    assert (diff > 0).float().mean().item() <= 1e-4
    lin = fused_linear_acam(x, w, "silu")
    assert torch.equal(lin, out)


def test_engine_on_card_matches_cpu_plain_path(dev):
    """The reduced model served on the card (kernel A) and on the CPU
    (plain versions) gives the same greedy tokens, f32 activations."""
    import dataclasses

    from repro_torch.launch.engine import PagedServeEngine, Request
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, generator=gen, device="cpu")
    rng = np.random.default_rng(3)
    shared = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 8))
    reqs = [Request(rid=i, tokens=shared + tuple(
        int(t) for t in rng.integers(0, cfg.vocab_size, 1 + i)),
        max_new_tokens=6, arrival=i) for i in range(5)]
    out = {}
    for where in ("cpu", "cuda"):
        eng = PagedServeEngine(cfg, from_jax(_np(params), device=where),
                               max_slots=3, max_len=32, page_size=4,
                               prefill_chunk=4, decode_block=2, device=where)
        out[where] = {c.rid: c.tokens for c in eng.run(reqs)}
    assert out["cpu"] == out["cuda"]


@pytest.mark.parametrize("spec_k,full_analog", [(1, False), (4, False),
                                                (2, True)])
def test_spec_engine_on_card_matches_cpu_plain_path(dev, spec_k,
                                                    full_analog):
    """The speculative paged engine on the card (kernel A at the verify's
    q_len = spec_k + 1 and the weights-only drafter's decode steps, or the
    ``ON`` drafter) and on the CPU (plain versions), f32 activations:
    the same greedy tokens, up to one near-tie (where two diverge, the CPU
    model's top-2 logit margin there is below 1e-3, ten times the 1e-4
    card-vs-CPU logit tolerance of ``chip_smoke.py``); every page
    returns to the pool."""
    import dataclasses

    from repro_torch.core.engine import NLDPEConfig
    from repro_torch.launch.engine import PagedServeEngine, Request
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(4),
                            device="cpu")
    rng = np.random.default_rng(5)
    shared = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 8))
    reqs = [Request(rid=i, tokens=shared + tuple(
        int(t) for t in rng.integers(0, cfg.vocab_size, 1 + i)),
        max_new_tokens=8, arrival=i) for i in range(5)]
    out, stats = {}, {}
    for where in ("cpu", "cuda"):
        eng = PagedServeEngine(cfg, from_jax(_np(params), device=where),
                               max_slots=3, max_len=32, page_size=4,
                               prefill_chunk=4, decode_block=2,
                               spec_k=spec_k,
                               spec_draft=NLDPEConfig(enabled=full_analog),
                               device=where)
        out[where] = {c.rid: c.tokens for c in eng.run(reqs)}
        stats[where] = eng.spec_stats
        eng.pool.check()
        assert eng.pool.available() == eng.pool.num_pages
    assert stats["cuda"]["drafted"] > 0
    ties = 0
    for r in reqs:
        a, b = out["cpu"][r.rid], out["cuda"][r.rid]
        if a == b:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = lm.forward(lm.serving_params(params, cfg), torch.tensor(
            [r.tokens + tuple(a[:i])], dtype=torch.int32), cfg,
            mode="prefill")[0, -1]
        top = torch.topk(logits, 2).values
        assert (top[0] - top[1]).item() < 1e-3, (r.rid, a, b)
        ties += 1
    assert ties <= 1


def test_slotted_engine_on_card_matches_cpu_plain_path(dev):
    """The slotted ``ServeEngine`` (dense cache rows, plain attention on
    both devices) on the card and on the CPU, mixed greedy and sampled
    requests, f32 activations: the same tokens."""
    import dataclasses

    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(2),
                            device="cpu")
    rng = np.random.default_rng(6)
    reqs = [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, 3 + 2 * i)), max_new_tokens=6,
        temperature=0.8 * (i % 2), top_k=3 * (i % 3), arrival=i)
        for i in range(5)]
    out = {}
    for where in ("cpu", "cuda"):
        eng = ServeEngine(cfg, from_jax(_np(params), device=where),
                          max_slots=3, max_len=32, prefill_chunk=4,
                          decode_block=2, device=where)
        out[where] = {c.rid: c.tokens for c in eng.run(reqs)}
    assert out["cpu"] == out["cuda"]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def _attn_case(rng, b, hq, hkv, lq, lk, d, dtype, dev):
    q, k, v = (torch.tensor(rng.normal(size=shape), dtype=torch.float32)
               for shape in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    return [t.to(dtype).to(dev) for t in (q, k, v)]


ATTN_CASES = [(2, 4, 2, 37, 53, 16), (1, 8, 1, 70, 70, 64),
              (8, 16, 2, 512, 512, 128), (1, 16, 2, 2048, 2048, 128),
              (1, 40, 8, 517, 517, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_CASES,
                         ids=["odd", "g8", "qwen3b", "long2048",
                              "llama4scout"])
def test_flash_attention_kernel_matches_plain(dev, shape, dtype, causal):
    """Kernel F against its plain version on the same inputs (bf16 read as
    bf16, the plain version upcasting): 1e-4 absolute — the same f32 math
    in split-TF32 products, summed in another order."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _attn_case(np.random.default_rng(2), *shape, dtype, dev)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.dtype == dtype
    ref = flash_attention_ref(q, k, v, causal)
    assert torch.isfinite(out).all()
    # bf16 outputs: plus one bf16 rounding step (2^-7 relative)
    tol = 1e-4 + (0.0 if dtype == torch.float32 else 2.0 ** -7) * ref.abs()
    assert bool(((out.float() - ref).abs() <= tol).all())


def test_flash_attention_rows_without_keys_are_zero(dev):
    """Lq > Lk: the first Lq - Lk causal rows see no key and give 0."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _attn_case(np.random.default_rng(3), 1, 2, 1, 9, 4, 16,
                         torch.float32, dev)
    out = flash_attention(q, k, v)
    assert torch.equal(out[:, :, :5], torch.zeros_like(out[:, :, :5]))
    assert (out - flash_attention_ref(q, k, v)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_strided_operands(dev, dtype):
    """q, k, v as transposed views of (B, L, H, D) projections (the head
    dim contiguous): the kernel reads them in place, and gives what it
    gives on contiguous copies, bit for bit."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    rng = np.random.default_rng(6)
    q, k, v = (torch.tensor(rng.normal(size=(2, n, h, 64)),
                            dtype=torch.float32).to(dtype).to(dev)
               .transpose(1, 2) for n, h in ((40, 8), (45, 2), (45, 2)))
    assert not q.is_contiguous()
    out = flash_attention(q, k, v)
    assert torch.equal(out, flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous()))


def test_flash_attention_plan_matches_the_kernel_layout(dev):
    """The wrapper's shared-memory formula is the CUDA source's, byte for
    byte, for both operand dtypes and every head dim."""
    from repro_torch.kernels.flash_attention import ops
    for d in ops.HEAD_DIMS:
        for dtype, esz in ((torch.float32, 4), (torch.bfloat16, 2)):
            assert ops._lib().flash_attention_smem_bytes(esz, d) == \
                ops.plan(dtype, d).smem


@pytest.mark.parametrize("shape", ATTN_CASES[:2] + [
    (4, 16, 2, 256, 256, 128), (1, 16, 2, 2048, 2048, 128)],
                         ids=["odd", "g8", "qwen3b", "long2048"])
def test_logdomain_flash_kernel_matches_plain(dev, shape):
    """Kernel C against the materialized NL-DPE attention on the card:
    within one exp-grid LSB, 1/255 (``repro``'s own tolerance between its
    kernel and the oracle; row sums in another order can move a log-grid
    code).  At 2048 keys it runs the two-pass instance."""
    from repro_torch.kernels.dual_compute.ops import logdomain_flash_attention
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    q, k, v = _attn_case(np.random.default_rng(4), *shape, torch.float32,
                         dev)
    before = logdomain_flash_attention.launches
    out = logdomain_flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert logdomain_flash_attention.launches == before + 1
    ref = logdomain_flash_ref(q, k, v)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1.0 / 255


@pytest.mark.parametrize("lk", [40, 700, 3100, 12288],
                         ids=["resident", "two_pass700", "two_pass3100",
                              "two_pass12288"])
@pytest.mark.parametrize("causal", [True, False])
def test_logdomain_flash_instances_match_plain(dev, lk, causal):
    """Each instance of kernel C the plan picks (resident; two-pass, its
    codes in the device scratch, up to 12288 keys, past what a row tile's
    codes in shared memory could hold) against the plain version, 37
    queries at the end of the key axis, within 1/255."""
    from repro_torch.kernels.dual_compute.ops import (
        logdomain_flash_attention, logdomain_plan)
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    assert logdomain_plan(lk, 128).instance == (
        "resident" if lk == 40 else "two_pass")
    q, k, v = _attn_case(np.random.default_rng(7), 1, 4, 2, 37, lk, 128,
                         torch.float32, dev)
    out = logdomain_flash_attention(q, k, v, causal=causal)
    ref = logdomain_flash_ref(q, k, v, causal=causal)
    assert (out - ref).abs().max().item() <= 1.0 / 255


def test_logdomain_flash_every_instance_at_one_shape(dev):
    """Both instances asked for at one shape that each fits (odd lengths,
    GQA 4): each within 1/255 of the plain version."""
    from repro_torch.kernels.dual_compute import ops
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    q, k, v = _attn_case(np.random.default_rng(9), 2, 8, 2, 45, 300, 64,
                         torch.float32, dev)
    quantized = ops.log_quantize_qkv(q, k, v)
    ref = logdomain_flash_ref(q, k, v)
    outs = {name: ops.logdomain_kernel(
        *quantized, torch.float32, plan=ops.logdomain_plan(300, 64, name))
        for name in ops.LD_INSTANCES}
    for out in outs.values():
        assert (out - ref).abs().max().item() <= 1.0 / 255


def test_logdomain_kernel_counts_its_launch(dev):
    """A direct call of the attention launch counts one launch of kernel
    C, as the full wrapper's call does (the quantize launch counts its
    own)."""
    from repro_torch.kernels.dual_compute import ops
    q, k, v = _attn_case(np.random.default_rng(10), 1, 4, 2, 20, 20, 32,
                         torch.float32, dev)
    quantized = ops.log_quantize_qkv(q, k, v)
    before = ops.logdomain_flash_attention.launches
    ops.logdomain_kernel(*quantized, torch.float32)
    assert ops.logdomain_flash_attention.launches == before + 1
    quant_before = ops.log_quantize_qkv.launches
    ops.logdomain_flash_attention(q, k, v)
    assert ops.logdomain_flash_attention.launches == before + 2
    assert ops.log_quantize_qkv.launches == quant_before + 1


def test_logdomain_flash_plan_matches_the_kernel_layout(dev):
    """The wrapper's shared-memory and scratch formulas are the CUDA
    source's, byte for byte, for every head dim and instance."""
    from repro_torch.kernels.dual_compute import ops
    lib = ops._ld_lib()
    for d in (16, 32, 64, 128):
        for lk in (1, 256, 512, 608, 640, 2048, 3100, 6100, 11000, 40000):
            for i, name in enumerate(ops.LD_INSTANCES):
                try:
                    pl = ops.logdomain_plan(lk, d, name)
                except ValueError:
                    continue
                assert lib.logdomain_flash_smem_bytes(i, d, lk) == pl.smem
            pl = ops.logdomain_plan(lk, d, "two_pass")
            for shape in ((1, 16, 2, 37, lk), (3, 8, 8, 100, lk)):
                assert lib.logdomain_flash_scratch_bytes(*shape) == \
                    ops.logdomain_scratch_bytes(pl, *shape)


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3, (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.float16)],
                         ids=["f16", "bf16_q", "mixed"])
def test_attention_kernels_take_other_dtypes_upcast(dev, dtypes):
    """float16 or mixed operands: kernels F and C launch their float32
    instances on upcast copies, and give their plain versions' results (F
    within 1e-4, C within 1/255, plus one output step of q's dtype), in q's
    dtype; the quantize launch is ``log_quantize`` of the upcasts bit for
    bit."""
    from repro_torch.core.logdomain import inv_sqrt, log_quantize
    from repro_torch.kernels.dual_compute.ops import (
        log_quantize_qkv, logdomain_flash_attention)
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = (t.to(dt) for t, dt in zip(_attn_case(
        np.random.default_rng(11), 2, 8, 2, 40, 60, 64, torch.float32, dev),
        dtypes))
    step = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}[q.dtype]
    f32 = [t.float() for t in (q, k, v)]
    for fn, ref_fn, tol in ((flash_attention, flash_attention_ref, 1e-4),
                            (logdomain_flash_attention, logdomain_flash_ref,
                             1.0 / 255)):
        before = fn.launches
        out = fn(q, k, v)
        assert fn.launches == before + 1 and out.dtype == q.dtype
        ref = ref_fn(*f32)
        assert bool(((out.float() - ref).abs()
                     <= tol + step * ref.abs()).all())
    got = log_quantize_qkv(q, k, v)
    want = (log_quantize(f32[0] * inv_sqrt(64)), log_quantize(f32[1]),
            log_quantize(f32[2]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
def test_log_quantize_launch_is_log_quantize_bitwise(dev, dtype, strided):
    """Kernel C's quantize launch gives ``log_quantize``'s values on the
    card bit for bit: q scaled by 1/sqrt(d) first, bf16 upcast first, the
    flush threshold, the log floor and both rounding edges included (inputs
    spread over the whole grid and beyond it, exact zeros, tiny values);
    strided views read in place."""
    from repro_torch.core.logdomain import inv_sqrt, log_quantize
    from repro_torch.kernels.dual_compute.ops import log_quantize_qkv
    rng = np.random.default_rng(8)

    def operand(b, h, n, d):
        x = np.exp(rng.uniform(np.log(1e-6), np.log(40.0), (b, n, h, d)))
        x *= rng.choice([-1.0, 1.0], x.shape)
        x[..., 0] = 0.0
        t = torch.tensor(x, dtype=torch.float32).to(dtype).to(dev)
        t = t.transpose(1, 2)
        return t if strided else t.contiguous()

    q, k, v = operand(2, 8, 33, 128), operand(2, 2, 50, 128), \
        operand(2, 2, 50, 128)
    before = log_quantize_qkv.launches
    got = log_quantize_qkv(q, k, v)
    assert log_quantize_qkv.launches == before + 1
    want = (log_quantize(q.float() * inv_sqrt(128)), log_quantize(k.float()),
            log_quantize(v.float()))
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.float32
        assert torch.equal(g, w)


def test_logdomain_flash_kernel_bf16_matches_plain(dev):
    """Kernel C with the bf16 activations of the lockstep FUSED prefill,
    at its shape: q, k and v are upcast before they are log-quantized, on
    the card as in the plain version; one exp-grid LSB plus one bf16 step
    (2^-7 relative) where the same f32 result rounds apart."""
    from repro_torch.kernels.dual_compute.ops import logdomain_flash_attention
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    q, k, v = _attn_case(np.random.default_rng(5), 4, 16, 2, 256, 256, 128,
                         torch.bfloat16, dev)
    out = logdomain_flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = logdomain_flash_ref(q, k, v)
    tol = 1.0 / 255 + 2.0 ** -7 * ref.abs()
    assert bool(((out.float() - ref).abs() <= tol).all())


@pytest.mark.parametrize("fused", [False, True], ids=["OFF", "FUSED"])
def test_lockstep_on_card_matches_cpu_plain_path(dev, fused):
    """The reduced model's lockstep prefill (kernel F, or kernels C and B)
    and greedy generation on the card against the CPU plain path, f32
    activations: equal tokens; last prefill logits within 1e-4 OFF and
    1e-2 FUSED (a log-grid code may move between the kernel and the
    materialized plain version)."""
    import dataclasses

    from repro_torch.core.engine import FUSED, OFF
    from repro_torch.launch.serve import build_generate_fn, build_prefill_step
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    nldpe = FUSED if fused else OFF
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    prompts = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 21)), dtype=torch.int32)
    out = {}
    for where in ("cpu", "cuda"):
        p = lm.serving_params(from_jax(_np(params), device=where), cfg, nldpe)
        cache = lm.init_model_cache(cfg, 3, 32, device=where)
        last, cache = build_prefill_step(cfg, nldpe=nldpe)(
            p, cache, prompts.to(where))
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        gen, _ = build_generate_fn(cfg, 8, nldpe=nldpe)(p, cache, tok, 21)
        out[where] = (last.cpu(), gen.cpu())
    tol = 1e-2 if fused else 1e-4
    assert (out["cpu"][0] - out["cuda"][0]).abs().max().item() <= tol
    assert torch.equal(out["cpu"][1], out["cuda"][1])


# -- the NL-DPE kernel library: D, E and G --------------------------------

U32 = 2.0 ** -24


def _within_sum_order(out, ref, a, b, slack_u=8):
    """|out - ref| <= (2 K + slack_u) u (|A| @ |B|) per output: two
    float32 GEMMs that differ only by their sum order (2 K u, the worst
    case of two length-K dot products), with ``slack_u`` u per product for
    operands a few ulps apart."""
    k = a.shape[-1]
    tol = (a.abs() @ b.abs()) * ((2 * k + slack_u) * U32)
    return bool(((out - ref).abs() <= tol).all())


@pytest.mark.parametrize("name", ["silu", "gelu", "exp", "log"])
@pytest.mark.parametrize("shape,dtype", [((8, 11008), torch.float32),
                                         ((3, 1000, 7), torch.float32),
                                         ((1, 1), torch.float32),
                                         ((77, 129), torch.bfloat16)])
def test_acam_activation_kernel_matches_plain(dev, name, shape, dtype):
    """Kernel D against its plain version: bitwise (the same compares and
    the same two float32 roundings), ragged sizes and a bf16 input."""
    from repro_torch.kernels.acam_activation.ops import acam_apply
    from repro_torch.kernels.acam_activation.ref import acam_activation_ref
    table = get_table(name, 8)
    lo, hi = table_thresholds(table, dev)
    x = (torch.tensor(np.random.default_rng(0).normal(size=shape) * 4,
                      dtype=torch.float32).to(dtype).to(dev))
    before = acam_apply.launches
    out = acam_apply(x, table)
    torch.cuda.synchronize()
    assert acam_apply.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == x.shape
    ref = acam_activation_ref(x, lo, hi, float(table.out_spec.lo),
                              float(table.out_spec.step))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("name", ["silu", "gelu", "exp", "log"])
def test_acam_activation_noisy_thresholds_match_plain(dev, name):
    """Kernel D with caller-given thresholds moved by a seeded normal
    (compiled on the device per call) against its plain version on the
    same thresholds: bitwise."""
    from repro_torch.kernels.acam_activation.ops import acam_apply
    from repro_torch.kernels.acam_activation.ref import acam_activation_ref
    table = get_table(name, 8)
    rng = np.random.default_rng(8)
    lo, hi = (torch.tensor(t + rng.normal(0, 0.01, t.shape),
                           dtype=torch.float32, device=dev)
              for t in (table.lo, table.hi))
    x = torch.tensor(rng.normal(size=(512, 1001)) * 4, dtype=torch.float32,
                     device=dev)
    out = acam_apply(x, table, lo, hi)
    ref = acam_activation_ref(x, lo, hi, float(table.out_spec.lo),
                              float(table.out_spec.step))
    assert torch.equal(out, ref)
    assert not torch.equal(out, acam_apply(x, table))


def _noisy_plan(dev, k, n, seed=0):
    from repro_torch.core.crossbar import program_linear
    from repro_torch.launch import prng
    w = torch.tensor(np.random.default_rng(seed).normal(size=(k, n))
                     * k ** -0.5, dtype=torch.float32, device=dev)
    plan, _ = program_linear(w, rng=prng.prng_key(seed + 1))
    return plan


@pytest.mark.parametrize("m,k,n", [(8, 2048, 11008), (512, 2048, 11008),
                                   (37, 100, 130), (1, 17, 5)]
                         + XBAR_RAGGED)
def test_crossbar_vmm_kernel_matches_plain(dev, m, k, n):
    """Kernel E against its plain version on read-noise cells: within the
    float32 sum-order bound (2 K + 8) u (|x| @ |W_eff|)."""
    from repro_torch.kernels.crossbar_vmm.ops import (crossbar_matmul,
                                                      crossbar_vmm,
                                                      inv_g_ratio,
                                                      read_cells)
    from repro_torch.kernels.crossbar_vmm.ref import crossbar_vmm_ref
    from repro_torch.kernels.dual_compute.ref import effective_weight
    from repro_torch.launch import prng
    plan = _noisy_plan(dev, k, n)
    x = torch.tensor(np.random.default_rng(1).normal(size=(m, k)),
                     dtype=torch.float32, device=dev)
    before = crossbar_vmm.launches
    out = crossbar_matmul(x, plan, rng=prng.prng_key(9))
    torch.cuda.synchronize()
    assert crossbar_vmm.launches == before + 1
    cells = read_cells(plan, prng.prng_key(9))
    inv = inv_g_ratio(plan)
    ref = crossbar_vmm_ref(x, *cells, inv)
    assert torch.isfinite(out).all()
    assert _within_sum_order(out, ref, x, effective_weight(*cells, inv))


@pytest.mark.parametrize("m,k,n", [(8, 2048, 11008), (512, 2048, 11008),
                                   (37, 100, 130)] + XBAR_RAGGED)
def test_crossbar_then_acam_equals_fused_kernel(dev, m, k, n):
    """D o E against kernel B on the same read-noise cells and the same
    float32 inv: bit for bit — B is E's main loop with D's function as its
    epilogue."""
    from repro_torch.kernels.acam_activation.ops import acam_apply
    from repro_torch.kernels.crossbar_vmm.ops import (crossbar_matmul,
                                                      inv_g_ratio,
                                                      read_cells)
    from repro_torch.launch import prng
    plan = _noisy_plan(dev, k, n, seed=3)
    x = torch.tensor(np.random.default_rng(4).normal(size=(m, k)),
                     dtype=torch.float32, device=dev)
    table = get_table("silu", 8)
    lo, hi = table_thresholds(table, dev)
    de = acam_apply(crossbar_matmul(x, plan, rng=prng.prng_key(5)), table)
    inv = torch.tensor([inv_g_ratio(plan)], device=dev)
    b = fused_crossbar_acam(x, *read_cells(plan, prng.prng_key(5)), inv, lo,
                            hi, out_lo=float(table.out_spec.lo),
                            out_step=float(table.out_spec.step))
    assert torch.equal(de, b)


def _log_grid_operand(rng, shape, dev):
    """Magnitudes log-uniform over the DMMul grid [1e-4, 16], random signs,
    2% exact zeros (sign 0)."""
    mag = np.exp(rng.uniform(np.log(1e-4), np.log(16.0), shape))
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    keep = rng.random(shape) >= 0.02
    return torch.tensor(mag * sign * keep, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("m,k,n", [(512, 128, 512), (512, 512, 128),
                                   (4096, 2048, 2048), (37, 100, 130),
                                   (8, 512, 1024), (3, 2047, 1001),
                                   (130, 2047, 16448), (1030, 517, 2049)])
def test_nldpe_qmatmul_kernel_matches_plain_and_fused(dev, m, k, n):
    """Kernel G against its plain version (the same FMA-rounded dequant,
    expf against exp: (2 K + 8) u) and against ``nldpe_matmul`` fused,
    the same function with a twice-rounded decode ((2 K + 40) u: one ulp
    of an exp argument up to 9.2 in magnitude is 16 u of its value)."""
    from repro_torch.core.logdomain import DEFAULT_CFG, nldpe_matmul
    from repro_torch.kernels.nldpe_qmatmul.ops import (encode_int8,
                                                       nldpe_matmul_int8,
                                                       nldpe_qmatmul)
    from repro_torch.kernels.nldpe_qmatmul.ref import (dequant_ref,
                                                       nldpe_qmatmul_ref)
    spec = DEFAULT_CFG.mag_spec
    rng = np.random.default_rng(6)
    a = _log_grid_operand(rng, (m, k), dev)
    b = _log_grid_operand(rng, (k, n), dev)
    before = nldpe_qmatmul.launches
    out = nldpe_matmul_int8(a, b)
    torch.cuda.synchronize()
    assert nldpe_qmatmul.launches == before + 1
    (ac, as_), (bc, bs) = encode_int8(a), encode_int8(b)
    ref = nldpe_qmatmul_ref(ac, as_, bc, bs, spec.step, spec.log_lo)
    da = dequant_ref(ac, as_, spec.step, spec.log_lo)
    db = dequant_ref(bc, bs, spec.step, spec.log_lo)
    assert torch.isfinite(out).all()
    assert _within_sum_order(out, ref, da, db)
    fused = nldpe_matmul(a, b, mode="fused")
    assert _within_sum_order(out, fused, da, db, slack_u=40)


def test_quickstart_on_card(dev):
    """The library quickstart on the card: its kernel-D GELU equals the
    interval match bit for bit."""
    from repro_torch import quickstart
    out = quickstart.main()
    assert torch.equal(out["gelu"]["kernel"], out["gelu"]["interval"])


# ---------------------------------------------------------------------------
# the drift model, the fidelity ladder and telemetry on the card
# ---------------------------------------------------------------------------

DRIFT_EXP_ULPS = 2      # t_fault: log1p on the card and on the CPU
DRIFT_NORMAL_ULPS = 4   # g_prog with noise: erf_inv's log1p and sqrt
DRIFT_READ_TOL = 2.0 ** -20   # read weights, times each leaf's w_max


def _f32_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    a = a.cpu().contiguous().view(torch.int32).to(torch.int64)
    b = b.cpu().contiguous().view(torch.int32).to(torch.int64)
    return int((a - b).abs().max())


@pytest.mark.parametrize("noisy", [False, True], ids=["ideal", "noise"])
def test_drift_program_and_read_on_card_match_cpu(dev, noisy):
    """``program_params``, ``reprogram_params`` and ``read_params`` on the
    card and on the CPU over the reduced model's log-grid drafter (the
    same float32 targets on both, quantized on the CPU: ``exp`` rounds an
    ulp apart between the devices; faults on): the sign channel,
    ``w_max``, ``stuck_hi`` and IDEAL ``g_prog`` bitwise; ``t_fault``
    within ``DRIFT_EXP_ULPS``, noisy ``g_prog`` within
    ``DRIFT_NORMAL_ULPS``; the read weights (drift, stuck cells, read
    noise) within ``DRIFT_READ_TOL * w_max``."""
    from repro_torch.core import drift
    from repro_torch.core.noise import IDEAL, NoiseModel
    from repro_torch.launch import prng
    from repro_torch.launch.spec_decode import quantize_draft_params
    from repro_torch.models import lm
    cfg = get_config("qwen2_5_3b", reduced=True)
    params = quantize_draft_params(lm.init_params(
        cfg, generator=torch.Generator().manual_seed(3), device="cpu"))
    m = drift.DriftModel(nu=0.6, t0=2.0, fault_rate=0.02,
                         noise=NoiseModel() if noisy else IDEAL,
                         verify_passes=2)
    key = prng.prng_key(21)
    out = {}
    for where in ("cpu", "cuda"):
        p = from_jax(_np(params), device=where)
        st = drift.program_params(key, p, m)
        drift.reprogram_params(prng.fold_in(key, 1), st, p, m, 3.0)
        w = drift.read_params(st, m, 9.0, prng.fold_in(key, 2))
        out[where] = (drift.flatten(st["cells"],
                                    is_leaf=drift._is_cell_state),
                      drift.flatten(w))
    for (_, a), (_, b) in zip(out["cpu"][0], out["cuda"][0]):
        assert torch.equal(a["sign"], b["sign"].cpu())
        assert torch.equal(a["w_max"], b["w_max"].cpu())
        assert torch.equal(a["stuck_hi"], b["stuck_hi"].cpu())
        assert _f32_ulps(a["t_fault"], b["t_fault"]) <= DRIFT_EXP_ULPS
        if noisy:
            assert _f32_ulps(a["g_prog"], b["g_prog"]) <= DRIFT_NORMAL_ULPS
        else:
            assert torch.equal(a["g_prog"], b["g_prog"].cpu())
    for (_, a), (_, b), (_, st) in zip(out["cpu"][1], out["cuda"][1],
                                       out["cpu"][0]):
        err = (a - b.cpu()).abs().max().item()
        assert err <= DRIFT_READ_TOL * st["w_max"].item()


def _small_drift_engine(where, params, cfg, **kw):
    from repro_torch.core.drift import DriftModel
    from repro_torch.core.engine import NLDPEConfig
    from repro_torch.launch.engine import PagedServeEngine
    from repro_torch.launch.fidelity import DriftInjection, FidelityPolicy
    inj = DriftInjection(model=DriftModel(nu=0.5, t0=2.0, fault_rate=0.05),
                         seed=3, dt_step=10.0)
    return PagedServeEngine(
        cfg, from_jax(_np(params), device=where), max_slots=2, max_len=24,
        page_size=4, prefill_chunk=4, decode_block=2, spec_k=2,
        spec_draft=NLDPEConfig(enabled=False), drift=inj,
        fidelity=FidelityPolicy(window=3, reprogram_patience=1,
                                max_reprograms=2), device=where, **kw)


def test_drift_engine_on_card_walks_the_ladder(dev):
    """A small drift engine (dense stuck-at faults) on the card, f32
    activations: the ladder backs off, reprograms and disables the drafter
    as on the CPU, and the card's tokens are the CPU's up to one near-tie;
    kernel A serves the verify at q_len 3 and the exact fallback."""
    import dataclasses

    from repro_torch.launch.engine import Request
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    from repro_torch.models import lm
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=tuple(int(x) for x in rng.integers(
        0, 3, 5)), max_new_tokens=6) for i in range(24)]
    out, kinds = {}, {}
    for where in ("cpu", "cuda"):
        eng = _small_drift_engine(where, params, cfg)
        before = paged_attention.launches
        out[where] = {c.rid: c.tokens for c in eng.run(reqs)}
        kinds[where] = [e["event"] for e in eng.fidelity_stats["events"]]
        if where == "cuda":
            assert paged_attention.launches > before
            assert eng.fidelity_stats["disabled_ticks"] > 0
            assert eng.drift_reads == eng.spec_stats["spec_steps"]
        eng.pool.check()
        assert eng.pool.available() == eng.pool.num_pages
    assert {"backoff", "reprogram", "disable"} <= set(kinds["cuda"])
    ties = sum(out["cpu"][r.rid] != out["cuda"][r.rid] for r in reqs)
    assert ties <= 1


def test_telemetry_on_equals_off_on_card(dev):
    """The paged spec engine on the card with telemetry on and off: the
    same tokens bit for bit (the same kernels, observation only), and a
    trace with every request's lifecycle."""
    import dataclasses

    from repro_torch.core.engine import NLDPEConfig
    from repro_torch.launch.engine import PagedServeEngine, Request
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    rng = np.random.default_rng(9)
    shared = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 8))
    reqs = [Request(rid=i, tokens=shared + tuple(
        int(t) for t in rng.integers(0, cfg.vocab_size, 1 + i)),
        max_new_tokens=8, temperature=0.7 * (i % 2), arrival=i)
        for i in range(5)]
    out = {}
    for tel in (False, True):
        eng = PagedServeEngine(cfg, params, max_slots=3, max_len=32,
                               page_size=4, prefill_chunk=4, decode_block=2,
                               spec_k=2, spec_draft=NLDPEConfig(enabled=False),
                               telemetry=tel, device=dev)
        out[tel] = {c.rid: c.tokens for c in eng.run(reqs)}
    assert out[True] == out[False]
    s = eng.telemetry.summary()
    assert s["requests_finished"] == len(reqs)
    assert s["phases"]["verify"]["calls"] == eng.spec_stats["spec_steps"]


# ---------------------------------------------------------------------------
# kernel A's batch invariance, the host spill tier, preemption and the
# async pipeline on the card
# ---------------------------------------------------------------------------

def _invariance_launches(dev, pool, q_len, seed=3, hq=16, hkv=2, d=128):
    """One sequence (``seq``) through kernel A in two launches with other
    co-batched sequences (other lengths, other block tables, another batch
    size and slot), over one pool of ``pool``'s kind at the serve engine's
    Qwen2.5-3B widths (16/2 heads, D 128, pages of 16, a 64-page table;
    ``hq``, ``hkv`` and ``d`` another model's).  Returns seq's outputs of
    both launches."""
    rng = np.random.default_rng(seed)
    ps, nb, p = 16, 64, 600
    kp = torch.tensor(rng.normal(size=(p, hkv, ps, d)), dtype=torch.float32)
    vp = torch.tensor(rng.normal(size=(p, hkv, ps, d)), dtype=torch.float32)
    kw = {}
    if pool in ("int8", "log8"):
        from repro_torch.nn.attention import _quantize_kv
        (kp, ks), (vp, vs) = _quantize_kv(kp, pool), _quantize_kv(vp, pool)
        kw = dict(k_scale=ks.to(dev), v_scale=vs.to(dev), kv_quant=pool)
    elif pool == "bfloat16":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    kp, vp = kp.to(dev), vp.to(dev)
    pages = rng.permutation(p)
    seq_len = 700
    seq_bt = pages[:nb]
    q_seq = torch.tensor(rng.normal(size=(1, hq, q_len, d)),
                         dtype=torch.float32)

    def launch(others, at):
        """seq at batch index ``at`` among ``others`` (length, pages)."""
        lens, bts, qs = [], [], []
        for i, (n, pg) in enumerate(others):
            lens.append(n)
            bts.append(pg)
            qs.append(torch.tensor(rng.normal(size=(1, hq, q_len, d)),
                                   dtype=torch.float32))
        lens.insert(at, seq_len)
        bts.insert(at, seq_bt)
        qs.insert(at, q_seq)
        out = paged_attention(
            torch.cat(qs).to(dev), kp, vp,
            torch.tensor(np.stack(bts), dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), **kw)
        return out[at]

    a = launch([(40, pages[64:128]), (1000 - q_len, pages[128:192])], 0)
    b = launch([(300, pages[192:256]), (9, pages[256:320]),
                (650, pages[320:384]), (1000 - q_len, pages[384:448]),
                (120, pages[448:512])], 3)
    torch.cuda.synchronize()
    return a, b


# Both instances sum each sequence's splits from its own length (decode:
# the table's width; chunk: a fixed number of stages a split, capped), so
# a sequence's outputs are bit-invariant to the other sequences of the
# launch.


@pytest.mark.parametrize("q_len", [1, 64], ids=["decode", "chunk"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "log8"])
def test_paged_attention_batch_invariance(dev, pool, q_len, capsys):
    a, b = _invariance_launches(dev, pool, q_len)
    diff = (a - b).abs().max().item()
    with capsys.disabled():
        print(f"\n[kernel A batch invariance] {pool} q_len={q_len}: "
              f"max |diff| {diff:.3e}, bitwise {torch.equal(a, b)}")
    assert torch.equal(a, b)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "log8"])
def test_paged_attention_chunk_row_invariance(dev, pool):
    """A query at position p computed in two 64-query chunks that start at
    other positions (so at another row of the chunk, with other base
    lengths and another batch): the chunk instance cuts every sequence at
    the same absolute split boundaries, so its output is the same bits —
    the re-serve of a cached prompt recomputes its last token this way."""
    _chunk_row_invariance(dev, pool, 16, 2, 128)


def _chunk_row_invariance(dev, pool, hq, hkv, d):
    """``test_paged_attention_chunk_row_invariance`` at ``hq``/``hkv``
    heads of ``d``."""
    rng = np.random.default_rng(11)
    ps, nb, p_pages = 16, 64, 300
    kp = torch.tensor(rng.normal(size=(p_pages, hkv, ps, d)),
                      dtype=torch.float32)
    vp = torch.tensor(rng.normal(size=(p_pages, hkv, ps, d)),
                      dtype=torch.float32)
    kw = {}
    if pool in ("int8", "log8"):
        from repro_torch.nn.attention import _quantize_kv
        (kp, ks), (vp, vs) = _quantize_kv(kp, pool), _quantize_kv(vp, pool)
        kw = dict(k_scale=ks.to(dev), v_scale=vs.to(dev), kv_quant=pool)
    elif pool == "bfloat16":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    kp, vp = kp.to(dev), vp.to(dev)
    pages = rng.permutation(p_pages)
    q_pos = torch.tensor(rng.normal(size=(hq, 200, d)), dtype=torch.float32)
    outs = {}
    for base, other in ((640, 1), (672, 3)):          # rows p - base
        q = q_pos[:, base - 600:base - 600 + 64][None]
        bts = [pages[:nb]] + [pages[nb * (i + 1):nb * (i + 2)]
                              for i in range(other)]
        qs = [q] + [torch.tensor(rng.normal(size=(1, hq, 64, d)),
                                 dtype=torch.float32) for _ in range(other)]
        lens = [base + 1] + list(rng.integers(10, 900, other))
        out = paged_attention(
            torch.cat(qs).to(dev), kp, vp,
            torch.tensor(np.stack(bts), dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), **kw)
        outs[base] = out[0].cpu()
    # positions 672..703 sit at rows 32..63 of the first, 0..31 of the second
    assert torch.equal(outs[640][:, 32:], outs[672][:, :32])


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "log8"])
def test_spill_restore_page_round_trip_on_card(dev, pool):
    """A served engine's page through the spill hook to the host and back
    into another page: bit for bit, and the payload is a host copy that
    does not change when the device page is overwritten."""
    import dataclasses

    from repro_torch.launch.engine import PagedServeEngine, Request
    from repro_torch.nn.attention import gather_page_rows
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    from repro_torch.models import lm
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    kw = (dict(kv_quant=pool) if pool in ("int8", "log8")
          else dict(dtype=getattr(torch, pool)))
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=32,
                           page_size=4, num_pages=10, prefill_chunk=4,
                           decode_block=2, host_cache_pages=8, device=dev,
                           **kw)
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, 13)), max_new_tokens=4, arrival=2 * i)
        for i in range(6)]
    eng.run(reqs)
    assert eng.stats["spilled"] > 0
    page = next(p for p in range(eng.num_pages) if eng.pool._node[p])
    before = [r.clone() for r in gather_page_rows(eng.cache, page)]
    payload = eng._spill_page(page)
    assert all(x.device.type == "cpu" for x in payload)
    for leaf in gather_page_rows(eng.cache, page):
        leaf.fill_(7)
    torch.cuda.synchronize()
    dst = next(p for p in range(eng.num_pages)
               if p != page and eng.pool.refcount(p) == 0)
    for p_, host in ((dst, payload), (page, payload)):
        eng._restore_page(host, p_)
        for got, want, h in zip(gather_page_rows(eng.cache, p_), before,
                                host):
            assert torch.equal(got, want) and torch.equal(h, want.cpu())


def _tier_trace(cfg):
    """Spill then restore (a 12-token shared prefix evicted by two long
    fillers, then hit twice), then a priority arrival on a full engine."""
    from repro_torch.launch.engine import Request
    rng = np.random.default_rng(5)
    shared = tuple(int(x) for x in rng.integers(0, cfg.vocab_size, 12))
    fill = [tuple(int(x) for x in rng.integers(0, 64, n)) for n in (11, 10)]
    spill = [Request(rid=0, tokens=shared, max_new_tokens=3),
             Request(rid=1, tokens=fill[0], max_new_tokens=6, arrival=9),
             Request(rid=2, tokens=fill[1], max_new_tokens=6, arrival=9),
             Request(rid=3, tokens=shared + (1,), max_new_tokens=4,
                     arrival=18),
             Request(rid=4, tokens=shared, max_new_tokens=2, arrival=27)]
    low = [tuple(int(x) for x in rng.integers(0, 64, n)) for n in (9, 10)]
    prio = [Request(rid=10, tokens=low[0], max_new_tokens=6),
            Request(rid=11, tokens=low[1], max_new_tokens=6),
            Request(rid=12, tokens=tuple(int(x) for x in rng.integers(
                0, 64, 8)), max_new_tokens=4, arrival=1, priority=2)]
    return spill, prio


def _tier_tokens(eng, wrap=None) -> dict:
    import dataclasses
    runner = wrap(eng) if wrap else eng
    out = {}
    for reqs in _tier_trace(eng.cfg):
        base = runner.tick
        out.update({c.rid: c.tokens for c in runner.run([
            dataclasses.replace(r, arrival=base + r.arrival)
            for r in reqs])})
    if wrap:
        runner.close()
    return out


def test_spill_preempt_and_async_engines_on_card_match_cpu(dev):
    """A small two-tier engine (8 device pages, 6 host pages) on the card,
    f32 activations: it spills, restores, preempts and resumes, and its
    tokens are the CPU plain path's up to one near-tie; so are an async
    pipeline's over the same engine with prefill buckets."""
    import dataclasses

    from repro_torch.launch.async_engine import AsyncServeEngine
    from repro_torch.launch.engine import PagedServeEngine
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                              activation_dtype=torch.float32)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    out = {}
    for where in ("cpu", "cuda"):
        for kind in ("sync", "async"):
            eng = PagedServeEngine(
                cfg, from_jax(_np(params), device=where), max_slots=2,
                max_len=24, page_size=4, num_pages=8, prefill_chunk=4,
                decode_block=2, host_cache_pages=6, device=where,
                prefill_buckets=(kind == "async") or None)
            before = paged_attention.launches
            out[where, kind] = _tier_tokens(
                eng, AsyncServeEngine if kind == "async" else None)
            st = eng.stats
            assert st["spilled"] > 0 and st["restored"] > 0
            assert eng.preempts > 0 and eng.resumes > 0
            if where == "cuda":
                assert paged_attention.launches > before
            eng.pool.check()
            assert eng.pool.available() == eng.pool.num_pages
    assert out["cpu", "sync"] == out["cpu", "async"]
    for kind in ("sync", "async"):
        ties = sum(out["cpu", kind][r] != out["cuda", kind][r]
                   for r in out["cpu", kind])
        assert ties <= 1, kind


# ---------------------------------------------------------------------------
# Noise-Aware Fine-tuning and the training step on the card
# ---------------------------------------------------------------------------

def _odd_thresholds(table, rng):
    """``table``'s thresholds with what NAF and corrupted devices produce:
    rows with lo > hi, overlapping rows, and padding rows kept."""
    lo, hi = table.lo.copy(), table.hi.copy()
    rows = np.flatnonzero(np.abs(lo[0]) < 1e29)
    swap = rows[:2]
    lo[0, swap], hi[0, swap] = hi[0, swap], lo[0, swap]          # lo > hi
    if lo.shape[1] > 3:
        lo[1, 1], hi[1, 1] = lo[1, 0] - 0.3, hi[1, 0] + 0.2      # overlap
    assert (np.abs(lo) >= 1e29).any()                            # padding
    return lo, hi


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_acam_kernel_on_naf_and_corrupted_thresholds(dev, name):
    """Kernel D (``acam_apply_grid``, the NAF evaluation's entry) on a
    corrupted table, on a NAF-trained one and on thresholds with rows
    lo > hi, overlapping rows and padding rows, at random inputs and at
    every threshold itself: bitwise its plain version; ``hard_acam_forward``
    on CUDA tensors launches it once per call."""
    from repro_torch.core import dt, naf, noise
    from repro_torch.core.differentiable import hard_acam_forward
    from repro_torch.kernels.acam_activation.ops import (acam_apply,
                                                         acam_apply_grid)
    from repro_torch.kernels.acam_activation.ref import acam_activation_ref
    from repro_torch.launch import prng
    table = dt.build_table(name)
    rng = np.random.default_rng(13)
    bad = naf.corrupt_table(table, prng.prng_key(42),
                            noise.DEFAULT.rescale(6.0), device=dev)
    fixed = naf.finetune_table(bad, rng=prng.prng_key(0),
                               model=noise.DEFAULT.rescale(2.0), epochs=1,
                               samples=1024, batch=512, device=dev).table
    grid = (float(table.out_spec.lo), float(table.out_spec.step))
    for lo, hi in ((bad.lo, bad.hi), (fixed.lo, fixed.hi),
                   _odd_thresholds(bad, rng)):
        lo_t, hi_t = (torch.tensor(a, dtype=torch.float32, device=dev)
                      for a in (lo, hi))
        finite = np.concatenate([lo[np.abs(lo) < 1e29],
                                 hi[np.abs(hi) < 1e29]])
        x = torch.tensor(np.concatenate([
            rng.uniform(-9, 9, 200_000), finite,
            np.nextafter(finite, np.inf), np.nextafter(finite, -np.inf)]),
            dtype=torch.float32, device=dev)
        before = acam_apply.launches
        out = acam_apply_grid(x, lo_t, hi_t, *grid)
        torch.cuda.synchronize()
        assert acam_apply.launches == before + 1
        assert torch.equal(out, acam_activation_ref(x, lo_t, hi_t, *grid))
    before = acam_apply.launches
    y = hard_acam_forward(x, lo_t, hi_t, rng=prng.prng_key(3).to(dev),
                          model=noise.DEFAULT, out_lo=grid[0],
                          out_step=grid[1])
    assert acam_apply.launches == before + 1 and y.device.type == "cuda"


def test_chunked_eq6_draw_of_a_full_width_leaf(dev):
    """Qwen2.5-3B's stacked MLP up leaf (36 x 2048 x 11008 = 811.6M
    weights) through ``inject_crossbar_noise`` chunk by chunk: windows at
    the start, across a chunk boundary and at the end equal one draw of
    that window alone at the same counter offsets (the whole-leaf draw of
    a smaller leaf), bit for bit, with the leaf's w_max."""
    from repro_torch.core import drift, naf
    from repro_torch.core.noise import DEFAULT
    from repro_torch.launch import prng
    gen = torch.Generator(device=dev).manual_seed(21)
    leaf = torch.randn((36, 2048, 11008), generator=gen, device=dev) * 0.02
    key = prng.prng_key(17).to(dev)
    out = naf.inject_crossbar_noise(key, {"w": leaf})["w"]
    keys = tuple(k.to(dev) for k in naf.leaf_keys(key, {"w": leaf})[0])
    wm = torch.clamp(naf.leaf_amax(leaf), min=1e-6)
    assert float(wm) == float(leaf.abs().max())
    n = leaf.numel()
    for o, m in ((0, 1 << 20), (drift.CHUNK - 4096, 8192),
                 (5 * drift.CHUNK - 3, 7), (n - 777, 777)):
        want = naf.noisy_chunk(keys, leaf.view(-1)[o:o + m], wm, DEFAULT, o)
        assert torch.equal(out.view(-1)[o:o + m], want), (o, m)
    assert not torch.equal(out, leaf)
    assert float((out - leaf).abs().max()) < 0.1 * float(wm)


def _train_setup(dev_a, dev_b, arch="qwen2_5_3b", seq=16):
    import dataclasses

    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              activation_dtype=torch.float32)
    p = lm.init_params(cfg, generator=torch.Generator().manual_seed(5),
                       device="cpu")
    rng = np.random.default_rng(6)
    t = torch.tensor(rng.integers(0, cfg.vocab_size, (4, seq + 1)),
                     dtype=torch.int32)
    batch = {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}

    def on(d):
        return _deep_to(p, d), {k: v.to(d) for k, v in batch.items()}
    return cfg, on(dev_a), on(dev_b)


def _deep_to(tree, d):
    return ({k: _deep_to(v, d) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.to(d).clone())


@pytest.mark.parametrize("arch,naf", [
    ("qwen2_5_3b", False), ("qwen2_5_3b", True), ("gemma3_27b", False),
    ("recurrentgemma_9b", False), ("qwen3_moe_30b_a3b", False),
    ("llama4_scout_17b_a16e", False), ("rwkv6_3b", False)],
    ids=["plain", "naf", "gemma3", "recurrentgemma", "qwen3moe",
         "llama4scout", "rwkv6"])
def test_train_step_on_card_matches_cpu(dev, arch, naf):
    """One reduced-width train step (f32) on the card against the CPU
    port, for every block type (24 positions past the reduced windows for
    the new ones): the loss within 1e-5, the first moments within 1e-7;
    for ``qwen2_5_3b`` the second moments within 1e-9 and the parameters
    within 0.1 x lr (Adam over ~1e-9 gradients; tests/test_torch_train.py),
    for the other archs, whose grad norms run 10x larger, the second
    moments within 1e-9 or 2e-5 of the leaf's largest and the parameters
    within 0.1 x lr where the gradient reaches 1e-6
    (tests/test_torch_train_families.py)."""
    from repro_torch.core.drift import flatten
    from repro_torch.launch.train import build_train_step
    from repro_torch.optim import adamw
    cfg, (pc, bc), (pg, bg) = _train_setup(
        "cpu", dev, arch, 16 if arch == "qwen2_5_3b" else 24)
    step = build_train_step(cfg, adamw.AdamWConfig(lr=1e-3), naf=naf,
                            naf_lambda1=1e-2, naf_lambda2=1e-2)
    sc, sg = adamw.init(pc), adamw.init(pg)
    _, _, mc = step(pc, sc, bc)
    _, _, mg = step(pg, sg, bg)
    assert mg["loss"].item() == pytest.approx(mc["loss"].item(), rel=1e-5)
    for (_, p), (_, pd), (_, m), (_, md), (_, v), (_, vd) in zip(
            flatten(pc), flatten(pg), flatten(sc["m"]), flatten(sg["m"]),
            flatten(sc["v"]), flatten(sg["v"])):
        assert pd.device.type == "cuda"
        assert (m - md.cpu()).abs().max().item() <= 1e-7
        strict = arch == "qwen2_5_3b"
        v_tol = 1e-9 if strict else max(1e-9, 2e-5 * v.abs().max().item())
        assert (v - vd.cpu()).abs().max().item() <= v_tol
        live = (m.abs() / 0.1 >= 1e-6) | strict
        assert torch.where(live, (p - pd.cpu()).abs(), 0.0).max().item() \
            <= 1e-4


@pytest.mark.parametrize("grad", [False, True], ids=["values", "under_grad"])
def test_rglru_softplus_keeps_the_clamp_values_on_card(dev, grad):
    """``nn.rglru.softplus`` gives the max-plus-log1p form's values bit for
    bit on the card, with and without a gradient (its max is
    ``core.noise.clip``'s under a gradient, for ``jax``'s derivative at
    0); ``torch.logaddexp`` would round differently."""
    from repro_torch.nn.rglru import softplus
    x = torch.linspace(-100, 100, 2_000_001, device=dev)
    x[::7] = 0.0
    want = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    got = softplus(x.clone().requires_grad_(grad)).detach()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_finetune_table_on_card_matches_cpu(dev):
    """``finetune_table`` on the card against the CPU port (the same keys
    and samples): ``mse_before`` within 1e-5, ``mse_after`` within 2e-2;
    every hard evaluation through kernel D: 8 draws before, 1 clean, 8 a
    epoch and 8 after."""
    from repro_torch.core import dt, naf, noise
    from repro_torch.kernels.acam_activation.ops import acam_apply
    from repro_torch.launch import prng
    bad = naf.corrupt_table(dt.build_table("gelu"), prng.prng_key(42),
                            noise.DEFAULT.rescale(6.0), device="cpu")
    kw = dict(rng=prng.prng_key(0), model=noise.DEFAULT.rescale(2.0),
              epochs=2, samples=600, batch=200)
    cpu = naf.finetune_table(bad, device="cpu", **kw)
    before = acam_apply.launches
    card = naf.finetune_table(bad, device=dev, **kw)
    assert acam_apply.launches - before == 8 + 1 + 8 * 2 + 8
    assert card.mse_before == pytest.approx(cpu.mse_before, rel=1e-5)
    assert card.mse_clean == pytest.approx(cpu.mse_clean, rel=1e-5)
    assert card.mse_after == pytest.approx(cpu.mse_after, rel=2e-2)


# the (M, K, N) of the 15 NL-DPE convolutions of one CNNConfig() forward at
# batch 32: stem, stage 0, stage 1 (and its 1x1 projection), stage 2 (and
# its projection)
CNN_G_SHAPES = [(32768, 27, 16), (32768, 144, 16), (8192, 144, 32),
                (8192, 288, 32), (8192, 16, 32), (2048, 288, 64),
                (2048, 576, 64), (2048, 32, 64)]


@pytest.mark.parametrize("m,k,n", CNN_G_SHAPES)
def test_nldpe_qmatmul_at_cnn_conv_shapes(dev, m, k, n):
    """Kernel G at every CNN conv shape (ragged M, N and K everywhere)
    against its plain version ((2 K + 8) u) and ``nldpe_matmul`` fused
    ((2 K + 40) u), through ``ON.dmmul``: one launch a call."""
    from repro_torch.core.engine import ON
    from repro_torch.core.logdomain import DEFAULT_CFG, nldpe_matmul
    from repro_torch.kernels.nldpe_qmatmul.ops import encode_int8, nldpe_qmatmul
    from repro_torch.kernels.nldpe_qmatmul.ref import (dequant_ref,
                                                       nldpe_qmatmul_ref)
    spec = DEFAULT_CFG.mag_spec
    rng = np.random.default_rng(m + k + n)
    a = _log_grid_operand(rng, (m, k), dev)
    b = _log_grid_operand(rng, (k, n), dev)
    before = nldpe_qmatmul.launches
    out = ON.dmmul(a, b)
    torch.cuda.synchronize()
    assert nldpe_qmatmul.launches == before + 1
    (ac, as_), (bc, bs) = encode_int8(a), encode_int8(b)
    ref = nldpe_qmatmul_ref(ac, as_, bc, bs, spec.step, spec.log_lo)
    da = dequant_ref(ac, as_, spec.step, spec.log_lo)
    db = dequant_ref(bc, bs, spec.step, spec.log_lo)
    assert torch.isfinite(out).all()
    assert _within_sum_order(out, ref, da, db)
    assert _within_sum_order(out, nldpe_matmul(a, b, mode="fused"), da, db,
                             slack_u=40)


def test_dmmul_on_card_launches_g_and_refuses(dev):
    """``ON.dmmul`` on CUDA tensors: kernel G once per call (leading
    dimensions flattened against a 2-D ``b``), never ``torch.matmul``;
    a call that needs a gradient raises ``NotImplementedError`` and
    another rank ``ValueError``; under ``no_grad`` grad-requiring inputs
    run."""
    from repro_torch.core.engine import OFF, ON
    from repro_torch.kernels.nldpe_qmatmul.ops import (nldpe_matmul_int8,
                                                       nldpe_qmatmul)
    rng = np.random.default_rng(11)
    a = _log_grid_operand(rng, (2, 37, 100), dev)
    b = _log_grid_operand(rng, (100, 19), dev)
    before = nldpe_qmatmul.launches
    out = ON.dmmul(a, b)
    assert nldpe_qmatmul.launches == before + 1
    assert out.shape == (2, 37, 19) and out.dtype == torch.float32
    flat = nldpe_matmul_int8(a.reshape(-1, 100), b).reshape(2, 37, 19)
    assert torch.equal(out, flat)
    before = nldpe_qmatmul.launches
    assert torch.equal(OFF.dmmul(a, b), torch.matmul(a, b))
    assert nldpe_qmatmul.launches == before
    with pytest.raises(NotImplementedError, match="no backward"):
        ON.dmmul(a.clone().requires_grad_(), b)
    with pytest.raises(NotImplementedError, match="no backward"):
        ON.dmmul(a, b.clone().requires_grad_())
    with pytest.raises(ValueError, match="kernel G"):
        ON.dmmul(a, b[None])
    with pytest.raises(ValueError, match="kernel G"):
        ON.dmmul(a[0, 0], b)
    with torch.no_grad():
        ON.dmmul(a.clone().requires_grad_(), b)
    assert nldpe_qmatmul.launches == before + 1


def test_cnn_forward_on_card_matches_cpu(dev, capsys):
    """Full-width ``CNNConfig()`` at batch 8 from the same CPU-drawn
    weights: ``OFF`` logits on the card (cuDNN with TF32 off) within 1e-4
    of the CPU's; ``ON`` logits within 3e-2, with 15 launches of G: G sums
    each output in k order, the CPU's matmul in blocks, so an ACAM ReLU
    input within an ulp of a threshold may take the other output step and
    the flip spreads through the log-grid codes after it
    (tests/test_torch_cnn.py; 1.08e-2 measured on an H100)."""
    from repro_torch.core.drift import flatten
    from repro_torch.core.engine import OFF, ON
    from repro_torch.data.images import ImageDataConfig, make_batch_fn
    from repro_torch.kernels.nldpe_qmatmul.ops import nldpe_qmatmul
    from repro_torch.models import cnn
    torch.backends.cudnn.allow_tf32 = False
    cfg = cnn.CNNConfig()
    pc = cnn.init_params(cfg, device="cpu")
    pg = cnn.init_params(cfg, device=dev)
    for (_, x), (_, y) in zip(flatten(pc), flatten(pg)):
        assert torch.equal(x, y.cpu())
    batch = make_batch_fn(ImageDataConfig(batch=8), device="cpu")(0)
    x = batch["images"]
    with torch.no_grad():
        for nldpe, tol in ((OFF, 1e-4), (ON, 3e-2)):
            before = nldpe_qmatmul.launches
            got = cnn.forward(pg, x.to(dev), cfg, nldpe=nldpe)
            torch.cuda.synchronize()
            assert nldpe_qmatmul.launches - before == (15 if nldpe.enabled
                                                       else 0)
            want = cnn.forward(pc, x, cfg, nldpe=nldpe)
            err = (got.cpu() - want).abs().max().item()
            with capsys.disabled():
                print(f"\n[cnn card vs cpu] {'ON' if nldpe.enabled else 'OFF'}"
                      f" logits max |diff| {err:.3g} (tolerance {tol})")
            assert err <= tol
    with pytest.raises(ValueError, match="CPU generator"):
        cnn.init_params(cfg, generator=torch.Generator(device=dev),
                        device=dev)


def test_checkpoint_restore_onto_cuda_templates(dev, tmp_path):
    """Leaves saved from the card (float32, bfloat16, int32 step) restore
    onto CUDA templates on the card, each with its template's dtype, bit
    for bit; a ``mul_`` after ``save`` does not reach the file."""
    from repro_torch.checkpoint.manager import CheckpointManager
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn((64, 33), generator=g, device=dev),
            "h": torch.randn(17, generator=g, device=dev).to(torch.bfloat16),
            "step": torch.tensor(9, dtype=torch.int32, device=dev)}
    want = {k: v.clone() for k, v in tree.items()}
    m = CheckpointManager(str(tmp_path), async_write=True)
    m.save(tree, 3, blocking=False)
    tree["w"].mul_(-1.0)
    m.wait()
    template = {k: torch.zeros_like(v) for k, v in want.items()}
    out, step = m.restore_latest(template)
    assert step == 3
    for k, v in want.items():
        assert out[k].device.type == "cuda" and out[k].dtype == v.dtype
        assert torch.equal(out[k], v), k


def test_train_cli_restart_on_card(dev, tmp_path, capsys):
    """The train CLI on the card killed at step 7 and resumed from its
    step-5 checkpoint: the resumed losses within rtol 1e-4 of an
    uninterrupted run's (cuBLAS and the embedding backward's atomics may
    not repeat bit for bit); the largest relative difference is
    printed."""
    from repro_torch.launch.train import run
    argv = ["--steps", "10", "--batch", "2", "--seq", "16", "--ckpt-every",
            "5"]
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        run(argv + ["--ckpt-dir", ck, "--fail-at-step", "7"])
    resumed = run(argv + ["--ckpt-dir", ck])
    clean = run(argv)
    assert len(resumed) == 5
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, clean[5:]))
    with capsys.disabled():
        print(f"\n[train restart on card] resumed vs clean losses: max "
              f"relative difference {rel:.3g} "
              f"({'bitwise' if resumed == clean[5:] else 'not bitwise'})")
    assert rel <= 1e-4


# -- sliding windows and the RG-LRU block (Gemma3, RecurrentGemma) --------

@pytest.mark.parametrize("m,k,n", [(256, 5376, 21504), (4, 5376, 21504),
                                   (1, 5376, 21504), (2, 4096, 12288),
                                   (37, 100, 130), (130, 2047, 11001)])
def test_fused_crossbar_acam_gelu_matches_plain(dev, m, k, n):
    """Kernel B with the non-monotonic gelu table (Gemma3's and
    RecurrentGemma's MLP gates) at both models' gate widths and ragged
    shapes: one ACAM code on at most 1e-4 of the outputs, as with silu."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.normal(size=(k, n)) * k ** -0.5,
                     dtype=torch.float32, device=dev)
    table = get_table("gelu", 8)
    cells, inv = program(w)
    lo, hi = table_thresholds(table, dev)
    kw = dict(out_lo=float(table.out_spec.lo),
              out_step=float(table.out_spec.step))
    out = fused_crossbar_acam(x, *cells, inv, lo, hi, **kw)
    ref = fused_crossbar_acam_ref(x, *cells, inv, lo, hi, **kw)
    diff = (out - ref).abs()
    assert diff.max().item() <= float(table.out_spec.step) * 1.0001
    assert (diff > 0).float().mean().item() <= 1e-4
    assert torch.equal(fused_linear_acam(x, w, "gelu"), out)


@pytest.mark.parametrize("arch", ["gemma3_27b", "recurrentgemma_9b"])
@pytest.mark.parametrize("fused", [False, True], ids=["OFF", "FUSED"])
def test_windowed_lockstep_on_card_matches_cpu_plain_path(dev, arch, fused):
    """The reduced windowed models (window 16) through the lockstep path,
    40-token prompts (the band on the local layers; kernel F, or kernels
    C and B, on Gemma3's global layer and every gate) and 8 greedy tokens
    over wrapping rings, card against CPU plain path, f32 activations:
    last prefill logits within 1e-4 OFF and 1e-2 FUSED, equal tokens."""
    import dataclasses

    from repro_torch.core.engine import FUSED, OFF
    from repro_torch.launch.serve import build_generate_fn, build_prefill_step
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              activation_dtype=torch.float32)
    nldpe = FUSED if fused else OFF
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(4),
                            device="cpu")
    prompts = torch.tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
    out = {}
    for where in ("cpu", "cuda"):
        p = lm.serving_params(from_jax(_np(params), device=where), cfg, nldpe)
        cache = lm.init_model_cache(cfg, 2, 48, device=where)
        last, cache = build_prefill_step(cfg, nldpe=nldpe)(
            p, cache, prompts.to(where))
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        gen, _ = build_generate_fn(cfg, 8, nldpe=nldpe)(p, cache, tok, 40)
        out[where] = (last.cpu(), gen.cpu())
    tol = 1e-2 if fused else 1e-4
    assert (out["cpu"][0] - out["cuda"][0]).abs().max().item() <= tol
    assert torch.equal(out["cpu"][1], out["cuda"][1])


def test_windowed_engine_on_card_matches_cpu_plain_path(dev):
    """``ServeEngine`` over the reduced Gemma3 (rings of 16 + 7 lines at
    prefill_chunk 8, prompts of 32-48 tokens that wrap them) on the card
    and on the CPU, f32 activations: the same greedy tokens."""
    import dataclasses

    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("gemma3_27b", reduced=True),
                              activation_dtype=torch.float32)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(32, 49)))), max_new_tokens=6,
        arrival=i) for i in range(4)]
    out = {}
    for where in ("cpu", "cuda"):
        eng = ServeEngine(cfg, from_jax(_np(params), device=where),
                          max_slots=2, max_len=64, prefill_chunk=8,
                          decode_block=2, device=where)
        out[where] = {c.rid: c.tokens for c in eng.run(reqs)}
    assert out["cpu"] == out["cuda"]


def test_rglru_scan_on_card_matches_step_loop(dev):
    """The odd/even scan on the card against the per-step recurrence on
    the card (1e-5) and against the scan on the CPU (1e-5)."""
    from repro_torch.models import lm
    from repro_torch.nn import rglru
    cfg = get_config("recurrentgemma_9b", reduced=True)
    p = lm.init_params(cfg, generator=torch.Generator().manual_seed(6),
                       device="cpu")["groups"]["b0"]["rec"]["rglru"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.tensor(np.random.default_rng(10).normal(size=(2, 333, 64)),
                     dtype=torch.float32)
    y_cpu, h_cpu = rglru.rglru_scan(p, x)
    pc = {k: v.to(dev) for k, v in p.items()}
    y, h_last = rglru.rglru_scan(pc, x.to(dev))
    h = torch.zeros((2, 64), device=dev)
    ys = []
    for t in range(333):
        y_t, h = rglru.rglru_step(pc, x[:, t:t + 1].to(dev), h)
        ys.append(y_t)
    assert (torch.cat(ys, 1) - y).abs().max().item() <= 1e-5
    assert (h - h_last).abs().max().item() <= 1e-5
    assert (y.cpu() - y_cpu).abs().max().item() <= 1e-5
    assert (h_last.cpu() - h_cpu).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# the MoE and RWKV6 slice: kernels at Qwen3-30B-A3B's head layout (32 query
# heads, 4 KV heads, head dim 128), the reduced models card against CPU
# ---------------------------------------------------------------------------

QWEN3_MOE_PAGED = (8, 32, 4, 512, 64, 16, 128)


@pytest.mark.parametrize("q_len", [1, 64])
@pytest.mark.parametrize("pool", ["float32", "log8"])
def test_paged_attention_at_qwen3_moe_heads(dev, pool, q_len):
    """Kernel A at GQA 8 (32/4 heads of 128): decode and a 64-row chunk,
    over an f32 pool and a log8 code pool, within 1e-4 of the plain
    version (the same f32 math summed in another order)."""
    rng = np.random.default_rng(11)
    args = _paged_case(rng, *QWEN3_MOE_PAGED, q_len, torch.float32, dev)
    kw = {}
    if pool == "log8":
        args, kw = _code_pools(args, "log8")
    before = paged_attention.launches
    out = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_ref(*args, **kw)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_and_logdomain_at_qwen3_moe_heads(dev, dtype):
    """Kernels F and C at (2, 32/4, 512, 128), the lockstep prefill of the
    MoE phase: F within 1e-4 (plus one bf16 step for bf16 outputs), C
    within one exp-grid LSB (1/255, plus one bf16 step)."""
    from repro_torch.kernels.dual_compute.ops import logdomain_flash_attention
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k, v = _attn_case(np.random.default_rng(12), 2, 32, 4, 512, 512, 128,
                         dtype, dev)
    slack = 0.0 if dtype == torch.float32 else 2.0 ** -7
    ref = flash_attention_ref(q, k, v)
    out = flash_attention(q, k, v)
    assert bool(((out.float() - ref).abs() <= 1e-4 + slack * ref.abs()).all())
    ref = logdomain_flash_ref(q, k, v)
    out = logdomain_flash_attention(q, k, v)
    assert bool(((out.float() - ref).abs()
                 <= 1.0 / 255 + slack * ref.abs()).all())


def _moe_trace(cfg, seed):
    from repro_torch.launch.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, int(rng.integers(5, 30)))), max_new_tokens=6,
        arrival=i) for i in range(5)]


@pytest.mark.parametrize("capacity", [0.0, 1.0], ids=["dropless", "drops"])
def test_moe_engines_on_card_match_cpu_plain_path(dev, capacity):
    """The reduced Qwen3-MoE (f32 activations) through ``PagedServeEngine``
    (kernel A on every layer) and ``ServeEngine`` on the card and on the
    CPU: equal greedy tokens and equal dropped-assignment counts, dropless
    and at a capacity that drops."""
    import dataclasses

    from repro_torch.launch.engine import PagedServeEngine, ServeEngine
    from repro_torch.models import lm
    cfg = get_config("qwen3_moe_30b_a3b", reduced=True)
    cfg = dataclasses.replace(cfg, activation_dtype=torch.float32,
                              moe=dataclasses.replace(
                                  cfg.moe, capacity_factor=capacity,
                                  min_capacity=2))
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(7),
                            device="cpu")
    reqs = _moe_trace(cfg, 13)
    for engine, kw in ((PagedServeEngine, dict(page_size=4)),
                       (ServeEngine, {})):
        out = {}
        for where in ("cpu", "cuda"):
            eng = engine(cfg, from_jax(_np(params), device=where),
                         max_slots=3, max_len=48, prefill_chunk=8,
                         decode_block=2, device=where, **kw)
            out[where] = ({c.rid: c.tokens for c in eng.run(reqs)},
                          eng.moe_stats)
        assert out["cpu"] == out["cuda"], engine.__name__


@pytest.mark.parametrize("nldpe", ["OFF", "ON"])
def test_rwkv6_lockstep_on_card_matches_cpu(dev, nldpe):
    """The reduced RWKV6 (f32 activations) through the lockstep path, a
    2 x 150-token prefill (a full chunk and a short one) and 8 greedy
    tokens, card against CPU: last logits within 1e-4 (``OFF``) or 0.1
    (``ON``, the log-grid rule of tests/test_torch_rwkv6.py), equal
    tokens ``OFF``; the generate fn equals the per-token loop."""
    import dataclasses

    from repro_torch.core.engine import OFF, ON
    from repro_torch.launch.serve import (build_decode_step,
                                          build_generate_fn,
                                          build_prefill_step,
                                          python_loop_decode)
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("rwkv6_3b", reduced=True),
                              activation_dtype=torch.float32)
    mode = ON if nldpe == "ON" else OFF
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(8),
                            device="cpu")
    prompts = torch.tensor(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 150)), dtype=torch.int32)
    out = {}
    for where in ("cpu", "cuda"):
        p = lm.serving_params(from_jax(_np(params), device=where), cfg, mode)
        cache = lm.init_model_cache(cfg, 2, 160, device=where)
        last, cache = build_prefill_step(cfg, nldpe=mode)(
            p, cache, prompts.to(where))
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        spare = lm.clone_cache(cache)
        gen, _ = build_generate_fn(cfg, 8, nldpe=mode)(p, cache, tok, 150)
        loop, _ = python_loop_decode(build_decode_step(cfg, nldpe=mode), p,
                                     spare, tok, 150, 8)
        assert torch.equal(loop, gen.cpu())
        out[where] = (last.cpu(), gen.cpu())
    tol = 0.1 if nldpe == "ON" else 1e-4
    assert (out["cpu"][0] - out["cuda"][0]).abs().max().item() <= tol
    if nldpe == "OFF":
        assert torch.equal(out["cpu"][1], out["cuda"][1])


# ---------------------------------------------------------------------------
# head dim 256: PaliGemma (8/1 heads) and RecurrentGemma (16/1)
# ---------------------------------------------------------------------------

PALIGEMMA_PAGED = (4, 8, 1, 300, 72, 16, 256)    # b, hq, hkv, P, NB, ps, d


@pytest.mark.parametrize("q_len", [1, 2, 5, 64])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "log8"])
def test_paged_attention_head_dim_256_matches_plain(dev, pool, q_len):
    """Kernel A at PaliGemma's 8/1 heads of 256: decode (G*Q = 8, the
    decode instance with two float4s a lane) and G*Q of 16, 40 and 512
    (the chunk instance's 64-row tiles, 32 positions a stage), ragged
    lengths over a 72-page table with sentinels, f32/bf16/int8/log8
    pools: within 1e-4 of the plain version (the same f32 math summed in
    another order); a code pool gives the bits of an f32 pool holding its
    decoded values."""
    from repro_torch.core.quantization import kv_decode
    from repro_torch.kernels.paged_attention.ops import plan
    rng = np.random.default_rng(21)
    dtype = torch.bfloat16 if pool == "bfloat16" else torch.float32
    args = _paged_case(rng, *PALIGEMMA_PAGED, q_len, dtype, dev)
    kw = {}
    if pool in ("int8", "log8"):
        args, kw = _code_pools(args, pool)
    pl = plan(4, 1, 8 * q_len, 72, 16, 256, 2 if kw else
              (0 if pool == "float32" else 1))
    assert (pl.instance, pl.rows) == (("decode", 8) if q_len == 1
                                      else ("chunk", 64))
    before = paged_attention.launches
    out = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_ref(*args, **kw)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4
    if kw:
        fp = (args[0], kv_decode(args[1], kw["k_scale"], pool),
              kv_decode(args[2], kw["v_scale"], pool), *args[3:])
        assert torch.equal(paged_attention(*fp), out)


@pytest.mark.parametrize("route", ["unsplit", "split"])
@pytest.mark.parametrize("q_len", [1, 2, 9, 65])
def test_paged_attention_head_dim_256_tile_boundaries(dev, monkeypatch,
                                                      q_len, route):
    """D 256 at every stage boundary of its instances (the chunk's 32
    positions a stage, a decode block step of 32), lengths on and beside
    them, a page size of 5 that divides none, the position axis unsplit
    and split in 3: within 1e-4 of the plain version."""
    from repro_torch.kernels.paged_attention import ops
    monkeypatch.setattr(ops, "num_splits",
                        lambda units, steps: 1 if route == "unsplit" else 3)
    ps, nb = 5, 32
    lengths = _boundary_lengths(q_len, ps, nb * ps)
    b = len(lengths)
    rng = np.random.default_rng(q_len + 31)
    q = torch.tensor(rng.normal(size=(b, 8, q_len, 256)),
                     dtype=torch.float32, device=dev)
    kp, vp = (torch.tensor(rng.normal(size=(b * nb + 2, 1, ps, 256)),
                           dtype=torch.float32, device=dev)
              for _ in range(2))
    bt = torch.tensor(rng.permutation(b * nb + 2)[:b * nb].reshape(b, nb),
                      dtype=torch.int32, device=dev)
    bt[0, nb // 2] = b * nb + 2
    bt[-1, -1] = -1
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = paged_attention(q, kp, vp, bt, lengths)
    ref = paged_attention_ref(q, kp, vp, bt, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("q_len", [1, 64], ids=["decode", "chunk"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "log8"])
def test_paged_attention_head_dim_256_batch_invariance(dev, pool, q_len,
                                                       capsys):
    """``test_paged_attention_batch_invariance`` at PaliGemma's 8/1 heads
    of 256: a sequence's outputs are the same bits whatever it is batched
    with."""
    a, b = _invariance_launches(dev, pool, q_len, hq=8, hkv=1, d=256)
    with capsys.disabled():
        print(f"\n[kernel A batch invariance, D 256] {pool} q_len={q_len}: "
              f"max |diff| {(a - b).abs().max().item():.3e}")
    assert torch.equal(a, b)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "log8"])
def test_paged_attention_head_dim_256_chunk_row_invariance(dev, pool):
    """``test_paged_attention_chunk_row_invariance`` at 8/1 heads of 256:
    the splits of 4 stages of 32 start at the same absolute positions as
    2 of 64 do at the other head dims."""
    _chunk_row_invariance(dev, pool, 8, 1, 256)


def test_paged_attention_head_dim_256_plan_matches_the_kernel_layout(dev):
    """The wrapper's shared memory is the CUDA source's at D 256 for the
    two instances there (8-row decode, 64-row chunk), and the source has
    no 16-row decode or 128-row chunk instance at D 256."""
    from repro_torch.kernels.paged_attention import ops
    lib = ops._lib()
    for kind in (0, 1, 2):
        for rows in (8, 64):
            assert lib.paged_attention_smem_bytes(rows, 256, kind) == \
                ops.smem_bytes(rows, 256, kind) <= ops.SMEM_LIMIT
        for rows in (16, 128):
            assert lib.paged_attention_smem_bytes(rows, 256, kind) == 0


ATTN_256 = [(2, 4, 1, 37, 53, 256), (1, 8, 1, 1280, 1280, 256),
            (1, 16, 1, 2048, 2048, 256)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_256,
                         ids=["odd", "paligemma1280", "rgemma2048"])
def test_flash_attention_head_dim_256_matches_plain(dev, shape, dtype,
                                                    causal):
    """Kernel F's D 256 instance (four warps, 64 rows a block): 1e-4
    absolute against the plain version, plus one bf16 step for bf16
    outputs."""
    from repro_torch.kernels.flash_attention.ops import flash_attention, plan
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    assert plan(dtype, 256).rows == 64
    q, k, v = _attn_case(np.random.default_rng(22), *shape, dtype, dev)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.dtype == dtype
    ref = flash_attention_ref(q, k, v, causal)
    tol = 1e-4 + (0.0 if dtype == torch.float32 else 2.0 ** -7) * ref.abs()
    assert bool(((out.float() - ref).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_256 + [(1, 8, 1, 300, 300, 256),
                                               (2, 8, 1, 256, 256, 256)],
                         ids=["odd", "paligemma1280", "rgemma2048",
                              "resident300", "paligemma_fused256"])
def test_logdomain_flash_head_dim_256_matches_plain(dev, shape, dtype):
    """Kernel C at D 256: resident up to 352 keys, two-pass above; within
    one exp-grid LSB (1/255) of the plain version, plus one bf16 step for
    bf16 outputs; the quantize launch is ``log_quantize`` bit for bit."""
    from repro_torch.core.logdomain import inv_sqrt, log_quantize
    from repro_torch.kernels.dual_compute.ops import (
        log_quantize_qkv, logdomain_flash_attention, logdomain_plan)
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    lk = shape[4]
    assert logdomain_plan(lk, 256).instance == (
        "resident" if lk <= 352 else "two_pass")
    q, k, v = _attn_case(np.random.default_rng(23), *shape, dtype, dev)
    f32 = [t.float() for t in (q, k, v)]
    got = log_quantize_qkv(q, k, v)
    assert all(torch.equal(g, w) for g, w in zip(got, (
        log_quantize(f32[0] * inv_sqrt(256)), log_quantize(f32[1]),
        log_quantize(f32[2]))))
    out = logdomain_flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = logdomain_flash_ref(q, k, v)
    slack = 0.0 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((out.float() - ref).abs()
                 <= 1.0 / 255 + slack * ref.abs()).all())


def test_logdomain_flash_head_dim_256_plan_matches_the_kernel_layout(dev):
    """Kernel C's shared-memory and scratch formulas at D 256, byte for
    byte the CUDA source's, for both instances."""
    from repro_torch.kernels.dual_compute import ops
    lib = ops._ld_lib()
    for lk in (1, 256, 352, 353, 1280, 2048, 40000):
        for i, name in enumerate(ops.LD_INSTANCES):
            try:
                pl = ops.logdomain_plan(lk, 256, name)
            except ValueError:
                assert name == "resident" and lk > 352
                continue
            assert lib.logdomain_flash_smem_bytes(i, 256, lk) == pl.smem


class _ShardAt:
    """A mesh as kernel A's and B's per-shard launches read it: axis
    sizes and this shard's coordinates."""

    def __init__(self, dp, tp, d, m):
        self.shape = {"data": dp, "model": tp}
        self.coords = {"data": d, "model": m}


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("q_len", [1, 5, 64], ids=["decode", "verify",
                                                   "chunk"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", [(8, 16, 2, 512, 64, 16, 128),
                                   (8, 40, 8, 512, 64, 16, 128)],
                         ids=["qwen3b", "llama4scout"])
def test_paged_attention_per_shard_is_the_unsharded_slice(dev, shape, pool,
                                                          q_len, mesh):
    """Kernel A launched once per shard on each shard's cut of the
    operands at ``shard_specs``'s placement (its heads, its sequences,
    every page) equals the unsharded call's slice bit for bit: ``plan``
    reads neither the batch nor the kv head count.  Where the mesh's
    "model" does not divide the kv heads the shards replicate them."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention_sharded, shard_specs)
    from repro_torch.parallel.sharding import serve_exact_rules
    rng = np.random.default_rng(5)
    dtype = torch.bfloat16 if pool == "bfloat16" else torch.float32
    args = _paged_case(rng, *shape, q_len, dtype, dev)
    kw = {}
    if pool == "int8":
        args, kw = _code_pools(args, "int8")
    full = paged_attention(*args, **kw)
    rules = serve_exact_rules()
    dp, tp = mesh
    before = paged_attention.launches
    for d in range(dp):
        for m in range(tp):
            at = _ShardAt(dp, tp, d, m)
            sp = shard_specs(shape[0], shape[1], shape[2], at, rules)
            local = [sp[name].local(t, at).contiguous() for t, name in
                     zip(args, ("q", "pool", "pool", "table", "table"))]
            got = paged_attention_sharded(
                *local, at, rules, n_heads=shape[1], n_kv_heads=shape[2],
                **{k: (v if k == "kv_quant" else
                       sp["pool"].local(v, at).contiguous())
                   for k, v in kw.items()})
            assert torch.equal(got, sp["q"].local(full, at)), (d, m)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + dp * tp


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("m", [1, 8, 512])
def test_fused_crossbar_acam_per_column_shard(dev, m, tp):
    """Kernel B on each column shard of the gate, programmed against the
    whole weight's largest magnitude, equals the unsharded call's columns
    bit for bit (no ACAM code flips): every tile sums an output as one
    fmaf chain in k order."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(m, 2048)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.normal(size=(2048, 11008)) * 2048 ** -0.5,
                     dtype=torch.float32, device=dev)
    full = fused_linear_acam(x, w, "silu")
    w_max = torch.amax(torch.abs(w))
    n = w.shape[1] // tp
    for i in range(tp):
        cols = slice(i * n, (i + 1) * n)
        got = fused_linear_acam(x, w[:, cols].contiguous(), "silu",
                                w_max=w_max)
        assert torch.equal(got, full[:, cols]), i


def _mesh_train_rank(steps, device):
    """One rank of the reduced ``qwen2_5_3b`` step under ``train`` at (1,
    2), both ranks on the one card (gloo with CUDA tensors): ``steps``
    AdamW steps from ``_train_setup``'s masters and batch; the losses,
    grad norms and the gathered parameters, on the host."""
    from repro_torch.core.drift import flatten
    from repro_torch.core.naf import unflatten
    from repro_torch.launch.mesh import serve_mesh
    from repro_torch.launch.train import build_train_step
    from repro_torch.nn.module import gather_tree, shard_tree
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _, (p, batch) = _train_setup("cpu", device)
    mesh = serve_mesh(1, 2, device)
    step = build_train_step(cfg, adamw.AdamWConfig(lr=1e-3), mesh=mesh,
                            rules="train")
    p = shard_tree(p, step.specs, mesh)
    p = unflatten(p, [v.clone() for _, v in flatten(p)])
    opt = adamw.init(p)
    out = []
    for _ in range(steps):
        p, opt, m = step(p, opt, batch)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    full = gather_tree(p, step.specs, mesh)
    return out, {"/".join(k): v.cpu().numpy() for k, v in flatten(full)}


def test_mesh_train_step_on_card_matches_single_device(dev, monkeypatch):
    """The (1, 2) ``train`` step on 2 ranks sharing the card (heads, FFN
    columns and vocab split over "model", partial sums all-reduced in
    float32) against the single-device step on the card, two steps of
    reduced ``qwen2_5_3b`` at float32: the losses and grad norms within
    rel 1e-5, the parameters within 0.1 lr where the single-device
    gradient reaches 1e-6 (tests/test_torch_mesh_train.py's tolerances),
    every rank alike."""
    from repro_torch.core.drift import flatten
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.train import build_train_step
    from repro_torch.optim import adamw
    steps, lr = 2, 1e-3
    cfg, _, (p, batch) = _train_setup("cpu", dev)
    step = build_train_step(cfg, adamw.AdamWConfig(lr=lr))
    update, seen = adamw.update, {}

    def keep(c, grads, state, params, **kw):
        seen["grads"] = grads
        return update(c, grads, state, params, **kw)
    monkeypatch.setattr(adamw, "update", keep)
    opt, want = adamw.init(p), []
    for _ in range(steps):
        p, opt, m = step(p, opt, batch)
        want.append((m["loss"].item(), m["grad_norm"].item()))
    live = {"/".join(k): g.abs().cpu().numpy() >= 1e-6
            for k, g in flatten(seen["grads"])}
    want_p = {"/".join(k): v.cpu().numpy() for k, v in flatten(p)}
    for got, params in run_ranks(_mesh_train_rank, 2, (steps,),
                                 device="cuda"):
        for (gl, gn), (wl, wn) in zip(got, want):
            assert gl == pytest.approx(wl, rel=1e-5)
            assert gn == pytest.approx(wn, rel=1e-5)
        for k, w in want_p.items():
            diff = np.abs(params[k] - w)[live[k]]
            assert diff.size == 0 or diff.max() <= 0.1 * lr, k

"""The port's 8-bit quantized KV caches (int8 and log8 grids, DESIGN.md §11)
held against ``repro`` on the CPU.

* The grid: ``kv_decode`` on all 255 codes against ``jax.jit`` of
  ``repro``'s — int8 bitwise; log8's exp argument bitwise (``jit``
  contracts ``|c| * step + log_lo`` into one FMA, which eager ``repro``
  does not: 90 of 255 codes differ between the two) and its values within
  1 ulp (``exp`` rounds apart between XLA and PyTorch).
* The encode: ``_quantize_kv`` against ``jax.jit`` of ``repro``'s, scales
  and codes bitwise (``jit`` divides ``absmax / 127`` as ``absmax *
  f32(1/127)``, which differs from an exact division on 169 of 4096
  scales of the tensor below).
* The log8 error contract on the port alone.
* Cache writes (lockstep, slotted, paged; masked slots and out-of-range
  writes) against ``repro``'s ``update_cache`` under ``jit``, bitwise.
* Kernel A's plain version over int8 and log8 pools against ``repro``'s
  oracle and its Pallas kernel in interpret mode.
* The engines with ``kv_quant`` (and with a config naming the grid)
  against ``repro``'s on the harness's reduced model at float32
  activations: equal greedy tokens; paged == slotted inside the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
from repro.core.engine import NLDPEConfig as JNLDPEConfig
from repro.core.quantization import KV_LOG_SPEC as J_KV_LOG_SPEC
from repro.core.quantization import kv_decode as j_kv_decode
from repro.kernels.paged_attention.ops import paged_attention as j_paged
from repro.launch import serve as j_serve
from repro.launch.engine import PagedServeEngine as JPagedServeEngine
from repro.launch.engine import ServeEngine as JServeEngine
from repro.models import lm as j_lm
from repro.nn import attention as j_attn

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import FUSED, OFF
from repro_torch.core.quantization import (KV_LOG8_FLUSH, KV_LOG8_REL_ERR,
                                           KV_LOG_SPEC, kv_decode,
                                           kv_log_arg, kv_table)
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.launch import serve
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.models import lm
from repro_torch.nn import attention as attn

torch.set_num_threads(1)

MODES = ("int8", "log8")
CFG32 = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                            activation_dtype=torch.float32)
J_CFG32 = dataclasses.replace(H.CFG, activation_dtype=jnp.float32)
J_FUSED = JNLDPEConfig(enabled=True, fused_dual_compute=True)
PAGED_TOL = dict(rtol=1e-5, atol=1e-5)   # as tests/test_torch_kernels.py


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place (same-sign values)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _port_requests(reqs):
    return [Request(rid=r.rid, tokens=r.tokens,
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, top_k=r.top_k, seed=r.seed,
                    arrival=r.arrival) for r in reqs]


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

def test_kv_log_spec_matches_repro():
    assert (KV_LOG_SPEC.log_lo, KV_LOG_SPEC.log_hi, KV_LOG_SPEC.bits) == (
        J_KV_LOG_SPEC.log_lo, J_KV_LOG_SPEC.log_hi, J_KV_LOG_SPEC.bits)
    from repro.core import quantization as jq
    assert KV_LOG8_REL_ERR == jq.KV_LOG8_REL_ERR
    assert KV_LOG8_FLUSH == jq.KV_LOG8_FLUSH


@pytest.mark.parametrize("mode", MODES)
def test_kv_decode_all_codes_match_repro_jit(mode, capsys):
    """All 255 codes, bare and each row of 17 under its own scale: the
    scale is one float32 multiply of the bare value in both packages."""
    codes = np.arange(-127, 128, dtype=np.int8).reshape(15, 17)
    scale = np.random.default_rng(0).uniform(1e-3, 4.0, 15).astype(
        np.float32)
    j_dec = jax.jit(lambda c, s: j_kv_decode(c, s, mode))
    j_bare = jax.jit(lambda c: j_kv_decode(c, None, mode))
    ref = np.asarray(j_bare(jnp.asarray(codes)))
    ref_scaled = np.asarray(j_dec(jnp.asarray(codes), jnp.asarray(scale)))
    mine = kv_decode(torch.from_numpy(codes), None, mode).numpy()
    mine_scaled = kv_decode(torch.from_numpy(codes), torch.from_numpy(scale),
                            mode).numpy()
    np.testing.assert_array_equal(ref_scaled, ref * scale[:, None])
    np.testing.assert_array_equal(mine_scaled, mine * scale[:, None])
    if mode == "int8":
        np.testing.assert_array_equal(mine, ref)
        np.testing.assert_array_equal(mine_scaled, ref_scaled)
        return
    # the exp argument, bitwise against the jitted (FMA) expression
    arg = np.asarray(jax.jit(
        lambda c: jnp.abs(c.astype(jnp.float32)) * J_KV_LOG_SPEC.step
        + J_KV_LOG_SPEC.log_lo)(jnp.asarray(codes)))
    np.testing.assert_array_equal(
        kv_log_arg(torch.from_numpy(codes)).numpy(), arg)
    ulps = _ulps(mine, ref)
    with capsys.disabled():
        print(f"\n[kv log8 decode] {int((ulps > 0).sum())} of 255 values "
              f"1 ulp from repro under jit")
    assert ulps.max() <= 1
    assert (np.sign(mine) == np.sign(codes)).all()


@pytest.mark.parametrize("mode", MODES)
def test_kv_table_is_the_plain_decode(mode):
    """The kernel's decode table, built once per (mode, device) and cached:
    table[code + 128] * scale is kv_decode bit for bit."""
    tab = kv_table(mode, "cpu")
    assert kv_table(mode, "cpu") is tab and tab.shape == (256,)
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(-128, 128, (64, 16)).astype(
        np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 2.0, 64).astype(np.float32))
    via = tab[codes.long() + 128] * scale[:, None]
    assert torch.equal(via, kv_decode(codes, scale, mode))


@pytest.mark.parametrize("mode", MODES)
def test_quantize_kv_matches_repro_jit(mode):
    """Scales and codes bitwise against ``jax.jit(_quantize_kv)`` on a
    4 x 2 x 512 x 128 normal tensor (an eager ``absmax / 127`` in the port
    would differ from ``jit``'s reciprocal on 169 of its 4096 scales)."""
    x = np.random.default_rng(0).normal(size=(4, 2, 512, 128)).astype(
        np.float32)
    jq, js = jax.jit(lambda a: j_attn._quantize_kv(a, mode))(jnp.asarray(x))
    q, s = attn._quantize_kv(torch.from_numpy(x), mode)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_quantize_kv_bf16_input_matches_repro_jit():
    """bf16 K/V (the configs' activations) are widened before the grid."""
    x = np.random.default_rng(2).normal(size=(2, 2, 16, 32)).astype(
        np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for mode in MODES:
        jq, js = jax.jit(lambda a: j_attn._quantize_kv(a, mode))(
            jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
        q, s = attn._quantize_kv(xb, mode)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_log8_error_contract():
    """|decode(encode(x)) - x| <= max(KV_LOG8_REL_ERR * |x|,
    KV_LOG8_FLUSH * absmax), sub-flush magnitudes exactly 0 (mirror of
    tests/test_engine_differential.py's contract test, on the port)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 2, 8, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [0.0, 1e-7, -1e-6, 1e-5]
    q, s = attn._quantize_kv(torch.from_numpy(x), "log8")
    xr = kv_decode(q, s, "log8").numpy()
    err = np.abs(xr - x)
    bound = np.maximum(KV_LOG8_REL_ERR * np.abs(x),
                       KV_LOG8_FLUSH * s.numpy()[..., None])
    assert (err <= bound * (1 + 1e-5)).all(), float((err / bound).max())
    assert (xr[0, 0, 0, :4] == 0).all()


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------

B, HKV, D, LEN = 3, 2, 16, 10
SPEC = j_attn.AttnSpec(d_model=32, n_heads=4, n_kv_heads=HKV, head_dim=D)


def _port_cache(mode, slotted=False, paged=None):
    s = attn.AttnSpec(n_heads=4, n_kv_heads=HKV, head_dim=D, kv_quant=mode)
    if paged is None:
        c = attn.init_cache(s, B, LEN, layers=1, slotted=slotted,
                            device="cpu")
    else:
        num_pages, ps = paged
        c = attn.kv_leaves((1, num_pages, HKV, ps, D), torch.float32, mode,
                           "cpu")
        c["pos"] = torch.full((B, LEN), -1, dtype=torch.int32)
        c["bt"] = torch.full((B, -(-LEN // ps)), num_pages,
                             dtype=torch.int32)
    return lm.layer_cache(c, 0)


def _kv(rng, c):
    return [torch.from_numpy(rng.normal(size=(B, HKV, c, D)).astype(
        np.float32)) for _ in range(2)]


def _same(port: dict, ref: dict):
    assert sorted(port) == sorted(ref)
    for name, leaf in ref.items():
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(leaf),
                                      err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_lockstep_cache_writes_match_repro(mode):
    """Decode steps (one shared position, wrapping the ring) and the
    whole-prompt prefill fill (a prompt longer than the ring keeps its last
    LEN positions) against ``repro``'s jitted writes."""
    rng = np.random.default_rng(3)
    port = _port_cache(mode)
    ref = j_attn.init_cache(SPEC, B, LEN, quantized=True)
    upd = jax.jit(lambda c, k, v, p: j_attn.update_cache(c, k, v, p,
                                                         kv_quant=mode))
    for p in (0, 1, 4, 9, 10, 13):
        k, v = _kv(rng, 1)
        attn.update_cache(port, k, v,
                          attn.write_plan(port, torch.tensor(p)), mode)
        ref = upd(ref, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                  jnp.int32(p))
    _same(port, ref)
    # prefill of 13 positions into a fresh ring of 10
    port = _port_cache(mode)
    k, v = _kv(rng, 13)
    attn.update_cache(port, k, v, attn.write_plan(
        port, torch.arange(13, dtype=torch.int32)), mode)
    ref = j_attn.init_cache(SPEC, B, LEN, quantized=True)
    take = np.arange(3, 13)
    qk, sk = jax.jit(lambda a: j_attn._quantize_kv(a, mode))(
        jnp.asarray(k.numpy()[:, :, take]))
    qv, sv = jax.jit(lambda a: j_attn._quantize_kv(a, mode))(
        jnp.asarray(v.numpy()[:, :, take]))
    line = take % LEN
    want = {name: np.asarray(leaf).copy() for name, leaf in ref.items()}
    want["k"][:, :, line] = np.asarray(qk)
    want["v"][:, :, line] = np.asarray(qv)
    want["k_scale"][:, :, line] = np.asarray(sk)
    want["v_scale"][:, :, line] = np.asarray(sv)
    want["pos"][line] = take
    _same(port, want)


@pytest.mark.parametrize("mode", MODES)
def test_slotted_cache_writes_match_repro(mode):
    """Per-slot chunks of 3 at different offsets (one wrapping), with a
    masked slot that must keep its lines bit for bit."""
    rng = np.random.default_rng(4)
    port = _port_cache(mode, slotted=True)
    ref = j_attn.init_cache(SPEC, B, LEN, quantized=True, slotted=True)
    upd = jax.jit(lambda c, k, v, p, m: j_attn.update_cache(
        c, k, v, p, write_mask=m, kv_quant=mode))
    for base, mask in (((0, 2, 5), (True, True, True)),
                       ((3, 5, 8), (True, False, True)),
                       ((6, 8, 11), (False, True, True))):
        pos = np.asarray(base, np.int32)[:, None] + np.arange(3,
                                                              dtype=np.int32)
        m = np.asarray(mask)
        k, v = _kv(rng, 3)
        attn.update_cache(port, k, v, attn.write_plan(
            port, torch.from_numpy(pos), torch.from_numpy(m)), mode)
        ref = upd(ref, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                  jnp.asarray(pos), jnp.asarray(m))
    _same(port, ref)


@pytest.mark.parametrize("mode", MODES)
def test_paged_cache_writes_match_repro(mode):
    """Chunks through a block table (page size 4, odd placement), with a
    masked slot and positions at or past max_len, which are dropped."""
    rng = np.random.default_rng(5)
    num_pages, ps = 9, 4
    port = _port_cache(mode, paged=(num_pages, ps))
    ref = j_attn.init_paged_cache(SPEC, B, LEN, num_pages=num_pages,
                                  page_size=ps, quantized=True)
    bt = np.asarray([[4, 0, 7], [2, 8, 5], [1, 6, 3]], np.int32)
    port["bt"].copy_(torch.from_numpy(bt))
    ref = dict(ref, bt=jnp.asarray(bt))
    upd = jax.jit(lambda c, k, v, p, m: j_attn.update_cache(
        c, k, v, p, write_mask=m, kv_quant=mode))
    for base, mask in (((0, 3, 6), (True, True, True)),
                       ((3, 6, 9), (True, False, True)),
                       ((6, 8, 12), (True, True, True))):
        pos = np.asarray(base, np.int32)[:, None] + np.arange(3,
                                                              dtype=np.int32)
        m = np.asarray(mask)
        k, v = _kv(rng, 3)
        attn.update_cache(port, k, v, attn.write_plan(
            port, torch.from_numpy(pos), torch.from_numpy(m)), mode)
        ref = upd(ref, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                  jnp.asarray(pos), jnp.asarray(m))
    _same(port, ref)
    # the paged dense view gathers codes and scales as repro's does
    view = attn.paged_dense_view(port)
    assert view["k_scale"].shape == (B, HKV, LEN)
    _same(view, jax.jit(j_attn.paged_dense_view)(ref))


# ---------------------------------------------------------------------------
# kernel A's plain version over code pools
# ---------------------------------------------------------------------------

def _quant_paged_case(seed, mode, q_len, b=3, hq=4, hkv=2, p=12, nb=4, ps=5,
                      d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, q_len, d)).astype(np.float32)
    pools = []
    for _ in range(2):
        x = rng.normal(size=(p, hkv, ps, d)).astype(np.float32)
        codes, scale = attn._quantize_kv(torch.from_numpy(x), mode)
        pools += [codes.numpy(), scale.numpy()]
    bt = rng.permutation(p)[:b * nb].reshape(b, nb).astype(np.int32)
    bt[0, -1] = p                   # unmapped sentinel
    bt[1, 2] = -1                   # negative sentinel mid-table
    lengths = rng.integers(ps + 1, nb * ps - q_len + 2, b).astype(np.int32)
    kc, ks, vc, vs = pools
    return q, kc, vc, bt, lengths, ks, vs


@pytest.mark.parametrize("q_len", [1, 3, 7])
@pytest.mark.parametrize("mode", MODES)
def test_plain_paged_attention_code_pools_match_repro(mode, q_len):
    q, kc, vc, bt, lengths, ks, vs = _quant_paged_case(q_len, mode, q_len)
    before = paged_attention.launches
    mine = paged_attention(*(torch.from_numpy(a) for a in
                             (q, kc, vc, bt, lengths)),
                           k_scale=torch.from_numpy(ks),
                           v_scale=torch.from_numpy(vs), kv_quant=mode)
    assert paged_attention.launches == before      # CPU: the plain version
    args = [jnp.asarray(a) for a in (q, kc, vc, bt, lengths)]
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
              kv_quant=mode)
    ref = j_paged(*args, **kw, use_ref=True)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **PAGED_TOL)
    pallas = j_paged(*args, **kw, interpret=True)
    np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), **PAGED_TOL)


def test_scales_without_mode_mean_int8():
    q, kc, vc, bt, lengths, ks, vs = _quant_paged_case(0, "int8", 2)
    t = [torch.from_numpy(a) for a in (q, kc, vc, bt, lengths, ks, vs)]
    a = paged_attention(*t[:5], k_scale=t[5], v_scale=t[6])
    b = paged_attention(*t[:5], k_scale=t[5], v_scale=t[6], kv_quant="int8")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="k_scale"):
        paged_attention(*t[:5], kv_quant="log8")


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

_ENGINES = {}


def _engines(mode, fused=False):
    """(repro paged, repro slotted, port paged, port slotted) on the
    harness settings at float32 activations, built once per (mode, fused)."""
    key = (mode, fused)
    if key not in _ENGINES:
        jn = J_FUSED if fused else JNLDPEConfig()
        kw = H.engine_kwargs()
        pkw = dict(page_size=H.PAGE, num_pages=H.NUM_PAGES)
        params = from_jax(H.shared_params(), device="cpu")
        nldpe = FUSED if fused else OFF
        _ENGINES[key] = (
            JPagedServeEngine(J_CFG32, H.shared_params(), nldpe=jn,
                              kv_quant=mode, **kw, **pkw),
            None if fused else JServeEngine(J_CFG32, H.shared_params(),
                                            kv_quant=mode, **kw),
            PagedServeEngine(CFG32, params, nldpe=nldpe, kv_quant=mode,
                             device="cpu", **kw, **pkw),
            None if fused else ServeEngine(CFG32, params, kv_quant=mode,
                                           device="cpu", **kw))
    return _ENGINES[key]


def _run(eng, trace):
    port = isinstance(eng, ServeEngine)
    reqs = H.to_requests(trace, eng.tick)
    comps = eng.run(_port_requests(reqs) if port else reqs)
    assert sorted(c.rid for c in comps) == list(range(len(trace)))
    return {c.rid: c.tokens for c in comps}


@pytest.mark.parametrize("mode", MODES)
def test_engines_match_repro_and_paged_equals_slotted(mode):
    """Greedy tokens of the COW/eviction trace and a tiny-alphabet trace:
    the port's paged engine (kernel A's plain version over the code pools)
    equals ``repro``'s paged engine and the port's slotted engine bitwise;
    the slotted engines agree too."""
    j_paged_eng, j_slotted, paged, slotted = _engines(mode)
    assert paged.cache["k"].dtype == torch.int8
    assert paged.cache["k_scale"].shape == paged.cache["k"].shape[:-1]
    for trace in (H.shared_prefix_cow_trace(seed=19),
                  H.random_greedy_trace(np.random.default_rng(2))):
        mine = _run(paged, trace)
        assert mine == _run(slotted, trace)
        assert mine == _run(j_paged_eng, trace) == _run(j_slotted, trace)
    for k in ("hits", "prefill_tokens_saved", "evicted", "cow_forks"):
        assert paged.stats[k] == j_paged_eng.stats[k], k
    assert paged.stats["cow_forks"] > 0
    H.audit(j_paged_eng)
    paged.pool.check()
    assert paged.pool.available() == paged.pool.num_pages


def test_fused_log8_pool_matches_repro():
    """FUSED over a log8 pool attends through ``_nldpe_cached`` over the
    decoded dense view: ``repro``'s tokens at float32 activations."""
    j_eng, _, eng, _ = _engines("log8", fused=True)
    trace = H.shared_prefix_cow_trace(seed=21)[:3]
    assert _run(eng, trace) == _run(j_eng, trace)


def test_kv_quant_ctor_rewrites_config_and_validates():
    """``kv_quant=`` is ``dataclasses.replace(cfg, kv_cache_dtype=...)``:
    both engines carry the effective grid (mirror of
    tests/test_paged_engine.py's ctor test)."""
    params = from_jax(H.shared_params(), device="cpu")
    kw = dict(max_slots=1, max_len=8, device="cpu")
    for eng in (ServeEngine(CFG32, params, kv_quant="log8", **kw),
                PagedServeEngine(CFG32, params, kv_quant="log8",
                                 page_size=4, **kw)):
        assert eng.kv_quant == "log8"
        assert eng.cfg.kv_cache_dtype == "log8"
        assert eng.cache["k"].dtype == torch.int8
        assert "k_scale" in eng.cache and "v_scale" in eng.cache
    assert ServeEngine(CFG32, params, **kw).kv_quant is None
    for bad in ("fp4", "bf16"):
        with pytest.raises(ValueError, match="kv_quant"):
            ServeEngine(CFG32, params, kv_quant=bad, **kw)
        with pytest.raises(ValueError, match="kv_quant"):
            PagedServeEngine(CFG32, params, kv_quant=bad, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_config_kv_cache_dtype_serves_quantized_pools(mode):
    """A config whose ``kv_cache_dtype`` names a grid, and no ctor
    argument: 8-bit pools, as ``repro`` serves them (it used to serve fp
    pools without a word)."""
    params = from_jax(H.shared_params(), device="cpu")
    cfg = dataclasses.replace(CFG32, kv_cache_dtype=mode)
    kw = dict(max_slots=2, max_len=8, device="cpu")
    for eng in (ServeEngine(cfg, params, **kw),
                PagedServeEngine(cfg, params, page_size=4, **kw)):
        assert eng.kv_quant == mode
        assert eng.cache["k"].dtype == torch.int8
        assert eng.cache["k_scale"].dtype == torch.float32
    assert lm.attn_spec(cfg).kv_quant == mode
    cache = lm.init_model_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, 8)
    paged = PagedServeEngine(cfg, params, page_size=4, **kw)
    assert paged._fp == PagedServeEngine(CFG32, params, page_size=4,
                                         kv_quant=mode, **kw)._fp


def test_radix_roots_are_keyed_on_the_grid():
    """fp, int8 and log8 pools store different bytes for the same prompt:
    three distinct radix roots (mirror of
    tests/test_engine_differential.py's root test)."""
    params = from_jax(H.shared_params(), device="cpu")
    fps = {mode: PagedServeEngine(CFG32, params, max_slots=1, max_len=8,
                                  page_size=4, kv_quant=mode,
                                  device="cpu")._fp
           for mode in (None, "log8", "int8")}
    assert len(set(fps.values())) == 3, fps


def test_lockstep_log8_matches_repro_and_loop():
    """A log8 config on the lockstep path: whole-prompt prefill (kernel F's
    plain version over fresh fp K/V, then a quantized fill), then greedy
    decode over the quantized ring.  The generate fn and the per-token
    loop give the same tokens, and those are ``repro``'s."""
    b, plen, gen, max_len = 2, 11, 6, 20
    cfg = dataclasses.replace(CFG32, kv_cache_dtype="log8")
    j_cfg = dataclasses.replace(J_CFG32, kv_cache_dtype="log8")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                                (b, plen)).astype(np.int32)
    cache = j_lm.init_model_cache(j_cfg, b, max_len, dtype=jnp.float32)
    last, cache = jax.jit(j_serve.build_prefill_step(j_cfg))(
        H.shared_params(), cache, jnp.asarray(prompts))
    tok0 = jnp.argmax(last, axis=-1).astype(jnp.int32)
    ref, _ = j_serve.build_generate_fn(j_cfg, gen)(
        H.shared_params(), cache, tok0, jnp.int32(plen))

    params = lm.serving_params(from_jax(H.shared_params(), device="cpu"),
                               cfg)
    out = []
    for loop in (False, True):
        cache = lm.init_model_cache(cfg, b, max_len, device="cpu")
        assert cache["k"].dtype == torch.int8
        mine, cache = serve.build_prefill_step(cfg)(
            params, cache, torch.from_numpy(prompts))
        np.testing.assert_allclose(mine.numpy(), np.asarray(last), rtol=0,
                                   atol=1e-5)
        tok = torch.argmax(mine, dim=-1).to(torch.int32)
        if loop:
            toks, _ = serve.python_loop_decode(serve.build_decode_step(cfg),
                                               params, cache, tok, plen, gen)
        else:
            toks, _ = serve.build_generate_fn(cfg, gen)(params, cache, tok,
                                                        plen)
        out.append(toks)
    assert torch.equal(out[0], out[1])
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref))


def test_cpu_path_launches_no_kernel(capsys):
    """On the CPU the quantized paths take the plain versions: the kernel
    counters stay where they were.  The CLI serves ``--kv-quant``."""
    before = (paged_attention.launches, dict(paged_attention.pool_launches))
    comps = serve.run(["--paged", "--kv-quant", "log8", "--device", "cpu",
                       "--requests", "3", "--gen-len", "4",
                       "--prompt-len", "20"])
    assert len(comps) == 3 and all(c.tokens for c in comps)
    assert "kv_quant=log8" in capsys.readouterr().out
    assert (paged_attention.launches,
            dict(paged_attention.pool_launches)) == before


def test_cli_kv_quant_requires_paged():
    with pytest.raises(SystemExit):
        serve.run(["--kv-quant", "int8", "--device", "cpu"])

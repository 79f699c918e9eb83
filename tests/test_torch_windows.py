"""Sliding-window attention, ring caches and Gemma3's local:global pattern
in the port, held against ``repro`` on the CPU.

Weights come from ``repro``'s ``lm.init_params`` through
``convert.from_jax``; inputs are drawn with numpy from fixed seeds.  Every
comparison runs at float32 activations, with these tolerances:

* ``ATTN_TOL`` 1e-5 absolute on attention outputs of unit-normal inputs
  (float32 sums in another order; measured up to 7.2e-7);
* ``LOGIT_TOL`` 1e-5 absolute on ``OFF`` logits of the reduced models
  (measured up to 7.6e-7);
* ``NLDPE_TOL`` 1e-5 absolute on the windowed NL-DPE attention routes
  fed the same q, k, v (the port follows ``jit``'s rounding, so no 8-bit
  log-grid code flips; measured up to 2.1e-6);
* ``NLDPE_FLIP_TOL`` 3e-2 on ``ON``/``FUSED`` logits of the reduced model,
  with equal argmax wherever the top-2 margin exceeds twice that: float32
  ulps apart upstream (rope, matmuls) move a few 8-bit codes by one LSB,
  which the log-grid rule of ``ROADMAP.md`` C allows (measured up to
  1.2e-2);
* bitwise for the validity masks, the rings' position tracks and the
  greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.engine import NLDPEConfig as JNLDPEConfig
from repro.launch import serve as j_serve
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JServeEngine
from repro.models import lm as j_lm
from repro.nn import attention as JA
from repro.nn.module import param_dtype

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import FUSED, OFF, ON
from repro_torch.launch import serve
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.models import lm
from repro_torch.nn import attention as A

torch.set_num_threads(1)

ATTN_TOL = 1e-5
LOGIT_TOL = 1e-5
NLDPE_TOL = 1e-5
NLDPE_FLIP_TOL = 3e-2
RNG_SEED = 7

CFG = dataclasses.replace(get_config("gemma3_27b", reduced=True),
                          activation_dtype=torch.float32)
J_CFG = dataclasses.replace(j_get_config("gemma3_27b", reduced=True),
                            activation_dtype=jnp.float32)
J_FUSED = JNLDPEConfig(enabled=True, fused_dual_compute=True)
J_ON = JNLDPEConfig(enabled=True)

_STATE = {}


def j_params():
    if "params" not in _STATE:
        with param_dtype(jnp.float32):
            _STATE["params"] = j_lm.init_params(jax.random.key(1), J_CFG)
    return _STATE["params"]


def params():
    return from_jax(j_params(), device="cpu")


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _qkv(rng, b, hq, hkv, s, d):
    return _normal(rng, (b, hq, s, d)), _normal(rng, (b, hkv, s, d)), \
        _normal(rng, (b, hkv, s, d))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [None, 5.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("seq,window,q_block", [(128, 24, 16), (37, 8, 16),
                                                (64, 64, 512)])
def test_banded_attention_matches_repro(seq, window, q_block, softcap):
    """The band over the port's ragged query blocks against ``repro``'s
    (which halves its block to divide S: 1 row at S = 37) and against its
    windowed ``_sdpa`` oracle (mirrors tests/test_nn_components.py:48)."""
    rng = np.random.default_rng(RNG_SEED)
    q, k, v = _qkv(rng, 1, 4, 2, seq, 8)
    mine = A.banded_attention(*_t(q, k, v), window=window, q_block=q_block,
                              softcap=softcap).numpy()
    ref = JA.banded_attention(*_j(q, k, v), window=window, q_block=q_block,
                              softcap=softcap)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=0, atol=ATTN_TOL)
    pos = jnp.arange(seq)
    mask = JA._mask(pos, pos, causal=True, window=window, prefix_len=None)
    oracle = JA._sdpa(jnp.asarray(q).reshape(1, 2, 2, seq, 8), *_j(k, v),
                      mask[None, None, None], softcap=softcap)
    np.testing.assert_allclose(mine, np.asarray(oracle).reshape(q.shape),
                               rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("softcap", [None, 5.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("window", [None, 6, 24])
def test_blockwise_attention_window_matches_repro(window, softcap):
    rng = np.random.default_rng(RNG_SEED + 1)
    q, k, v = _qkv(rng, 2, 4, 2, 64, 16)
    mine = A.blockwise_attention(*_t(q, k, v), window=window,
                                 softcap=softcap, q_block=16, k_block=16)
    ref = JA.blockwise_attention(*_j(q, k, v), window=window,
                                 softcap=softcap, q_block=16, k_block=16)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=ATTN_TOL)
    if window is not None and softcap is None:
        band = A.banded_attention(*_t(q, k, v), window=window, q_block=16)
        np.testing.assert_allclose(band.numpy(), mine.numpy(), rtol=0,
                                   atol=ATTN_TOL)


@pytest.mark.parametrize("window", [None, 1, 5])
def test_cache_valid_mask_matches_repro_bitwise(window):
    rng = np.random.default_rng(RNG_SEED + 2)
    kp = rng.integers(-1, 20, (3, 11)).astype(np.int32)
    for q_pos in (np.int32(12), rng.integers(0, 20, (4,)).astype(np.int32),
                  rng.integers(0, 20, (3, 4)).astype(np.int32)):
        for k_pos in (kp, kp[0]):
            mine = A.cache_valid_mask(torch.from_numpy(k_pos),
                                      torch.as_tensor(q_pos), window)
            ref = JA.cache_valid_mask(jnp.asarray(k_pos), jnp.asarray(q_pos),
                                      window)
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_project_qkv_with_qk_norm_matches_repro():
    """Per-head RMS norm of q and k (random scales) before rope."""
    rng = np.random.default_rng(RNG_SEED + 3)
    js = JA.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                     qk_norm=True, rope_theta=1e6)
    jp = JA.attn_init(jax.random.key(3), js)
    jp["q_norm"]["scale"] = jnp.asarray(1 + 0.1 * _normal(rng, (8,)))
    jp["k_norm"]["scale"] = jnp.asarray(1 + 0.1 * _normal(rng, (8,)))
    x = _normal(rng, (2, 5, 32))
    pos = np.arange(3, 8, dtype=np.int32)
    ref = JA._project_qkv(jp, js, jnp.asarray(x), jnp.asarray(pos))
    spec = A.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=True,
                      rope_theta=1e6)
    mine = A._project_qkv(from_jax(jp, device="cpu"), spec,
                          torch.from_numpy(x), torch.from_numpy(pos))
    for m, r in zip(mine, ref):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)


def test_ring_decode_matches_unbounded_cache_and_repro():
    """A window-8 ring of 8 lines against an unbounded 64-line cache with
    the window mask, 20 decode steps (mirrors tests/test_nn_components.py:
    56), and the ring's outputs and position track against ``repro``'s."""
    rng = np.random.default_rng(RNG_SEED + 4)
    spec = A.AttnSpec(n_heads=2, n_kv_heads=2, head_dim=8, window=8)
    js = JA.AttnSpec(d_model=16, n_heads=2, n_kv_heads=2, head_dim=8,
                     window=8)
    ring = A.init_cache(spec, 1, 64, layers=1, device="cpu")
    full = A.init_cache(dataclasses.replace(spec, window=None), 1, 64,
                        layers=1, device="cpu")
    assert ring["k"].shape[-2] == 8 and full["k"].shape[-2] == 64
    j_ring = JA.init_cache(js, batch=1, max_len=64, dtype=jnp.float32)
    for t in range(20):
        kt, vt, qt = (_normal(rng, (1, 2, 1, 8)) for _ in range(3))
        pos = torch.tensor(t, dtype=torch.int32)
        outs = []
        for c in (ring, full):
            view = lm.layer_cache(c, 0)
            A.update_cache(view, *_t(kt, vt), A.write_plan(view, pos))
            outs.append(A.cached_attention(torch.from_numpy(qt), view, pos,
                                           spec).numpy())
        j_ring = JA.update_cache(j_ring, *_j(kt, vt), jnp.int32(t))
        ref = JA.decode_attention(jnp.asarray(qt), j_ring, jnp.int32(t), js)
        np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=ATTN_TOL)
        np.testing.assert_allclose(outs[0], np.asarray(ref), rtol=0,
                                   atol=ATTN_TOL)
        np.testing.assert_array_equal(ring["pos"].numpy(),
                                      np.asarray(j_ring["pos"]))


def test_windowed_prefill_at_head_dim_256_takes_kernel_f_or_the_band(
        monkeypatch):
    """At head dim 256 a windowed prefill no longer than its window takes
    kernel F (exact there: every causal pair lies in the window) where
    ``repro`` takes its windowed ``blockwise_attention``, a longer one the
    band, which never reaches F; both give ``repro``'s attention."""
    calls = []
    plain = A.flash_attention

    def flash(*a, **k):
        calls.append(a[0].shape[2])
        return plain(*a, **k)

    monkeypatch.setattr(A, "flash_attention", flash)
    rng = np.random.default_rng(RNG_SEED + 5)
    js = JA.AttnSpec(d_model=32, n_heads=2, n_kv_heads=1, head_dim=256,
                     window=12)
    jp = JA.attn_init(jax.random.key(5), js)
    spec = A.AttnSpec(n_heads=2, n_kv_heads=1, head_dim=256, window=12)
    for seq in (12, 20):
        x = _normal(rng, (1, seq, 32))
        pos = np.arange(seq, dtype=np.int32)
        ref, _ = JA.attn_apply(jp, js, jnp.asarray(x),
                               positions=jnp.asarray(pos), mode="prefill")
        mine = A.attn_apply(from_jax(jp, device="cpu"), spec,
                            torch.from_numpy(x),
                            positions=torch.from_numpy(pos), mode="prefill")
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATTN_TOL)
    assert calls == [12]


# ---------------------------------------------------------------------------
# the reduced Gemma3 model
# ---------------------------------------------------------------------------

def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def test_gemma3_tree_and_cache_layout():
    """8 layers = one group of (5 local, 1 global) + a 2-local tail; the
    cache's full-length stack holds the global layer, the ring stack the 7
    local ones."""
    p = params()
    assert sorted(p["groups"]) == [f"b{i}" for i in range(6)]
    assert sorted(p["tail"]) == ["b0", "b1"]
    assert "q_norm" in p["groups"]["b5"]["attn"]
    assert [t for t, *_ in lm.layer_order(CFG)] == ["local"] * 5 + \
        ["global", "local", "local"]
    assert lm.cache_slots(CFG) == [("ring", i) for i in range(5)] + \
        [("full", 0), ("ring", 5), ("ring", 6)]
    cache = lm.init_model_cache(CFG, 2, 64, slotted=True, ring_slack=7,
                                device="cpu")
    assert tuple(cache["k"].shape) == (1, 2, 2, 64, 16)
    assert tuple(cache["ring"]["k"].shape) == (7, 2, 2, 23, 16)
    assert tuple(cache["ring"]["pos"].shape) == (2, 23)
    assert lm.attn_spec(CFG, "global").rope_theta == 1e6
    assert lm.attn_spec(CFG, "local").window == 16


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_gemma3_forward_matches_repro(mode):
    """Reduced Gemma3, 2 x 40 tokens (past the window of 16: the band, and
    a prefill that fills only the last 16 positions of each ring)."""
    toks = _tokens(0, (2, 40))
    j_cache = (j_lm.init_model_cache(J_CFG, 2, 64, dtype=jnp.float32)
               if mode == "prefill" else None)
    ref, j_cache = j_lm.forward(j_params(), jnp.asarray(toks), J_CFG,
                                mode=mode, cache=j_cache)
    cache = (lm.init_model_cache(CFG, 2, 64, device="cpu")
             if mode == "prefill" else None)
    mine = lm.forward(params(), torch.from_numpy(toks), CFG, mode=mode,
                      cache=cache)
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=LOGIT_TOL)
    if mode == "prefill":
        np.testing.assert_array_equal(
            cache["ring"]["pos"].numpy(),
            np.asarray(j_cache["groups"]["b0"]["attn"]["pos"][0]))
        assert sorted(cache["ring"]["pos"].tolist()) == list(range(24, 40))
        np.testing.assert_array_equal(
            cache["pos"].numpy(),
            np.asarray(j_cache["groups"]["b5"]["attn"]["pos"][0]))


def test_gemma3_embed_scale_rounds_to_bf16_first():
    """At bf16 activations the scale is bf16(sqrt(d)) (73.5 at d = 5376),
    as ``jnp.asarray(d ** 0.5, x.dtype)`` gives."""
    full = get_config("gemma3_27b")
    scale = torch.tensor(full.d_model ** 0.5, dtype=torch.bfloat16)
    assert float(scale) == 73.5
    assert float(jnp.asarray(full.d_model ** 0.5, jnp.bfloat16)) == 73.5
    cfg = get_config("gemma3_27b", reduced=True)      # bf16 activations
    toks = _tokens(1, (1, 6))
    ref, _ = j_lm.forward(j_params(), jnp.asarray(toks),
                          j_get_config("gemma3_27b", reduced=True),
                          mode="train")
    mine = lm.forward(params(), torch.from_numpy(toks), cfg, mode="train")
    # bf16 activations: one bf16 rounding apart moves a logit by ~1e-2
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=5e-2)


def test_gemma3_decode_matches_forward_and_repro():
    """12 decode steps against the whole-sequence forward (mirrors
    tests/test_models.py:61: rtol 1e-3, atol 2e-3 there; 1e-5 here) and
    against ``repro``'s decode steps; the window of 16 wraps each 16-line
    ring of the lockstep cache after 16 steps, so the run goes on to 20."""
    toks = _tokens(2, (2, 20))
    full = lm.forward(params(), torch.from_numpy(toks), CFG, mode="train")
    cache = lm.init_model_cache(CFG, 2, 24, device="cpu")
    j_cache = j_lm.init_model_cache(J_CFG, 2, 24, dtype=jnp.float32)
    p = params()
    for t in range(20):
        lg = lm.decode_step(p, CFG, torch.from_numpy(toks[:, t]), t, cache)
        ref, j_cache = j_lm.decode_step(j_params(), J_CFG,
                                        jnp.asarray(toks[:, t]),
                                        jnp.int32(t), j_cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].detach().numpy(),
                                   rtol=0, atol=LOGIT_TOL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref), rtol=0,
                                   atol=LOGIT_TOL)
    assert cache["ring"]["k"].shape[-2] == 16


def _margin(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _nldpe_close(mine: np.ndarray, ref: np.ndarray) -> None:
    """``ON``/``FUSED`` logits under ROADMAP.md C's log-grid rule: within
    ``NLDPE_FLIP_TOL``, with the same argmax wherever ``repro``'s top-2
    margin exceeds twice that."""
    np.testing.assert_allclose(mine, ref, rtol=0, atol=NLDPE_FLIP_TOL)
    clear = _margin(ref) > 2 * NLDPE_FLIP_TOL
    np.testing.assert_array_equal(mine.argmax(-1)[clear],
                                  ref.argmax(-1)[clear])


@pytest.mark.parametrize("fused", [False, True], ids=["OFF", "FUSED"])
def test_gemma3_lockstep_tokens_match_repro(fused):
    """Lockstep prefill of 2 x 36 tokens and 10 greedy tokens through
    ``launch/serve.py``'s steps against ``repro``'s jitted ones: ``OFF``
    tokens equal; ``FUSED`` logits under the log-grid rule and tokens
    equal up to a near-tie (``repro``'s top-2 margin below twice
    ``NLDPE_FLIP_TOL`` where they first differ)."""
    prompts = _tokens(3, (2, 36))
    jn = J_FUSED if fused else JNLDPEConfig()
    j_cache = j_lm.init_model_cache(J_CFG, 2, 48, dtype=jnp.float32)
    last, j_cache = jax.jit(j_serve.build_prefill_step(J_CFG, nldpe=jn))(
        j_params(), j_cache, jnp.asarray(prompts))
    tok0 = jnp.argmax(last, axis=-1).astype(jnp.int32)
    ref, _ = j_serve.build_generate_fn(J_CFG, 10, nldpe=jn)(
        j_params(), j_cache, tok0, jnp.int32(36))
    nldpe = FUSED if fused else OFF
    p = lm.serving_params(params(), CFG, nldpe)
    cache = lm.init_model_cache(CFG, 2, 48, device="cpu")
    mine, cache = serve.build_prefill_step(CFG, nldpe=nldpe)(
        p, cache, torch.from_numpy(prompts))
    tokens, _ = serve.build_generate_fn(CFG, 10, nldpe=nldpe)(
        p, cache, torch.argmax(mine, dim=-1).to(torch.int32), 36)
    if not fused:
        np.testing.assert_allclose(mine.numpy(), np.asarray(last), rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
        return
    _nldpe_close(mine.numpy(), np.asarray(last))
    for row, (a, b) in enumerate(zip(tokens.tolist(),
                                     np.asarray(ref).tolist())):
        if a != b:
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = np.concatenate([prompts[row], np.asarray(b[:i])])
            lg, _ = j_lm.forward(j_params(), jnp.asarray(seq[None]), J_CFG,
                                 mode="train", nldpe=J_ON)
            assert _margin(np.asarray(lg[0, -1])) < 2 * NLDPE_FLIP_TOL


@pytest.mark.parametrize("nldpe", ["ON", "FUSED"])
def test_gemma3_nldpe_logits_match_repro(nldpe):
    """``ON``/``FUSED`` prefill of 2 x 20 tokens (global layer: maskless,
    kernel C's plain version under FUSED; local layers: the materialized
    masked NL-DPE attention) and 4 decode steps through the window-masked
    ``_nldpe_cached``, against jitted ``repro`` at float32, under the
    log-grid rule: float32 ulps apart (the rope's cos/sin round 1 ulp
    apart from XLA's on ~29% of elements) move a few 8-bit codes."""
    mine_cfg, ref_cfg = (ON, J_ON) if nldpe == "ON" else (FUSED, J_FUSED)
    toks = _tokens(4, (2, 24))
    j_cache = j_lm.init_model_cache(J_CFG, 2, 32, dtype=jnp.float32)
    prefill = jax.jit(lambda p, t, c: j_lm.forward(
        p, t, J_CFG, mode="prefill", cache=c, nldpe=ref_cfg))
    decode = jax.jit(lambda p, t, pos, c: j_lm.decode_step(
        p, J_CFG, t, pos, c, nldpe=ref_cfg))
    ref, j_cache = prefill(j_params(), jnp.asarray(toks[:, :20]), j_cache)
    cache = lm.init_model_cache(CFG, 2, 32, device="cpu")
    p = lm.serving_params(params(), CFG, mine_cfg)
    _nldpe_close(lm.forward(p, torch.from_numpy(toks[:, :20]), CFG,
                            mode="prefill", cache=cache,
                            nldpe=mine_cfg).numpy(), np.asarray(ref))
    for t in range(20, 24):
        mine = lm.decode_step(p, CFG, torch.from_numpy(toks[:, t]), t,
                              cache, nldpe=mine_cfg)
        ref, j_cache = decode(j_params(), jnp.asarray(toks[:, t]),
                              jnp.int32(t), j_cache)
        _nldpe_close(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nldpe", ["ON", "FUSED"])
def test_windowed_nldpe_attention_matches_repro(nldpe):
    """The windowed NL-DPE routes on the same q, k, v (no rope ulps in
    between): the prefill's materialized masked attention (``repro``'s
    ``attn_apply`` lines 789-795) and 12 decode steps of ``_nldpe_cached``
    over a window-6 ring of 6 lines against ``repro``'s over its ring,
    within ``NLDPE_TOL``."""
    mine_cfg, ref_cfg = (ON, J_ON) if nldpe == "ON" else (FUSED, J_FUSED)
    rng = np.random.default_rng(RNG_SEED + 6)
    spec = A.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=8, window=6)
    js = JA.AttnSpec(d_model=16, n_heads=4, n_kv_heads=2, head_dim=8,
                     window=6)
    q, k, v = _qkv(rng, 2, 4, 2, 14, 8)
    pos = np.arange(14, dtype=np.int32)
    mine = A._prefill_attention(*_t(q, k, v), spec, torch.from_numpy(pos),
                                "prefill", mine_cfg)
    msk = JA._mask(jnp.asarray(pos)[None], jnp.asarray(pos)[None],
                   causal=True, window=6, prefix_len=None)
    ref = jax.jit(lambda q, k, v: ref_cfg.attention(
        q, jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1), causal=False,
        mask=msk[:, None]))(*_j(q, k, v))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=NLDPE_TOL)
    ring = A.init_cache(spec, 2, 32, layers=1, device="cpu")
    j_ring = JA.init_cache(js, batch=2, max_len=32, dtype=jnp.float32)
    cached = jax.jit(lambda q, att, valid: JA._nldpe_cached(
        ref_cfg, q, att, valid, js))
    for t in range(12):
        kt, vt, qt = (_normal(rng, (2, h, 1, 8)) for h in (2, 2, 4))
        view = lm.layer_cache(ring, 0)
        pt = torch.tensor(t, dtype=torch.int32)
        A.update_cache(view, *_t(kt, vt), A.write_plan(view, pt))
        mine = A._nldpe_cached(mine_cfg, torch.from_numpy(qt), view,
                               A.cache_valid_mask(view["pos"], pt, 6), spec)
        j_ring = JA.update_cache(j_ring, *_j(kt, vt), jnp.int32(t))
        ref = cached(jnp.asarray(qt), j_ring, JA.cache_valid_mask(
            j_ring["pos"], jnp.int32(t), 6))
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=NLDPE_TOL)


# ---------------------------------------------------------------------------
# ServeEngine over rings that wrap
# ---------------------------------------------------------------------------

def _wrap_trace(seed: int, n: int = 5):
    """Prompts of 2-3 windows (32-48 tokens at window 16) and 3-8 new
    tokens, staggered: every ring of 16 + 7 lines wraps in prefill, and
    chunks of 8 straddle the ring's end."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for i in range(n):
        t += int(rng.poisson(2))
        plen = int(rng.integers(32, 49))
        out.append((i, tuple(int(x) for x in rng.integers(
            0, CFG.vocab_size, plen)), int(rng.integers(3, 9)), t))
    return out


def _alone(p, prompt, gen):
    """The lockstep oracle inside the port: whole-prompt prefill (a 16-line
    ring per local layer) + the per-token loop, one request alone."""
    cache = lm.init_model_cache(CFG, 1, 64, device="cpu")
    last, cache = serve.build_prefill_step(CFG)(
        p, cache, torch.tensor([prompt], dtype=torch.int32))
    out, _ = serve.python_loop_decode(
        serve.build_decode_step(CFG), p, cache,
        torch.argmax(last, dim=-1).to(torch.int32), len(prompt), gen)
    return out[0].tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_serve_engine_wrapping_rings_matches_repro_and_run_alone(seed):
    """``ServeEngine`` (2 slots, prefill_chunk 8, rings of 16 + 7 lines)
    against ``repro``'s engine on the same trace and against each request
    run alone through the lockstep path (mirrors
    tests/test_serve_engine.py:255): equal greedy tokens."""
    kw = dict(max_slots=2, max_len=64, prefill_chunk=8, decode_block=2)
    trace = _wrap_trace(seed)
    ref_eng = JServeEngine(J_CFG, j_params(), **kw)
    ref = {c.rid: c.tokens for c in ref_eng.run(
        [JRequest(rid=r, tokens=t, max_new_tokens=g, arrival=a)
         for r, t, g, a in trace])}
    eng = ServeEngine(CFG, params(), device="cpu", **kw)
    assert eng.cache["ring"]["k"].shape[-2] == 16 + 8 - 1
    got = {c.rid: c.tokens for c in eng.run(
        [Request(rid=r, tokens=t, max_new_tokens=g, arrival=a)
         for r, t, g, a in trace])}
    assert got == ref
    p = lm.serving_params(params(), CFG)
    for rid, prompt, gen, _ in trace:
        assert got[rid] == _alone(p, prompt, gen), rid


def test_serve_engine_fused_matches_repro():
    """``FUSED`` through the engine: kernel B's plain version on every
    gate, the chunk's window-masked NL-DPE attention over the rings."""
    kw = dict(max_slots=2, max_len=48, prefill_chunk=8, decode_block=2)
    trace = _wrap_trace(5, n=2)
    ref_eng = JServeEngine(J_CFG, j_params(), nldpe=J_FUSED, **kw)
    ref = {c.rid: c.tokens for c in ref_eng.run(
        [JRequest(rid=r, tokens=t[:36], max_new_tokens=g, arrival=a)
         for r, t, g, a in trace])}
    eng = ServeEngine(CFG, params(), nldpe=FUSED, device="cpu", **kw)
    got = {c.rid: c.tokens for c in eng.run(
        [Request(rid=r, tokens=t[:36], max_new_tokens=g, arrival=a)
         for r, t, g, a in trace])}
    assert got == ref


# ---------------------------------------------------------------------------
# refusals and the overflow guard
# ---------------------------------------------------------------------------

def test_engines_refuse_like_repro():
    p = params()
    rec = dataclasses.replace(CFG, layer_pattern=("rec", "local"))
    with pytest.raises(NotImplementedError, match="attention-block"):
        ServeEngine(rec, p, max_slots=1, max_len=8, device="cpu")
    with pytest.raises(NotImplementedError, match="attention-block"):
        JServeEngine(dataclasses.replace(J_CFG, layer_pattern=("rec",)),
                     j_params(), max_slots=1, max_len=8)
    # "moe" blocks are attention blocks: both engines take them, as
    # repro's do
    moe = get_config("qwen3_moe_30b_a3b", reduced=True)
    mp = lm.init_params(moe, device="cpu")
    for eng in (ServeEngine, PagedServeEngine):
        assert eng(moe, mp, max_slots=1, max_len=8, device="cpu").moe_stats
    with pytest.raises(NotImplementedError, match="non-windowed"):
        PagedServeEngine(CFG, p, max_slots=1, max_len=8, device="cpu")
    with pytest.raises(NotImplementedError, match="non-windowed"):
        lm.init_model_cache(CFG, 1, 8, paged=(4, 4), device="cpu")


def test_overflow_guard_exempts_purely_windowed_stacks():
    """Gemma3 has a global layer, so generating past max_len raises, as in
    ``repro``; a purely windowed stack wraps its rings by design and is
    exempt."""
    p = lm.serving_params(params(), CFG)
    tok = torch.zeros((1,), dtype=torch.int32)
    cache = lm.init_model_cache(CFG, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="overflows the KV cache"):
        serve.build_generate_fn(CFG, 4)(p, cache, tok, 6)
    with pytest.raises(ValueError, match="overflows the KV cache"):
        j_serve.build_generate_fn(J_CFG, 4)(
            j_params(), j_lm.init_model_cache(J_CFG, 1, 8,
                                              dtype=jnp.float32),
            jnp.zeros((1,), jnp.int32), jnp.int32(6))
    local = dataclasses.replace(CFG, n_layers=2, layer_pattern=("local",))
    lp = {"embed": p["embed"], "final_norm": p["final_norm"],
          "groups": {"b0": {k: {n: t[:1].repeat(2, *[1] * (t.ndim - 1))
                                if torch.is_tensor(t) else
                                {m: u[:1].repeat(2, *[1] * (u.ndim - 1))
                                 for m, u in t.items()}
                                for n, t in v.items()}
                            for k, v in p["groups"]["b0"].items()}}}
    cache = lm.init_model_cache(local, 1, 8, device="cpu")
    assert "pos" not in cache and cache["ring"]["k"].shape[-2] == 8
    gen, _ = serve.build_generate_fn(local, 12)(lp, cache, tok, 6)
    assert tuple(gen.shape) == (1, 12)
    assert sorted(cache["ring"]["pos"].tolist()) == list(range(9, 17))


@pytest.mark.parametrize("seq", [37, 64])
def test_blockwise_attention_ragged_blocks_match_repro(seq):
    """At a length the blocks do not divide (37: ``repro`` halves its
    blocks of 16 to 1 row) the port keeps blocks of 16 with a ragged last
    one; each row's softmax is the same within ``ATTN_TOL``, and where the
    blocks divide S the arithmetic is ``repro``'s block for block."""
    rng = np.random.default_rng(RNG_SEED + 8)
    q, k, v = _qkv(rng, 1, 4, 2, seq, 8)
    for window in (None, 9):
        mine = A.blockwise_attention(*_t(q, k, v), window=window,
                                     q_block=16, k_block=16)
        ref = JA.blockwise_attention(*_j(q, k, v), window=window,
                                     q_block=16, k_block=16)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATTN_TOL)


def test_paged_softcap_attends_through_the_dense_view():
    """A softcapped layer over a paged cache attends through the gathered
    dense view with the cap (``repro``'s default route; kernel A has no
    cap), equal to the slotted cache's ``cached_attention``."""
    rng = np.random.default_rng(RNG_SEED + 9)
    spec = A.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=8, softcap=3.0)
    p = {"wq": torch.from_numpy(_normal(rng, (16, 4, 8))),
         "wk": torch.from_numpy(_normal(rng, (16, 2, 8))),
         "wv": torch.from_numpy(_normal(rng, (16, 2, 8))),
         "wo": torch.from_numpy(_normal(rng, (4, 8, 16)))}
    x = torch.from_numpy(_normal(rng, (2, 6, 16)))
    pos = torch.arange(6, dtype=torch.int32).repeat(2, 1)
    slotted = lm.layer_cache(A.init_cache(spec, 2, 8, layers=1,
                                          slotted=True, device="cpu"), 0)
    paged = {"k": torch.zeros((4, 2, 4, 8)), "v": torch.zeros((4, 2, 4, 8)),
             "pos": torch.full((2, 8), -1, dtype=torch.int32),
             "bt": torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)}
    out = [A.attn_apply(p, spec, x, positions=pos, mode="chunk", cache=c,
                        plan=A.write_plan(c, pos))
           for c in (slotted, paged)]
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), rtol=0,
                               atol=1e-6)

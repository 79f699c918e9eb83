"""The RWKV6 block and RWKV6-3B's reduced config in the port, held against
``repro`` on the CPU.

Weights come from ``repro``'s init through ``convert.from_jax``, inputs
from numpy seeds.  Tolerances:

* ``WKV_RTOL`` 1e-5 of the largest reference magnitude on
  ``timemix_apply`` and ``channelmix_apply`` outputs and states at
  float32: the chunk's decay logs are summed by ``cumsum`` in another
  order (XLA's differs from the sequential one in 42% of the entries), and
  the mid-chunk centred exponentials carry those ulps of arguments up to
  ~64 into every product; ``repro`` halves its chunk until it divides the
  length (one position a step at an odd length) where the port takes full
  chunks and a shorter last one, the same math in another grouping.
  Measured 2.8e-6 at S = 128 (2.2e-4 absolute on outputs up to 80; against a
  float64 step loop ``repro`` is 2.6e-4 off and the port 1.5e-4);
* ``LOGIT_TOL`` 5e-5 absolute on ``OFF`` logits of the reduced model
  (measured 2.4e-5 over 40 positions);
* ``BF16_TOL`` 0.1 with equal argmax on bf16 logits (one bf16 rounding
  apart per layer: ``repro`` casts weights per call; the port follows its
  dtype promotion of the float32 fresh state);
* ``NLDPE_FLIP_TOL`` 0.1 on ``ON`` logits, with equal argmax wherever
  the top-2 margin exceeds twice that: the log-grid rule of ``ROADMAP.md``
  C, wider than the attention models' 3e-2 because one LSB flip of the
  inner ACAM ``exp`` (a step of 0.029 on its 8-bit grid over [e^-8, e^2])
  moves a channel's decay by ~3% at every later position (measured 4.0e-2
  on 4 of 8704 logits, under 3e-2 on the rest);
* bitwise: greedy tokens against ``repro``'s lockstep path, the generate
  fn against the per-token loop, the converted tree.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.engine import NLDPEConfig as JNLDPEConfig
from repro.launch import serve as j_serve
from repro.launch.engine import PagedServeEngine as JPagedServeEngine
from repro.launch.engine import ServeEngine as JServeEngine
from repro.models import lm as j_lm
from repro.nn import rwkv6 as JW
from repro.nn.module import param_dtype

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import OFF, ON
from repro_torch.launch import serve
from repro_torch.launch.engine import PagedServeEngine, ServeEngine
from repro_torch.models import lm
from repro_torch.nn import rwkv6 as W

torch.set_num_threads(1)

WKV_RTOL = 1e-5
LOGIT_TOL = 5e-5
BF16_TOL = 0.1
NLDPE_FLIP_TOL = 0.1

ARCH = "rwkv6_3b"
CFG = dataclasses.replace(get_config(ARCH, reduced=True),
                          activation_dtype=torch.float32)
J_CFG = dataclasses.replace(j_get_config(ARCH, reduced=True),
                            activation_dtype=jnp.float32)
J_ON = JNLDPEConfig(enabled=True)
D = CFG.d_model

_STATE = {}


def j_params():
    if "params" not in _STATE:
        with param_dtype(jnp.float32):
            _STATE["params"] = jax.jit(partial(j_lm.init_params,
                                               cfg=J_CFG))(jax.random.key(6))
    return _STATE["params"]


def params():
    return from_jax(j_params(), device="cpu")


def _block(seed=0):
    jp = {"tm": JW.timemix_init(jax.random.key(seed), D),
          "cm": JW.channelmix_init(jax.random.key(seed + 1), D, 2 * D)}
    return jp, from_jax(jp, device="cpu")


def _normal(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _state(rng, b=2):
    return {"S": _normal(rng, (b, D // 64, 64, 64), 0.1),
            "x_last": _normal(rng, (b, D))}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _near(a, ref):
    """Within ``WKV_RTOL`` of the largest |ref|."""
    ref = np.asarray(ref)
    _close(a, ref, WKV_RTOL * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [128, 96, 37, 300])
@pytest.mark.parametrize("carried", [False, True])
def test_timemix_chunked_matches_repro(seq, carried):
    """The chunked time-mix from zeros and from a carried state: ``repro``
    takes one chunk of 128 or 96, 37 chunks of 1 at 37 and 75 chunks of 4
    at 300; the port 128-position chunks and a shorter last one."""
    jp, p = _block()
    rng = np.random.default_rng(seq)
    x = _normal(rng, (2, seq, D))
    st = _state(rng) if carried else None
    ref, ref_st = jax.jit(partial(JW.timemix_apply, mode="prefill"))(
        jp["tm"], jnp.asarray(x), None if st is None else
        {k: jnp.asarray(v) for k, v in st.items()})
    out, new_st = W.timemix_apply(p["tm"], torch.from_numpy(x),
                                  None if st is None else
                                  {k: torch.from_numpy(v)
                                   for k, v in st.items()}, mode="prefill")
    _near(out, ref)
    _near(new_st["S"], ref_st["S"])
    np.testing.assert_array_equal(new_st["x_last"].numpy(),
                                  np.asarray(ref_st["x_last"]))


def test_timemix_decode_step_matches_repro_and_chunked():
    """The decode step against ``repro``'s, and 12 steps from a carried
    state against the chunked pass over the same 12 positions."""
    jp, p = _block(2)
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 12, D))
    st = _state(rng)
    ref, ref_st = jax.jit(partial(JW.timemix_apply, mode="decode"))(
        jp["tm"], jnp.asarray(x[:, :1]),
        {k: jnp.asarray(v) for k, v in st.items()})
    t_st = {k: torch.from_numpy(v) for k, v in st.items()}
    out, new_st = W.timemix_apply(p["tm"], torch.from_numpy(x[:, :1]), t_st,
                                  mode="decode")
    _near(out, ref)
    _near(new_st["S"], ref_st["S"])
    full, full_st = W.timemix_apply(p["tm"], torch.from_numpy(x), t_st,
                                    mode="prefill", chunk=8)
    cur, ys = t_st, []
    for t in range(12):
        y, cur = W.timemix_apply(p["tm"], torch.from_numpy(x[:, t:t + 1]),
                                 cur, mode="decode")
        ys.append(y)
    _near(torch.cat(ys, 1), full)
    _near(cur["S"], full_st["S"])
    with pytest.raises(ValueError, match="one position"):
        W.timemix_apply(p["tm"], torch.from_numpy(x[:, :2]), t_st,
                        mode="decode")


@pytest.mark.parametrize("carried", [False, True])
def test_channelmix_matches_repro(carried):
    jp, p = _block(4)
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 9, D))
    last = _normal(rng, (2, D)) if carried else None
    ref, ref_last = JW.channelmix_apply(
        jp["cm"], jnp.asarray(x), None if last is None else jnp.asarray(last))
    out, new_last = W.channelmix_apply(
        p["cm"], torch.from_numpy(x),
        None if last is None else torch.from_numpy(last))
    _near(out, ref)
    np.testing.assert_array_equal(new_last.numpy(), np.asarray(ref_last))


def test_token_shift_promotes_like_repro():
    """A float32 carried row promotes a bf16 input's shift to float32 (the
    fresh state), as ``jnp.concatenate`` does; none keeps bf16."""
    x = torch.randn((1, 3, 8)).to(torch.bfloat16)
    assert W._token_shift(x).dtype == torch.bfloat16
    assert W._token_shift(x, torch.zeros((1, 8))).dtype == torch.float32
    ref = JW._token_shift(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          jnp.zeros((1, 8), jnp.float32))
    assert ref.dtype == jnp.float32


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def _margin(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def test_tree_and_cache_layout():
    p = params()
    assert sorted(p["groups"]["b0"]) == ["cm", "norm1", "norm2", "tm"]
    assert lm.cache_slots(CFG) == [("rwkv", 0), ("rwkv", 1)]
    cache = lm.init_model_cache(CFG, 2, 40, device="cpu")
    assert sorted(cache) == ["rwkv"]
    assert tuple(cache["rwkv"]["tm"]["S"].shape) == (2, 2, 2, 64, 64)
    assert tuple(cache["rwkv"]["tm"]["x_last"].shape) == (2, 2, D)
    assert tuple(cache["rwkv"]["cm_x"].shape) == (2, 2, D)
    assert lm.position_tracks(cache) == []
    with pytest.raises(NotImplementedError, match="non-windowed"):
        lm.init_model_cache(CFG, 1, 8, paged=(4, 4), device="cpu")


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches_repro(mode):
    """2 x 40 tokens; the prefill also fills the state stack."""
    toks = _tokens(0, (2, 40))
    j_cache = (j_lm.init_model_cache(J_CFG, 2, 48, dtype=jnp.float32)
               if mode == "prefill" else None)
    ref, j_cache = jax.jit(partial(j_lm.forward, cfg=J_CFG, mode=mode))(
        j_params(), jnp.asarray(toks), cache=j_cache)
    cache = (lm.init_model_cache(CFG, 2, 48, device="cpu")
             if mode == "prefill" else None)
    mine = lm.forward(params(), torch.from_numpy(toks), CFG, mode=mode,
                      cache=cache)
    _close(mine.detach().numpy(), ref, LOGIT_TOL)
    if mode == "prefill":
        for i in range(2):
            ref_st = j_cache["groups"]["b0"]
            _near(cache["rwkv"]["tm"]["S"][i], ref_st["tm"]["S"][i])
            # the last normed inputs: ulps apart, as the activations are
            _near(cache["rwkv"]["tm"]["x_last"][i], ref_st["tm"]["x_last"][i])
            _near(cache["rwkv"]["cm_x"][i], ref_st["cm_x"][i])


def test_decode_matches_forward_and_repro():
    """20 decode steps from the fresh state against the whole-sequence
    forward and against ``repro``'s decode steps."""
    toks = _tokens(1, (2, 20))
    p = params()
    full = lm.forward(p, torch.from_numpy(toks), CFG, mode="train")
    cache = lm.init_model_cache(CFG, 2, 24, device="cpu")
    j_cache = j_lm.init_model_cache(J_CFG, 2, 24, dtype=jnp.float32)
    decode = jax.jit(partial(j_lm.decode_step, cfg=J_CFG))
    for t in range(20):
        lg = lm.decode_step(p, CFG, torch.from_numpy(toks[:, t]), t, cache)
        ref, j_cache = decode(j_params(), token=jnp.asarray(toks[:, t]),
                              pos=jnp.int32(t), cache=j_cache)
        _close(lg.numpy(), full[:, t].detach().numpy(), LOGIT_TOL)
        _close(lg.numpy(), ref, LOGIT_TOL)


def test_bf16_prefill_and_decode_match_repro():
    """bf16 activations: the prefill reads the float32 fresh state (the
    lerps promote to float32, as in ``repro``), the decode steps the
    carried bf16 rows."""
    cfg = dataclasses.replace(CFG, activation_dtype=torch.bfloat16)
    j_cfg = dataclasses.replace(J_CFG, activation_dtype=jnp.bfloat16)
    toks = _tokens(2, (2, 20))
    j_cache = j_lm.init_model_cache(j_cfg, 2, 24, dtype=jnp.float32)
    ref, j_cache = jax.jit(partial(j_lm.forward, cfg=j_cfg, mode="prefill"))(
        j_params(), jnp.asarray(toks[:, :16]), cache=j_cache)
    sp = lm.serving_params(params(), cfg)
    cache = lm.init_model_cache(cfg, 2, 24, device="cpu")
    outs = [(lm.forward(sp, torch.from_numpy(toks[:, :16]), cfg,
                        mode="prefill", cache=cache).numpy(),
             np.asarray(ref))]
    decode = jax.jit(partial(j_lm.decode_step, cfg=j_cfg))
    for t in range(16, 20):
        ref, j_cache = decode(j_params(), token=jnp.asarray(toks[:, t]),
                              pos=jnp.int32(t), cache=j_cache)
        outs.append((lm.decode_step(sp, cfg, torch.from_numpy(toks[:, t]), t,
                                    cache).numpy(), np.asarray(ref)))
    for m, r in outs:
        _close(m, r, BF16_TOL)
        clear = _margin(r) > 2 * BF16_TOL
        np.testing.assert_array_equal(m.argmax(-1)[clear],
                                      r.argmax(-1)[clear])


def test_on_logits_match_repro():
    """``ON``: the lerps' and the gate's products through log-domain
    DMMul, the decay through two ACAM exp tables, ACAM silu, relu and
    sigmoid; a prefill and 3 decode steps against jitted ``repro``."""
    toks = _tokens(3, (2, 20))
    j_cache = j_lm.init_model_cache(J_CFG, 2, 24, dtype=jnp.float32)
    ref, j_cache = jax.jit(partial(j_lm.forward, cfg=J_CFG, mode="prefill",
                                   nldpe=J_ON))(
        j_params(), jnp.asarray(toks[:, :17]), cache=j_cache)
    cache = lm.init_model_cache(CFG, 2, 24, device="cpu")
    sp = lm.serving_params(params(), CFG, ON)
    outs = [(lm.forward(sp, torch.from_numpy(toks[:, :17]), CFG,
                        mode="prefill", cache=cache, nldpe=ON).numpy(),
             np.asarray(ref))]
    decode = jax.jit(partial(j_lm.decode_step, cfg=J_CFG, nldpe=J_ON))
    for t in range(17, 20):
        ref, j_cache = decode(j_params(), token=jnp.asarray(toks[:, t]),
                              pos=jnp.int32(t), cache=j_cache)
        outs.append((lm.decode_step(sp, CFG, torch.from_numpy(toks[:, t]), t,
                                    cache, nldpe=ON).numpy(),
                     np.asarray(ref)))
    for m, r in outs:
        _close(m, r, NLDPE_FLIP_TOL)
        clear = _margin(r) > 2 * NLDPE_FLIP_TOL
        np.testing.assert_array_equal(m.argmax(-1)[clear],
                                      r.argmax(-1)[clear])


def test_lockstep_tokens_match_repro_and_loop():
    """The lockstep path (2 x 24-token prompts, 10 greedy tokens) against
    ``repro``'s jitted steps; the generate fn against the per-token loop;
    no overflow guard (no full-length attention layer)."""
    prompts = _tokens(4, (2, 24))
    j_cache = j_lm.init_model_cache(J_CFG, 2, 32, dtype=jnp.float32)
    last, j_cache = jax.jit(j_serve.build_prefill_step(J_CFG))(
        j_params(), j_cache, jnp.asarray(prompts))
    ref, _ = j_serve.build_generate_fn(J_CFG, 10)(
        j_params(), j_cache, jnp.argmax(last, -1).astype(jnp.int32),
        jnp.int32(24))
    p = lm.serving_params(params(), CFG)
    cache = lm.init_model_cache(CFG, 2, 32, device="cpu")
    mine, cache = serve.build_prefill_step(CFG)(p, cache,
                                                torch.from_numpy(prompts))
    _close(mine.numpy(), last, LOGIT_TOL)
    tok = torch.argmax(mine, -1).to(torch.int32)
    spare = lm.clone_cache(cache)
    tokens, _ = serve.build_generate_fn(CFG, 10)(p, cache, tok, 24)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    loop, _ = serve.python_loop_decode(serve.build_decode_step(CFG), p,
                                       spare, tok, 24, 10)
    np.testing.assert_array_equal(loop.numpy(), tokens.numpy())
    # 40 steps past the 32-position cache: nothing wraps, nothing raises
    long, _ = serve.build_generate_fn(CFG, 40)(
        p, lm.init_model_cache(CFG, 2, 8, device="cpu"), tok, 24)
    assert tuple(long.shape) == (2, 40)


def test_engines_and_chunks_refuse_rwkv_like_repro():
    p = params()
    for eng in (ServeEngine, PagedServeEngine):
        with pytest.raises(NotImplementedError, match="attention-block"):
            eng(CFG, p, max_slots=1, max_len=8, device="cpu")
    for eng in (JServeEngine, JPagedServeEngine):
        with pytest.raises(NotImplementedError, match="attention-block"):
            eng(J_CFG, j_params(), max_slots=1, max_len=8)
    with pytest.raises(NotImplementedError, match="got 'rwkv'"):
        lm.forward(p, torch.zeros((1, 2), dtype=torch.int32), CFG,
                   mode="chunk", cache=lm.init_model_cache(CFG, 1, 8,
                                                           device="cpu"),
                   positions=torch.zeros((1, 2), dtype=torch.int32))


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_matches_repro(reduced):
    cfg, j_cfg = get_config(ARCH, reduced), j_get_config(ARCH, reduced)
    assert cfg.param_count() == j_cfg.param_count()
    assert cfg.active_param_count() == j_cfg.param_count()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def test_from_jax_carries_the_tree_leaf_for_leaf():
    """``repro``'s reduced tree lands leaf for leaf; the port's own
    ``init_params`` builds the same paths and shapes."""
    jp = j_params()
    mine, ref = _flat(from_jax(jp, device="cpu")), _flat(jp)
    assert list(mine) == list(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(mine[path].numpy(), np.asarray(leaf))
    own = _flat(lm.init_params(get_config(ARCH, reduced=True),
                               generator=torch.Generator().manual_seed(0),
                               device="cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(np.shape(v)) for k, v in ref.items()}
    assert float(own[("groups", "b0", "tm", "decay_base")].abs().max()) == 0


def test_serving_params_keep_the_decay_lora_float32():
    sp = lm.serving_params(params(), dataclasses.replace(
        CFG, activation_dtype=torch.bfloat16))["groups"]["b0"]
    for name in ("decay_base", "decay_A", "decay_B", "bonus_u"):
        assert sp["tm"][name].dtype == torch.float32, name
    for name in ("w_r", "w_o", "mu"):
        assert sp["tm"][name].dtype == torch.bfloat16, name
    assert sp["cm"]["w_k"].dtype == torch.bfloat16

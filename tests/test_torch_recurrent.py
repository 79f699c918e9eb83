"""The RG-LRU recurrent block and RecurrentGemma's hybrid pattern in the
port, held against ``repro`` on the CPU; ``convert.from_jax`` of the
reduced Gemma3 and RecurrentGemma trees.

Weights come from ``repro``'s init through ``convert.from_jax``, inputs
from numpy seeds, activations float32.  Tolerances:

* ``SCAN_TOL`` 1e-5 absolute: the port's ``rglru_scan`` against
  ``repro``'s and against its own step loop.  The port runs
  ``jax.lax.associative_scan``'s odd/even recursion itself (the same
  pairing of elements, so the same float32 operations in the same order);
  ``exp``, ``log1p`` and the gates' matmuls round apart by ulps (measured
  up to 2.4e-7 against ``repro`` and against the step loop);
* ``LOGIT_TOL`` 1e-5 absolute on ``OFF`` logits (measured up to 1.1e-6);
* ``NLDPE_FLIP_TOL`` 3e-2 on ``ON``/``FUSED`` logits, with equal argmax
  where the top-2 margin exceeds twice that (the log-grid rule of
  ``ROADMAP.md`` C; measured up to 5.7e-6 at these seeds, no code
  flipped);
* bitwise: ``_causal_conv`` and its state, the converted trees, greedy
  tokens.
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
from repro.models import lm as j_lm
from repro.nn import rglru as JR
from repro.nn.module import param_dtype

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import FUSED, OFF, ON
from repro_torch.launch import serve
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import lm
from repro_torch.nn import rglru as R

torch.set_num_threads(1)

SCAN_TOL = 1e-5
LOGIT_TOL = 1e-5
NLDPE_FLIP_TOL = 3e-2

CFG = dataclasses.replace(get_config("recurrentgemma_9b", reduced=True),
                          activation_dtype=torch.float32)
J_CFG = dataclasses.replace(j_get_config("recurrentgemma_9b", reduced=True),
                            activation_dtype=jnp.float32)
J_ON = JNLDPEConfig(enabled=True)
J_FUSED = JNLDPEConfig(enabled=True, fused_dual_compute=True)

_STATE = {}


def j_params():
    if "params" not in _STATE:
        with param_dtype(jnp.float32):
            _STATE["params"] = j_lm.init_params(jax.random.key(2), J_CFG)
    return _STATE["params"]


def params():
    return from_jax(j_params(), device="cpu")


def _normal(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _rglru(d, seed):
    jp = JR.rglru_init(jax.random.key(seed), d)
    return jp, from_jax(jp, device="cpu")


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 2, 7, 10, 33])
def test_rglru_scan_matches_repro_and_step_loop(seq):
    """Mirrors tests/test_nn_components.py:134 (the scan against the step
    loop, held there at 1e-4) and adds ``repro``'s scan; odd and even
    lengths take both branches of the recursion."""
    jp, p = _rglru(16, 0)
    x = _normal(np.random.default_rng(seq), (2, seq, 16))
    y_ref, h_ref = JR.rglru_scan(jp, jnp.asarray(x))
    y, h_last = R.rglru_scan(p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(h_ref), rtol=0,
                               atol=SCAN_TOL)
    h = torch.zeros((2, 16))
    ys = []
    for t in range(seq):
        y_t, h = R.rglru_step(p, torch.from_numpy(x[:, t:t + 1]), h)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(), rtol=0,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), h_last.numpy(), rtol=0,
                               atol=SCAN_TOL)


def test_rglru_carried_state_matches_repro():
    """A carried state enters as a virtual step 0 (mirrors
    tests/test_nn_components.py:151)."""
    jp, p = _rglru(8, 1)
    x = _normal(np.random.default_rng(3), (1, 12, 8))
    y_full, _ = R.rglru_scan(p, torch.from_numpy(x))
    y_a, h_a = R.rglru_scan(p, torch.from_numpy(x[:, :5]))
    y_b, h_b = R.rglru_scan(p, torch.from_numpy(x[:, 5:]), h0=h_a)
    np.testing.assert_allclose(torch.cat([y_a, y_b], 1).numpy(),
                               y_full.numpy(), rtol=0, atol=SCAN_TOL)
    jy_b, jh_b = JR.rglru_scan(jp, jnp.asarray(x[:, 5:]),
                               h0=jnp.asarray(h_a.numpy()))
    np.testing.assert_allclose(y_b.numpy(), np.asarray(jy_b), rtol=0,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(h_b.numpy(), np.asarray(jh_b), rtol=0,
                               atol=SCAN_TOL)


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        _normal(np.random.default_rng(4), (200,), 3.0)]
                       ).astype(np.float32)
    np.testing.assert_allclose(R.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2 ** -22, atol=0)


@pytest.mark.parametrize("seq", [1, 2, 9])
def test_causal_conv_with_state_is_bitwise(seq):
    rng = np.random.default_rng(5 + seq)
    w = _normal(rng, (4, 6), 0.1)
    x = _normal(rng, (2, seq, 6))
    for state in (None, _normal(rng, (2, 3, 6))):
        ref, ref_st = JR._causal_conv(jnp.asarray(w), jnp.asarray(x),
                                      None if state is None
                                      else jnp.asarray(state))
        out, st = R._causal_conv(torch.from_numpy(w), torch.from_numpy(x),
                                 None if state is None
                                 else torch.from_numpy(state))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(st.numpy(), np.asarray(ref_st))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_recurrent_block_matches_repro(mode):
    """``recurrent_block_apply``: the scan from zeros ("train", no state),
    from a carried state ("prefill") and one step ("decode")."""
    rng = np.random.default_rng(11)
    jp = JR.recurrent_block_init(jax.random.key(4), 32, 24)
    p = from_jax(jp, device="cpu")
    seq = 1 if mode == "decode" else 9
    x = _normal(rng, (2, seq, 32))
    state = None
    if mode != "train":
        state = {"h": _normal(rng, (2, 24)), "conv": _normal(rng, (2, 3, 24))}
    ref, ref_st = JR.recurrent_block_apply(
        jp, jnp.asarray(x), None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()}, mode=mode)
    out, st = R.recurrent_block_apply(
        p, torch.from_numpy(x), None if state is None else
        {k: torch.from_numpy(v) for k, v in state.items()}, mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(ref_st["h"]),
                               rtol=0, atol=SCAN_TOL)
    np.testing.assert_allclose(st["conv"].numpy(),
                               np.asarray(ref_st["conv"]), rtol=0,
                               atol=SCAN_TOL)


# ---------------------------------------------------------------------------
# the reduced RecurrentGemma model
# ---------------------------------------------------------------------------

def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def test_recurrentgemma_tree_and_cache_layout():
    p = params()
    assert sorted(p["groups"]) == ["b0", "b1", "b2"] and "tail" not in p
    assert "rec" in p["groups"]["b0"] and "attn" in p["groups"]["b2"]
    assert lm.cache_slots(CFG) == [("rec", 0), ("rec", 1), ("ring", 0)]
    cache = lm.init_model_cache(CFG, 2, 40, device="cpu")
    assert "pos" not in cache
    assert tuple(cache["ring"]["k"].shape) == (1, 2, 1, 16, 16)
    assert tuple(cache["rec"]["h"].shape) == (2, 2, 64)
    assert tuple(cache["rec"]["conv"].shape) == (2, 2, 3, 64)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_recurrentgemma_forward_matches_repro(mode):
    """2 x 40 tokens (past the window of 16: the band); the prefill also
    fills the recurrent state and the ring."""
    toks = _tokens(0, (2, 40))
    j_cache = (j_lm.init_model_cache(J_CFG, 2, 48, dtype=jnp.float32)
               if mode == "prefill" else None)
    ref, j_cache = j_lm.forward(j_params(), jnp.asarray(toks), J_CFG,
                                mode=mode, cache=j_cache)
    cache = (lm.init_model_cache(CFG, 2, 48, device="cpu")
             if mode == "prefill" else None)
    mine = lm.forward(params(), torch.from_numpy(toks), CFG, mode=mode,
                      cache=cache)
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=LOGIT_TOL)
    if mode == "prefill":
        for i in range(2):
            ref_st = j_cache["groups"][f"b{i}"]["rec"]
            np.testing.assert_allclose(cache["rec"]["h"][i].numpy(),
                                       np.asarray(ref_st["h"][0]), rtol=0,
                                       atol=SCAN_TOL)
            np.testing.assert_allclose(cache["rec"]["conv"][i].numpy(),
                                       np.asarray(ref_st["conv"][0]),
                                       rtol=0, atol=SCAN_TOL)
        np.testing.assert_array_equal(
            cache["ring"]["pos"].numpy(),
            np.asarray(j_cache["groups"]["b2"]["attn"]["pos"][0]))


def test_recurrentgemma_decode_matches_forward_and_repro():
    """20 decode steps (the 16-line ring wraps) against the whole-sequence
    forward and against ``repro``'s decode steps (mirrors
    tests/test_models.py:61)."""
    toks = _tokens(1, (2, 20))
    p = params()
    full = lm.forward(p, torch.from_numpy(toks), CFG, mode="train")
    cache = lm.init_model_cache(CFG, 2, 24, device="cpu")
    j_cache = j_lm.init_model_cache(J_CFG, 2, 24, dtype=jnp.float32)
    for t in range(20):
        lg = lm.decode_step(p, CFG, torch.from_numpy(toks[:, t]), t, cache)
        ref, j_cache = j_lm.decode_step(j_params(), J_CFG,
                                        jnp.asarray(toks[:, t]),
                                        jnp.int32(t), j_cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].detach().numpy(),
                                   rtol=0, atol=LOGIT_TOL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref), rtol=0,
                                   atol=LOGIT_TOL)


def _margin(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("nldpe", ["OFF", "FUSED"])
def test_recurrentgemma_lockstep_tokens_match_repro(nldpe):
    """The lockstep path (2 x 24-token prompts, past the window; 8 greedy
    tokens) against ``repro``'s jitted steps: ``OFF`` tokens equal,
    ``FUSED`` logits under the log-grid rule and tokens equal up to a
    near-tie."""
    fused = nldpe == "FUSED"
    prompts = _tokens(2, (2, 24))
    jn = J_FUSED if fused else JNLDPEConfig()
    j_cache = j_lm.init_model_cache(J_CFG, 2, 32, dtype=jnp.float32)
    last, j_cache = jax.jit(j_serve.build_prefill_step(J_CFG, nldpe=jn))(
        j_params(), j_cache, jnp.asarray(prompts))
    ref, _ = j_serve.build_generate_fn(J_CFG, 8, nldpe=jn)(
        j_params(), j_cache, jnp.argmax(last, -1).astype(jnp.int32),
        jnp.int32(24))
    mode = FUSED if fused else OFF
    p = lm.serving_params(params(), CFG, mode)
    cache = lm.init_model_cache(CFG, 2, 32, device="cpu")
    mine, cache = serve.build_prefill_step(CFG, nldpe=mode)(
        p, cache, torch.from_numpy(prompts))
    tokens, _ = serve.build_generate_fn(CFG, 8, nldpe=mode)(
        p, cache, torch.argmax(mine, -1).to(torch.int32), 24)
    if not fused:
        np.testing.assert_allclose(mine.numpy(), np.asarray(last), rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
        return
    np.testing.assert_allclose(mine.numpy(), np.asarray(last), rtol=0,
                               atol=NLDPE_FLIP_TOL)
    for row, (a, b) in enumerate(zip(tokens.tolist(),
                                     np.asarray(ref).tolist())):
        if a != b:
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = np.concatenate([prompts[row], np.asarray(b[:i])])
            lg, _ = j_lm.forward(j_params(), jnp.asarray(seq[None]), J_CFG,
                                 mode="train", nldpe=J_ON)
            assert _margin(np.asarray(lg[0, -1])) < 2 * NLDPE_FLIP_TOL


def test_recurrentgemma_on_logits_match_repro():
    """``ON``: the RG-LRU gates through ACAM sigmoids, the recurrence and
    gate products through log-domain DMMul, the block's gate through the
    ACAM gelu; whole sequence and 3 decode steps, under the log-grid
    rule."""
    toks = _tokens(3, (2, 20))
    j_cache = j_lm.init_model_cache(J_CFG, 2, 24, dtype=jnp.float32)
    ref, j_cache = jax.jit(lambda p, t, c: j_lm.forward(
        p, t, J_CFG, mode="prefill", cache=c, nldpe=J_ON))(
        j_params(), jnp.asarray(toks[:, :17]), j_cache)
    cache = lm.init_model_cache(CFG, 2, 24, device="cpu")
    p = lm.serving_params(params(), CFG, ON)
    mine = lm.forward(p, torch.from_numpy(toks[:, :17]), CFG, mode="prefill",
                      cache=cache, nldpe=ON)
    outs = [(mine.numpy(), np.asarray(ref))]
    decode = jax.jit(lambda p, t, pos, c: j_lm.decode_step(
        p, J_CFG, t, pos, c, nldpe=J_ON))
    for t in range(17, 20):
        lg = lm.decode_step(p, CFG, torch.from_numpy(toks[:, t]), t, cache,
                            nldpe=ON)
        ref, j_cache = decode(j_params(), jnp.asarray(toks[:, t]),
                              jnp.int32(t), j_cache)
        outs.append((lg.numpy(), np.asarray(ref)))
    for m, r in outs:
        np.testing.assert_allclose(m, r, rtol=0, atol=NLDPE_FLIP_TOL)
        clear = _margin(r) > 2 * NLDPE_FLIP_TOL
        np.testing.assert_array_equal(m.argmax(-1)[clear],
                                      r.argmax(-1)[clear])


def test_recurrent_blocks_refuse_chunks_and_engines():
    p = params()
    with pytest.raises(NotImplementedError, match="attention-block"):
        ServeEngine(CFG, p, max_slots=1, max_len=8, device="cpu")
    cache = lm.init_model_cache(CFG, 1, 8, slotted=True, device="cpu")
    with pytest.raises(NotImplementedError, match="got 'rec'"):
        lm.forward(p, torch.zeros((1, 2), dtype=torch.int32), CFG,
                   mode="chunk", cache=cache,
                   positions=torch.zeros((1, 2), dtype=torch.int32))


def test_overflow_guard_exempts_recurrentgemma():
    """RecurrentGemma has no full-length attention layer: the lockstep
    generate fn runs past max_len (its ring wraps by design), as
    ``repro``'s does."""
    p = lm.serving_params(params(), CFG)
    cache = lm.init_model_cache(CFG, 1, 8, device="cpu")
    tok = torch.zeros((1,), dtype=torch.int32)
    gen, _ = serve.build_generate_fn(CFG, 12)(p, cache, tok, 6)
    ref, _ = j_serve.build_generate_fn(J_CFG, 12)(
        j_params(), j_lm.init_model_cache(J_CFG, 1, 8, dtype=jnp.float32),
        jnp.zeros((1,), jnp.int32), jnp.int32(6))
    np.testing.assert_array_equal(gen.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# convert.from_jax
# ---------------------------------------------------------------------------

def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["gemma3_27b", "recurrentgemma_9b"])
def test_from_jax_carries_the_tree_leaf_for_leaf(arch):
    """Every leaf of ``repro``'s reduced tree (the stacked groups and the
    tail) lands under the same path with the same shape and bits, and the
    port's own ``init_params`` builds the same paths and shapes."""
    j_cfg = j_get_config(arch, reduced=True)
    with param_dtype(jnp.float32):
        jp = j_lm.init_params(jax.random.key(5), j_cfg)
    mine, ref = _flat(from_jax(jp, device="cpu")), _flat(jp)
    assert list(mine) == list(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(mine[path].numpy(), np.asarray(leaf))
        assert mine[path].dtype == torch.float32, path
    own = _flat(lm.init_params(get_config(arch, reduced=True),
                               generator=torch.Generator().manual_seed(0),
                               device="cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(np.shape(v)) for k, v in ref.items()}
    if arch == "gemma3_27b":
        assert ("tail", "b1", "attn", "k_norm", "scale") in ref

"""The port's model, held against ``repro``'s: the reduced Qwen2.5-3B
with ``repro``'s own seeded weights carried across by ``from_jax``.

Logits of a chunked prefill into a paged cache and of the decode step
after it, first at float32 activations (where only matmul sum order and
``exp``/``pow`` ulps differ), then at the bf16 default the engine serves
with (where a bf16 rounding of an intermediate can land one bf16 ulp
apart and propagate).
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
from repro.models import lm as j_lm
from repro.nn.module import param_dtype

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import FUSED, OFF, ON
from repro_torch.launch import sampling
from repro_torch.models import lm

torch.set_num_threads(1)

J_CFG = j_get_config("qwen2_5_3b", reduced=True)
CFG = get_config("qwen2_5_3b", reduced=True)
B, C, MAX_LEN, PAGE, PAGES = 2, 6, 16, 4, 9
J_FUSED = JNLDPEConfig(enabled=True, fused_dual_compute=True)
MODES = {"OFF": (OFF, JNLDPEConfig()), "ON": (ON, JNLDPEConfig(enabled=True)),
         "FUSED": (FUSED, J_FUSED)}

# float32 activations: f32 matmuls summed in another order, exp/pow ulps
# (measured: 4e-7 OFF, 3e-7 FUSED, logits of magnitude ~0.5)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 activations: a value rounds one bf16 ulp (2^-8 relative) apart now
# and then and propagates (measured: 6e-3 OFF); under FUSED such a shift
# can also move an ACAM or log-grid code by one step (measured: 2.1e-2
# ON, 1.5e-2 FUSED)
BF16_TOL = {"OFF": dict(rtol=0.02, atol=0.02),
            "ON": dict(rtol=0.1, atol=0.1), "FUSED": dict(rtol=0.1, atol=0.1)}


@pytest.fixture(scope="module")
def j_params():
    with param_dtype(jnp.float32):
        return j_lm.init_params(jax.random.key(0), J_CFG)


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG.vocab_size, (B, C)).astype(np.int32)
    base = np.array([0, 5], np.int32)             # slot 1 starts mid-page
    positions = base[:, None] + np.arange(C, dtype=np.int32)
    bt = np.array([[3, 1, 8, PAGES], [0, 6, 2, 4]], np.int32)
    nxt = rng.integers(0, CFG.vocab_size, (B,)).astype(np.int32)
    return tokens, positions, bt, nxt


def _repro(params, cfg, nldpe):
    tokens, positions, bt, nxt = _inputs()
    cache = j_lm.init_model_cache(cfg, B, MAX_LEN, dtype=jnp.float32,
                                  paged=(PAGES, PAGE))
    att = cache["groups"]["b0"]["attn"]
    att["bt"] = jnp.broadcast_to(jnp.asarray(bt), att["bt"].shape)
    # slot 1's prefix [0, 5) counts as already cached (a radix hit)
    pos = np.full((B, MAX_LEN), -1, np.int32)
    pos[1, :5] = np.arange(5)
    att["pos"] = jnp.broadcast_to(jnp.asarray(pos), att["pos"].shape)
    mask = jnp.ones((B,), bool)
    fwd = jax.jit(partial(j_lm.forward, cfg=cfg, mode="chunk", nldpe=nldpe))
    lg1, cache = fwd(params, jnp.asarray(tokens), cache=cache,
                     positions=jnp.asarray(positions), write_mask=mask)
    step = jax.jit(partial(j_lm.decode_step, cfg=cfg, nldpe=nldpe))
    lg2, _ = step(params, token=jnp.asarray(nxt),
                  pos=jnp.asarray(positions[:, -1] + 1), cache=cache,
                  write_mask=mask)
    return np.asarray(lg1), np.asarray(lg2)


def _port(params, cfg, nldpe):
    tokens, positions, bt, nxt = _inputs()
    p = lm.serving_params(from_jax(params, device="cpu"), cfg, nldpe)
    cache = lm.init_model_cache(cfg, B, MAX_LEN, paged=(PAGES, PAGE),
                                device="cpu")
    cache["bt"].copy_(torch.from_numpy(bt))
    cache["pos"][1, :5] = torch.arange(5, dtype=torch.int32)
    mask = torch.ones((B,), dtype=torch.bool)
    lg1 = lm.forward(p, torch.from_numpy(tokens), cfg,
                     cache=cache, positions=torch.from_numpy(positions),
                     nldpe=nldpe, write_mask=mask)
    lg2 = lm.decode_step(p, cfg, torch.from_numpy(nxt),
                         torch.from_numpy(positions[:, -1] + 1), cache,
                         nldpe=nldpe, write_mask=mask)
    return lg1.numpy(), lg2.numpy()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_logits_match_repro(j_params, act, mode):
    """OFF; ON (piecewise ACAM activations, log-domain DMMul, NL-DPE
    attention); FUSED (ON with the crossbar->ACAM gate).  The greedy choice
    agrees at every row."""
    jcfg = dataclasses.replace(J_CFG, activation_dtype=getattr(jnp, act))
    cfg = dataclasses.replace(CFG, activation_dtype=getattr(torch, act))
    tol = F32_TOL if act == "float32" else BF16_TOL[mode]
    mine = _port(j_params, cfg, MODES[mode][0])
    ref = _repro(j_params, jcfg, MODES[mode][1])
    for m, r in zip(mine, ref):
        assert np.isfinite(m).all()
        np.testing.assert_allclose(m, r, **tol)
        np.testing.assert_array_equal(m.argmax(-1), r.argmax(-1))


def test_init_params_tree_matches_repro(j_params):
    """Same tree, names, shapes and init scales as ``repro``."""
    mine = lm.init_params(CFG, generator=torch.Generator().manual_seed(0),
                          device="cpu")

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v
        return out

    fm, fr = flat(mine), flat(j_params)
    assert sorted(fm) == sorted(fr)
    for k in fr:
        assert tuple(fm[k].shape) == tuple(fr[k].shape), k
        ref_std = float(np.std(np.asarray(fr[k])))
        my_std = float(fm[k].std()) if fm[k].numel() > 1 else 0.0
        if ref_std == 0:
            assert my_std == 0 and float(fm[k].mean()) == float(
                np.mean(np.asarray(fr[k]))), k
        else:
            assert abs(my_std / ref_std - 1) < 0.2, (k, my_std, ref_std)


def test_param_count_matches_repro():
    for name in ("qwen2_5_3b",):
        assert get_config(name).param_count() == \
            j_get_config(name).param_count()
    assert get_config("qwen2_5_3b").param_count() == 3_085_844_480


def test_entry_points_default_to_the_card():
    """Without a GPU and without device='cpu' the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_model_cache(CFG, 1, 8, paged=(2, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax({"w": np.ones(2)})


def test_greedy_is_argmax_and_topk_matches_repro():
    from repro.launch.sampling import process_logits as j_process
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 300)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1     # tie -> first
    topk = np.array([0, 1, 3, 64, 299, 300 + 7], np.int32)
    mine = sampling.process_logits(torch.from_numpy(logits),
                                   torch.from_numpy(topk))
    ref = j_process(jnp.asarray(logits), jnp.asarray(topk))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    keys = torch.stack([sampling.request_key(i) for i in range(6)])
    greedy = sampling.sample_tokens(torch.from_numpy(logits),
                                    sampling.step_keys(keys, torch.arange(6)),
                                    torch.zeros(6), torch.from_numpy(topk))
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.argmax(logits, axis=-1))


def test_sampling_is_placement_invariant_and_follows_softmax():
    """A draw depends on (request seed, position) only, and the draws of
    one logit row over many positions follow softmax(logits / T) within
    sampling noise (chi-square at 10 bins, p ~ 1e-6 threshold)."""
    rng = np.random.default_rng(2)
    row = torch.from_numpy(rng.normal(size=(10,)).astype(np.float32))
    n = 20000
    keys = sampling.request_key(7)[None].repeat(n, 1)
    pos = torch.arange(n)
    toks = sampling.sample_tokens(row[None].repeat(n, 1),
                                  sampling.step_keys(keys, pos),
                                  torch.full((n,), 0.8),
                                  torch.zeros(n, dtype=torch.int32))
    # same (seed, position) in another batch slot -> same token
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    again = sampling.sample_tokens(row[None].repeat(n, 1),
                                   sampling.step_keys(keys, pos[perm]),
                                   torch.full((n,), 0.8),
                                   torch.zeros(n, dtype=torch.int32))
    assert torch.equal(again, toks[perm])
    p = torch.softmax(row / 0.8, 0).numpy()
    counts = np.bincount(toks.numpy(), minlength=10)
    chi2 = float((((counts - n * p) ** 2) / (n * p)).sum())
    assert chi2 < 45.0, chi2

"""PaliGemma's image prefix (prefix-LM) and the MusicGen backbone in the
port, held against ``repro`` on the CPU at their reduced configs, and the
plain versions of kernels F, C and A at head dim 256.

Weights come from ``repro``'s init through ``convert.from_jax``, inputs
(tokens and patch embeddings) from numpy seeds; ``repro`` runs jitted, as
its engines run.  Tolerances:

* bitwise: ``_mask`` with ``prefix_len``; greedy tokens of the lockstep
  path and of both engines against ``repro``'s;
* ``BLOCK_TOL`` 1e-6 absolute on ``blockwise_attention(prefix_len=)``
  (the same online softmax, einsums summed in another order);
* ``LOGIT_TOL`` 1e-5 absolute on float32 logits (measured <= 2e-6);
* ``BF16_TOL`` 0.1 with equal argmax on bf16 logits (``ROADMAP.md`` C:
  one bf16 rounding apart per layer);
* ``NLDPE_FLIP_TOL`` 3e-2 on ``ON``/``FUSED`` logits, equal argmax where
  the top-2 margin exceeds twice that (the log-grid rule of
  ``ROADMAP.md`` C);
* one train step: PR 21's tolerances (``tests/test_torch_train.py``):
  the loss within 1e-6 relative, the parameters within 0.1 x lr;
* the kernels' plain versions at D 256 against ``repro``'s Pallas kernels
  in interpret mode or their oracles: 1e-5 (F, A), one exp-grid LSB (C).
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
from repro.kernels.dual_compute.ops import (
    logdomain_flash_attention as j_logdomain_flash)
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.paged_attention.ops import paged_attention as j_paged
from repro.launch import serve as j_serve
from repro.launch.engine import PagedServeEngine as JPagedServeEngine
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JServeEngine
from repro.launch.train import build_train_step as j_build
from repro.models import lm as j_lm
from repro.nn import attention as JA
from repro.nn.module import param_dtype
from repro.optim import adamw as j_adamw

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.drift import flatten
from repro_torch.core.engine import FUSED, OFF, ON
from repro_torch.kernels.dual_compute.ops import (logdomain_flash_attention,
                                                  logdomain_plan)
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.launch import serve
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.launch.train import build_train_step
from repro_torch.models import lm
from repro_torch.nn import attention as A
from repro_torch.optim import adamw

torch.set_num_threads(1)

BLOCK_TOL = 1e-6
LOGIT_TOL = 1e-5
BF16_TOL = 0.1
NLDPE_FLIP_TOL = 3e-2
LOSS_RTOL = 1e-6
PARAM_TOL = 0.1                 # times the learning rate
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)

J_ON = JNLDPEConfig(enabled=True)
J_FUSED = JNLDPEConfig(enabled=True, fused_dual_compute=True)
VLM, AUDIO = "paligemma_3b", "musicgen_large"
_PARAMS = {}


def cfgs(arch, act=torch.float32):
    j_act = jnp.float32 if act == torch.float32 else jnp.bfloat16
    return (dataclasses.replace(get_config(arch, reduced=True),
                                activation_dtype=act),
            dataclasses.replace(j_get_config(arch, reduced=True),
                                activation_dtype=j_act))


def j_params(arch):
    """``repro``'s seeded init of the reduced ``arch`` (numpy leaves)."""
    if arch not in _PARAMS:
        with param_dtype(jnp.float32):
            _PARAMS[arch] = jax.tree.map(np.asarray, jax.jit(partial(
                j_lm.init_params, cfg=cfgs(arch)[1]))(jax.random.key(5)))
    return _PARAMS[arch]


def t_params(arch):
    return from_jax(j_params(arch), device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _patches(seed, b, cfg):
    """(B, n_patches, d) seeded patch embeddings, SigLIP-output scale."""
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)


def _margin(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _close_and_argmax(mine, ref, tol):
    np.testing.assert_allclose(mine, ref, rtol=0, atol=tol)
    clear = _margin(ref) > 2 * tol
    np.testing.assert_array_equal(mine.argmax(-1)[clear],
                                  ref.argmax(-1)[clear])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_configs_and_param_count_match_repro(arch):
    """``CONFIG`` and ``reduced()`` field for field (the activation dtype
    by name), and ``param_count`` at both sizes."""
    for reduced in (False, True):
        mine, ref = get_config(arch, reduced), j_get_config(arch, reduced)
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(ref, f.name)
            if f.name == "activation_dtype":
                assert str(a).split(".")[-1] == jnp.dtype(b).name
            else:
                assert a == b, f.name
        assert mine.param_count() == ref.param_count()
    assert get_config(VLM).param_count() == 2_508_660_736


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_from_jax_carries_the_tree_leaf_for_leaf(arch):
    """PaliGemma's tied embeddings (no ``lm_head``) and MQA projections,
    MusicGen's non-gated ``up``/``down``: the converted tree has
    ``repro``'s keys, shapes and values, and the port's own init the same
    keys and shapes."""
    jp = j_params(arch)
    tp = t_params(arch)
    own = lm.init_params(cfgs(arch)[0], device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = flatten(tp)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == [
        "".join(f"['{p}']" for p in path) for path, _ in tl]
    for (_, a), (_, b), (_, c) in zip(jl, tl, flatten(own)):
        assert a.shape == tuple(b.shape) == tuple(c.shape)
        np.testing.assert_array_equal(a, b.numpy())
    assert "lm_head" not in tp if arch == VLM else "lm_head" in tp
    assert ("gate" in tp["groups"]["b0"]["ffn"]) == (arch == VLM)


# ---------------------------------------------------------------------------
# the prefix-LM mask and blockwise attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,prefix", [
    (True, None, 5), (True, 4, 5), (False, None, 5), (True, None, 0),
    (True, 3, 12)])
def test_mask_with_prefix_is_repros(causal, window, prefix):
    qp, kp = np.arange(3, 15), np.arange(0, 15)
    mine = A._mask(torch.from_numpy(qp), torch.from_numpy(kp), causal=causal,
                   window=window, prefix_len=prefix)
    ref = JA._mask(jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                   window=window, prefix_len=prefix)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("prefix", [20, 32, 40],
                         ids=["mid_block", "block_edge", "past_two_blocks"])
def test_blockwise_attention_prefix_matches_repro(prefix):
    """Key blocks of 16 and query blocks of 8 over 48 positions: a prefix
    longer than one key block that ends mid-block (20), one that ends on
    a block edge (32) and one past two blocks (40), GQA 2."""
    rng = np.random.default_rng(prefix)
    q = rng.normal(size=(2, 4, 48, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 48, 16)).astype(np.float32)
            for _ in range(2))
    mine = A.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                 prefix_len=prefix, q_block=8, k_block=16)
    ref = JA.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                 prefix_len=prefix, q_block=8, k_block=16)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=BLOCK_TOL)


# ---------------------------------------------------------------------------
# reduced PaliGemma with an image prefix
# ---------------------------------------------------------------------------

def _vlm_inputs(b=2, s=12, seed=0):
    cfg, _ = cfgs(VLM)
    return _tokens(seed, (b, s), cfg.vocab_size), _patches(seed + 1, b, cfg)


def test_paligemma_logits_with_prefix_match_repro():
    """``OFF`` at float32: the train forward over prefix + text (P + S
    logits), then a prefill into a lockstep cache and three decode steps
    from position P + S, against ``repro``'s."""
    cfg, j_cfg = cfgs(VLM)
    toks, pe = _vlm_inputs()
    n_p, s = pe.shape[1], toks.shape[1]
    p = t_params(VLM)
    jp = j_params(VLM)
    ref, _ = jax.jit(partial(j_lm.forward, cfg=j_cfg, mode="train"))(
        jp, jnp.asarray(toks), patch_embeds=jnp.asarray(pe))
    mine = lm.forward(p, torch.from_numpy(toks), cfg, mode="train",
                      patch_embeds=torch.from_numpy(pe))
    assert mine.shape == (2, n_p + s, cfg.vocab_size)
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=LOGIT_TOL)
    j_cache = j_lm.init_model_cache(j_cfg, 2, n_p + s + 4,
                                    dtype=jnp.float32)
    ref, j_cache = jax.jit(partial(j_serve.build_prefill_step(j_cfg)))(
        jp, j_cache, jnp.asarray(toks[:, :-3]), jnp.asarray(pe))
    cache = lm.init_model_cache(cfg, 2, n_p + s + 4, device="cpu")
    sp = lm.serving_params(p, cfg)
    last, cache = serve.build_prefill_step(cfg)(
        sp, cache, torch.from_numpy(toks[:, :-3]), torch.from_numpy(pe))
    np.testing.assert_allclose(last.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_TOL)
    decode = jax.jit(partial(j_lm.decode_step, cfg=j_cfg))
    for t in range(s - 3, s):
        pos = n_p + t
        ref, j_cache = decode(jp, token=jnp.asarray(toks[:, t]),
                              pos=jnp.int32(pos), cache=j_cache)
        lg = lm.decode_step(sp, cfg, torch.from_numpy(toks[:, t]), pos, cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref), rtol=0,
                                   atol=LOGIT_TOL)


def test_paligemma_bf16_logits_with_prefix_match_repro():
    """bf16 activations (the patch embeddings cast to them): the serving
    copy cast once against ``repro``'s per-call casts."""
    cfg, j_cfg = cfgs(VLM, act=torch.bfloat16)
    toks, pe = _vlm_inputs(seed=2)
    ref, _ = jax.jit(partial(j_lm.forward, cfg=j_cfg, mode="train"))(
        j_params(VLM), jnp.asarray(toks), patch_embeds=jnp.asarray(pe))
    sp = lm.serving_params(t_params(VLM), cfg)
    mine = lm.forward(sp, torch.from_numpy(toks), cfg, mode="train",
                      patch_embeds=torch.from_numpy(pe))
    _close_and_argmax(mine.detach().numpy(), np.asarray(ref), BF16_TOL)


@pytest.mark.parametrize("mode", ["ON", "FUSED"])
def test_paligemma_nldpe_logits_with_prefix_match_repro(mode):
    """``ON`` and ``FUSED`` over the prefix: the masked, materialized
    NL-DPE attention (never kernel C, which is causal only), ACAM gelu on
    the gate (kernel B's plain version under ``FUSED``), against jitted
    ``repro`` under the log-grid rule."""
    cfg, j_cfg = cfgs(VLM)
    nl, j_nl = (ON, J_ON) if mode == "ON" else (FUSED, J_FUSED)
    toks, pe = _vlm_inputs(seed=3)
    j_cache = j_lm.init_model_cache(j_cfg, 2, 24, dtype=jnp.float32)
    ref, _ = jax.jit(lambda p, t, e, c: j_lm.forward(
        p, t, j_cfg, mode="prefill", cache=c, patch_embeds=e, nldpe=j_nl))(
        j_params(VLM), jnp.asarray(toks), jnp.asarray(pe), j_cache)
    sp = lm.serving_params(t_params(VLM), cfg, nl)
    cache = lm.init_model_cache(cfg, 2, 24, device="cpu")
    mine = lm.forward(sp, torch.from_numpy(toks), cfg, mode="prefill",
                      cache=cache, patch_embeds=torch.from_numpy(pe),
                      nldpe=nl)
    _close_and_argmax(mine.numpy(), np.asarray(ref), NLDPE_FLIP_TOL)


def test_paligemma_lockstep_tokens_with_prefix_match_repro():
    """The lockstep path with the prefix: prefill, then 6 greedy tokens
    from position P + S through the generate fn (and the per-token loop),
    equal to ``repro``'s ``build_generate_fn``'s."""
    cfg, j_cfg = cfgs(VLM)
    toks, pe = _vlm_inputs(seed=4, s=9)
    start = pe.shape[1] + toks.shape[1]
    gen = 6
    j_cache = j_lm.init_model_cache(j_cfg, 2, start + gen, dtype=jnp.float32)
    last, j_cache = jax.jit(j_serve.build_prefill_step(j_cfg))(
        j_params(VLM), j_cache, jnp.asarray(toks), jnp.asarray(pe))
    want, _ = j_serve.build_generate_fn(j_cfg, gen)(
        j_params(VLM), j_cache, jnp.argmax(last, -1).astype(jnp.int32),
        start)
    sp = lm.serving_params(t_params(VLM), cfg)
    cache = lm.init_model_cache(cfg, 2, start + gen, device="cpu")
    last, cache = serve.build_prefill_step(cfg)(
        sp, cache, torch.from_numpy(toks), torch.from_numpy(pe))
    tok0 = torch.argmax(last, -1).to(torch.int32)
    spare = lm.clone_cache(cache)
    got, _ = serve.build_generate_fn(cfg, gen)(sp, cache, tok0, start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    loop, _ = serve.python_loop_decode(serve.build_decode_step(cfg), sp,
                                       spare, tok0, start, gen)
    assert torch.equal(loop, got)


def test_prefix_is_bidirectional_and_text_causal():
    """A later patch row moves the output at an earlier patch position
    (the prefix attends both ways); a text token moves no patch position
    and no earlier text position (the text is causal)."""
    cfg, _ = cfgs(VLM)
    toks, pe = _vlm_inputs(seed=5)
    p = t_params(VLM)
    n_p = pe.shape[1]

    def run(t, e):
        return lm.forward(p, torch.from_numpy(t), cfg, mode="train",
                          patch_embeds=torch.from_numpy(e)).detach().numpy()

    base = run(toks, pe)
    pe2 = pe.copy()
    pe2[:, n_p - 1] += 1.0
    moved = run(toks, pe2)
    assert np.abs(moved[:, 0] - base[:, 0]).max() > 1e-3
    t2 = toks.copy()
    t2[:, 5] = (t2[:, 5] + 1) % cfg.vocab_size
    moved = run(t2, pe)
    np.testing.assert_array_equal(moved[:, :n_p + 5], base[:, :n_p + 5])
    assert np.abs(moved[:, n_p + 5:] - base[:, n_p + 5:]).max() > 1e-3


def test_prefix_refused_by_engine_caches_and_step_modes():
    """Paged and slotted caches take no image prefix (``repro``'s engines
    pass none), and neither do the "decode" and "chunk" modes."""
    cfg, _ = cfgs(VLM)
    p = t_params(VLM)
    toks = torch.from_numpy(_tokens(6, (2, 4), cfg.vocab_size))
    pe = torch.from_numpy(_patches(7, 2, cfg))
    pos = torch.arange(4, dtype=torch.int32)[None].expand(2, 4)
    for kw in (dict(paged=(8, 4)), dict(slotted=True)):
        cache = lm.init_model_cache(cfg, 2, 16, device="cpu", **kw)
        with pytest.raises(ValueError, match="patch_embeds"):
            lm.forward(p, toks, cfg, mode="chunk", cache=cache,
                       positions=pos, patch_embeds=pe)
    slotted = lm.init_model_cache(cfg, 2, 16, slotted=True, device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        lm.forward(p, toks, cfg, mode="prefill", cache=slotted,
                   patch_embeds=pe)


def test_paligemma_train_step_with_prefix_matches_repro():
    """One AdamW step on a batch with ``patch_embeds``: the loss over the
    text logits only (the first P dropped), as ``repro``'s step."""
    cfg, j_cfg = cfgs(VLM)
    toks = _tokens(8, (2, 11), cfg.vocab_size)
    pe = _patches(9, 2, cfg)
    lr = 1e-3
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]), "patch_embeds": jnp.asarray(pe)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy()),
          "patch_embeds": torch.from_numpy(pe)}
    _train_step_matches(VLM, cfg, j_cfg, jb, tb, lr)


def _train_step_matches(arch, cfg, j_cfg, jb, tb, lr):
    jp = jax.tree.map(jnp.asarray, j_params(arch))
    pt = t_params(arch)
    jstep = jax.jit(j_build(j_cfg, j_adamw.AdamWConfig(lr=lr)))
    pj2, sj, mj = jstep(jp, j_adamw.init(jp), jb)
    st = adamw.init(pt)
    build_train_step(cfg, adamw.AdamWConfig(lr=lr))(pt, st, tb)
    assert float(st["step"]) == 1
    loss = float(mj["loss"])
    assert np.isfinite(loss)
    diffs = [float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))
             for a, (_, b) in zip(jax.tree.leaves(pj2), flatten(pt))]
    assert max(diffs) <= PARAM_TOL * lr
    # the loss of the step's own forward, recomputed on the old weights
    p0 = t_params(arch)
    logits = lm.forward(p0, tb["tokens"], cfg, mode="train",
                        patch_embeds=tb.get("patch_embeds"))
    if "patch_embeds" in tb:
        logits = logits[:, tb["patch_embeds"].shape[1]:]
    assert lm.lm_loss(logits, tb["labels"]).item() == pytest.approx(
        loss, rel=LOSS_RTOL)


# ---------------------------------------------------------------------------
# reduced MusicGen, and both models through the engines
# ---------------------------------------------------------------------------

def test_musicgen_logits_match_repro():
    """``OFF`` at float32 (train forward; prefill and two decode steps),
    bf16 within 0.1, and ``ON``/``FUSED`` (kernel B's plain version on the
    non-gated ``up``, which the serving copy keeps float32) under the
    log-grid rule."""
    cfg, j_cfg = cfgs(AUDIO)
    toks = _tokens(10, (2, 14), cfg.vocab_size)
    p, jp = t_params(AUDIO), j_params(AUDIO)
    ref, _ = jax.jit(partial(j_lm.forward, cfg=j_cfg, mode="train"))(
        jp, jnp.asarray(toks))
    mine = lm.forward(p, torch.from_numpy(toks), cfg, mode="train")
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=LOGIT_TOL)
    j_cache = j_lm.init_model_cache(j_cfg, 2, 16, dtype=jnp.float32)
    _, j_cache = jax.jit(partial(j_lm.forward, cfg=j_cfg, mode="prefill"))(
        jp, jnp.asarray(toks[:, :12]), cache=j_cache)
    sp = lm.serving_params(p, cfg)
    cache = lm.init_model_cache(cfg, 2, 16, device="cpu")
    lm.forward(sp, torch.from_numpy(toks[:, :12]), cfg, mode="prefill",
               cache=cache)
    decode = jax.jit(partial(j_lm.decode_step, cfg=j_cfg))
    for t in (12, 13):
        ref, j_cache = decode(jp, token=jnp.asarray(toks[:, t]),
                              pos=jnp.int32(t), cache=j_cache)
        lg = lm.decode_step(sp, cfg, torch.from_numpy(toks[:, t]), t, cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref), rtol=0,
                                   atol=LOGIT_TOL)
    bcfg, bj_cfg = cfgs(AUDIO, act=torch.bfloat16)
    ref, _ = jax.jit(partial(j_lm.forward, cfg=bj_cfg, mode="train"))(
        jp, jnp.asarray(toks))
    mine = lm.forward(lm.serving_params(p, bcfg), torch.from_numpy(toks),
                      bcfg, mode="train")
    _close_and_argmax(mine.detach().numpy(), np.asarray(ref), BF16_TOL)
    for nl, j_nl in ((ON, J_ON), (FUSED, J_FUSED)):
        sp = lm.serving_params(p, cfg, nl)
        if nl is FUSED:
            ffn = sp["groups"]["b0"]["ffn"]
            assert ffn["up"] is p["groups"]["b0"]["ffn"]["up"]
        ref, _ = jax.jit(lambda q, t: j_lm.forward(
            q, t, j_cfg, mode="prefill", nldpe=j_nl))(jp, jnp.asarray(toks))
        mine = lm.forward(sp, torch.from_numpy(toks), cfg, mode="prefill",
                          nldpe=nl)
        _close_and_argmax(mine.numpy(), np.asarray(ref), NLDPE_FLIP_TOL)


def test_musicgen_lockstep_tokens_and_train_step_match_repro():
    """The lockstep path's greedy tokens (prefill, then 6 through the
    generate fn) equal ``repro``'s, and one train step holds PR 21's
    tolerances."""
    cfg, j_cfg = cfgs(AUDIO)
    toks = _tokens(11, (2, 10), cfg.vocab_size)
    jp = j_params(AUDIO)
    j_cache = j_lm.init_model_cache(j_cfg, 2, 16, dtype=jnp.float32)
    last, j_cache = jax.jit(j_serve.build_prefill_step(j_cfg))(
        jp, j_cache, jnp.asarray(toks))
    want, _ = j_serve.build_generate_fn(j_cfg, 6)(
        jp, j_cache, jnp.argmax(last, -1).astype(jnp.int32), 10)
    sp = lm.serving_params(t_params(AUDIO), cfg)
    cache = lm.init_model_cache(cfg, 2, 16, device="cpu")
    last, cache = serve.build_prefill_step(cfg)(sp, cache,
                                                torch.from_numpy(toks))
    got, _ = serve.build_generate_fn(cfg, 6)(
        sp, cache, torch.argmax(last, -1).to(torch.int32), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = _tokens(12, (2, 13), cfg.vocab_size)
    jb = {"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])}
    tb = {"tokens": torch.from_numpy(t[:, :-1].copy()),
          "labels": torch.from_numpy(t[:, 1:].copy())}
    _train_step_matches(AUDIO, cfg, j_cfg, jb, tb, 1e-3)


def _trace(seed, vocab, n=4):
    rng = np.random.default_rng(seed)
    return [(i, tuple(int(t) for t in rng.integers(0, vocab,
                                                   int(rng.integers(3, 20)))),
             int(rng.integers(3, 7)), i) for i in range(n)]


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_engines_match_repro_engines(arch):
    """Text-only requests (no engine of either package takes an image
    prefix) through ``ServeEngine`` and ``PagedServeEngine`` of both
    packages at float32: each port engine's greedy tokens equal its
    ``repro`` twin's, and the two port engines agree."""
    cfg, j_cfg = cfgs(arch)
    kw = dict(max_slots=3, max_len=32, prefill_chunk=8, decode_block=2)
    trace = _trace(13, cfg.vocab_size)
    p, jp = t_params(arch), jax.tree.map(jnp.asarray, j_params(arch))
    got = {}
    for name, eng, ref in (
            ("slotted", ServeEngine(cfg, p, device="cpu", **kw),
             JServeEngine(j_cfg, jp, **kw)),
            ("paged", PagedServeEngine(cfg, p, page_size=4, device="cpu",
                                       **kw),
             JPagedServeEngine(j_cfg, jp, page_size=4, **kw))):
        got[name] = {c.rid: list(c.tokens) for c in eng.run(
            [Request(rid=r, tokens=t, max_new_tokens=g, arrival=a)
             for r, t, g, a in trace])}
        want = {c.rid: list(c.tokens) for c in ref.run(
            [JRequest(rid=r, tokens=t, max_new_tokens=g, arrival=a)
             for r, t, g, a in trace])}
        assert got[name] == want, name
    assert got["slotted"] == got["paged"]


# ---------------------------------------------------------------------------
# kernels F, C and A at head dim 256: the plain versions and the plans
# ---------------------------------------------------------------------------

def _attn_inputs(shape, seed):
    b, hq, hkv, lq, lk, d = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, lq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, lk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, lk, d)).astype(np.float32))


def test_plain_attention_kernels_at_head_dim_256_match_repro():
    """F's plain version at PaliGemma's 8/1 heads of 256 (9 queries over
    9 and 13 keys) and C's (9 over 13) against ``repro``'s Pallas kernels
    in interpret mode; A's plain version (decode and a 3-query chunk over
    a table with sentinels) against ``repro``'s kernel in interpret
    mode."""
    for shape in ((1, 8, 1, 9, 9, 256), (1, 8, 1, 9, 13, 256)):
        q, k, v = _attn_inputs(shape, sum(shape))
        t = tuple(map(torch.from_numpy, (q, k, v)))
        j = tuple(map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(
            fa.flash_attention(*t).numpy(),
            np.asarray(j_flash(*j, bq=8, bk=8, interpret=True)), **KERNEL_TOL)
    np.testing.assert_allclose(
        logdomain_flash_attention(*t).numpy(),
        np.asarray(j_logdomain_flash(*j, interpret=True)), rtol=0,
        atol=1.0 / 255)
    rng = np.random.default_rng(14)
    for q_len in (1, 3):
        q = rng.normal(size=(2, 8, q_len, 256)).astype(np.float32)
        kp, vp = (rng.normal(size=(7, 1, 4, 256)).astype(np.float32)
                  for _ in range(2))
        bt = np.array([[3, 0, 7], [5, -1, 2]], np.int32)
        lengths = np.array([9, 3], np.int32)
        mine = pa.paged_attention(*map(torch.from_numpy,
                                       (q, kp, vp, bt, lengths))).numpy()
        ref = j_paged(*map(jnp.asarray, (q, kp, vp, bt, lengths)),
                      interpret=True)
        np.testing.assert_allclose(mine, np.asarray(ref), **KERNEL_TOL)


def test_plans_at_head_dim_256():
    """The three wrappers' plans at D 256, byte for byte their CUDA
    sources' layouts: F 64 rows a block (four warps); C resident up to
    352 keys, two-pass above; A decode for G*Q <= 8 (two float4s a lane),
    the chunk instance's 64-row tiles above, 32 positions a stage and
    splits of 4 stages (128 absolute positions, as 2 of 64 at D 128)."""
    assert fa.plan(torch.float32, 256) == fa.Plan(
        "float32", 64, 32, 2, 2 * 32 * (260 + 260) * 4 + 64 * 258 * 4)
    assert fa.plan(torch.bfloat16, 256) == fa.Plan(
        "bfloat16", 64, 64, 2, 2 * 64 * (288 + 264) * 2 + 64 * 258 * 4)
    base = 2 * 32 * 260 * 4 + 3 * 256 * 4 + 64 * 4 + 64 * 260 * 4
    assert logdomain_plan(352, 256).instance == "resident"
    assert logdomain_plan(352, 256).smem == base + 64 * 360 * 4
    assert logdomain_plan(353, 256).instance == "two_pass"
    assert logdomain_plan(2048, 256).smem == base
    for kind, dec in ((0, 132480), (1, 99840), (2, 69248)):
        pl = pa.plan(8, 1, 8, 64, 16, 256, kind)
        assert (pl.instance, pl.rows, pl.smem) == ("decode", 8, dec)
        for n_rows, tiles in ((9, 1), (16, 1), (64, 1), (512, 8)):
            pl = pa.plan(8, 1, n_rows, 64, 16, 256, kind)
            assert (pl.instance, pl.rows, pl.tiles) == ("chunk", 64, tiles)
            assert pl.smem <= pa.SMEM_LIMIT
    # 1024 + 511 positions in stages of 32, 4 stages a split: 12 splits
    assert pa.plan(8, 1, 512, 64, 16, 256, 0).splits == 12
    assert pa.ch_split_stages(64, 256) * pa.ch_positions(256) == \
        pa.ch_split_stages(64, 128) * pa.ch_positions(128) == 128
    assert pa.smem_bytes(64, 256, 0) == 205568


def test_windowed_prefill_at_head_dim_256_takes_kernel_f(monkeypatch):
    """RecurrentGemma's windowed layers (head dim 256 here) prefill
    through kernel F at or below their window, and through the band
    above it; a prefix or a softcap keeps the masked blockwise route."""
    calls = []
    plain = A.flash_attention

    def record(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)
    monkeypatch.setattr(A, "flash_attention", record)
    s = A.AttnSpec(n_heads=4, n_kv_heads=1, head_dim=256, window=8)
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.normal(size=(1, 4, 8, 256)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 1, 8, 256)).astype(
        np.float32)) for _ in range(2))
    pos = torch.arange(8, dtype=torch.int32)
    out = A._prefill_attention(q, k, v, s, pos, "prefill", OFF)
    assert calls == [(1, 4, 8, 256)]
    np.testing.assert_allclose(
        out.numpy(), A.blockwise_attention(q, k, v, window=8).numpy(),
        rtol=0, atol=1e-6)
    A._prefill_attention(q, k, v, s, pos, "prefill", OFF, prefix_len=3)
    A._prefill_attention(q, k, v, dataclasses.replace(s, softcap=50.0), pos,
                         "prefill", OFF)
    A._prefill_attention(q, k, v, s, pos, "train", OFF)
    assert len(calls) == 1

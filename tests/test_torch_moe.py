"""The MoE block and the MoE configs (Qwen3-30B-A3B, Llama4-Scout) in the
port, held against ``repro`` on the CPU.

Weights come from ``repro``'s init through ``convert.from_jax``, inputs
from numpy seeds.  Tolerances:

* bitwise: the routing integers (``expert_idx``, the sort ``order``,
  ``kept``, ``slot_of_assign``, the slot gathers) from the same router
  probabilities, ties included, and the dropped-assignment count; greedy
  tokens of both engines against ``repro``'s engines;
* ``MOE_TOL`` 1e-5 absolute on ``moe_apply`` outputs at float32 (the
  expert matmuls sum in another order; measured up to 3.8e-6 on outputs
  of unit-normal inputs);
* ``LOGIT_TOL`` 1e-5 absolute on ``OFF`` logits of the reduced models at
  float32 (measured up to 4.3e-6 on the whole-sequence logits);
* ``BF16_TOL`` 0.1 with equal argmax on bf16 logits (the FUSED-at-bf16
  rule of ``ROADMAP.md`` C: one bf16 rounding apart per layer);
* ``NLDPE_FLIP_TOL`` 3e-2 on ``ON``/``FUSED`` logits, with equal argmax
  wherever the top-2 margin exceeds twice that (the log-grid rule of
  ``ROADMAP.md`` C: float32 ulps apart upstream move an 8-bit code by one
  LSB).
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
from repro.launch.engine import PagedServeEngine as JPagedServeEngine
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JServeEngine
from repro.models import lm as j_lm
from repro.nn import moe as JM
from repro.nn.module import param_dtype

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import FUSED, OFF, ON
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.models import lm
from repro_torch.nn import moe as M

torch.set_num_threads(1)

MOE_TOL = 1e-5
LOGIT_TOL = 1e-5
BF16_TOL = 0.1
NLDPE_FLIP_TOL = 3e-2

J_ON = JNLDPEConfig(enabled=True)
J_FUSED = JNLDPEConfig(enabled=True, fused_dual_compute=True)
ARCHS = ("qwen3_moe_30b_a3b", "llama4_scout_17b_a16e")
# a reduced spec where experts overflow: capacity 1.0, a low floor
DROPPING = dict(capacity_factor=1.0, min_capacity=2)

_STATE = {}


def cfgs(arch, act=torch.float32, **moe):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              activation_dtype=act)
    j_act = jnp.float32 if act == torch.float32 else jnp.bfloat16
    j_cfg = dataclasses.replace(j_get_config(arch, reduced=True),
                                activation_dtype=j_act)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        j_cfg = dataclasses.replace(j_cfg, moe=dataclasses.replace(
            j_cfg.moe, **moe))
    return cfg, j_cfg


def j_params(arch):
    if arch not in _STATE:
        with param_dtype(jnp.float32):
            _STATE[arch] = jax.jit(partial(j_lm.init_params,
                                           cfg=cfgs(arch)[1]))(
                jax.random.key(3))
    return _STATE[arch]


def _specs(case):
    if case == "llama4_top1":
        s = get_config("llama4_scout_17b_a16e", reduced=True).moe
    else:
        s = get_config("qwen3_moe_30b_a3b", reduced=True).moe
        if case == "drops":
            s = dataclasses.replace(s, **DROPPING)
    return s, JM.MoESpec(**dataclasses.asdict(s))


def _block(case, d=32, seed=0):
    s, js = _specs(case)
    jp = JM.moe_init(jax.random.key(seed), d, js)
    return s, js, jp, from_jax(jp, device="cpu")


def j_routing(probs, s, cap):
    """``repro/nn/moe.py``'s routing lines (83-123) on ``probs``."""
    g, tg, _ = probs.shape
    a = tg * s.top_k
    gate_vals, expert_idx = jax.lax.top_k(probs, s.top_k)
    if s.router_norm_topk:
        gate_vals = gate_vals / jnp.maximum(
            jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    fe = expert_idx.reshape(g, a)
    order = jnp.argsort(fe, axis=-1, stable=True)
    fe_sorted = jnp.take_along_axis(fe, order, axis=-1)
    counts = jax.vmap(lambda f: jnp.bincount(f, length=s.n_experts))(
        fe_sorted)
    starts = jnp.cumsum(counts, axis=-1) - counts
    rank_sorted = jnp.arange(a)[None, :] - jnp.take_along_axis(
        starts, fe_sorted, axis=-1)
    pos = starts[:, :, None] + jnp.arange(cap)[None, None, :]
    slot_valid = (jnp.arange(cap)[None, None, :]
                  < jnp.minimum(counts, cap)[:, :, None])
    pos_c = jnp.clip(pos, 0, a - 1).reshape(g, s.n_experts * cap)
    tok_for_slot = jnp.take_along_axis(order // s.top_k, pos_c, axis=-1)
    inv = jnp.argsort(order, axis=-1)
    rank = jnp.take_along_axis(rank_sorted, inv, axis=-1)
    kept = rank < cap
    slot_of_assign = fe * cap + jnp.clip(rank, 0, cap - 1)
    return {"gate_vals": gate_vals, "expert_idx": expert_idx,
            "order": order, "rank": rank, "kept": kept,
            "slot_of_assign": slot_of_assign, "tok_for_slot": tok_for_slot,
            "slot_valid": slot_valid}


def _assert_routing_equal(mine, ref):
    for name, r in ref.items():
        m = mine[name].numpy()
        if name == "gate_vals":
            np.testing.assert_array_equal(m, np.asarray(r), err_msg=name)
        else:
            np.testing.assert_array_equal(m.astype(np.int64),
                                          np.asarray(r).astype(np.int64),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tg,case", [(1, "dropless"), (48, "dropless"),
                                     (3, "drops"), (48, "drops"),
                                     (64, "drops"), (100, "llama4_top1")])
def test_capacity_matches_repro(tg, case):
    s, js = _specs(case)
    assert M._capacity(tg, s) == JM._capacity(tg, js)
    base = dataclasses.replace(s, capacity_factor=1.25, min_capacity=8)
    assert M._capacity(tg, base) == JM._capacity(
        tg, JM.MoESpec(**dataclasses.asdict(base)))


@pytest.mark.parametrize("case", ["dropless", "drops", "llama4_top1"])
def test_moe_apply_matches_repro(case):
    """2 x 24 tokens through ``moe_apply``: the routing integers bitwise
    from ``repro``'s probabilities and from the port's own router, the
    output within ``MOE_TOL``, the drop counter equal to ``repro``'s
    dropped assignments (some expert overflows in the "drops" case)."""
    s, js, jp, p = _block(case)
    x = np.random.default_rng(1).normal(size=(2, 24, 32)).astype(np.float32)
    ref = jax.jit(partial(JM.moe_apply, s=js))(jp, jnp.asarray(x))
    drops = torch.zeros((2,), dtype=torch.int64)
    out = M.moe_apply(p, torch.from_numpy(x), s, drops=drops)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=MOE_TOL)
    cap = M._capacity(48, s)
    j_probs = np.asarray(jax.jit(lambda x, w: jax.nn.softmax(
        jnp.einsum("gtd,de->gte", x, w), axis=-1))(
        jnp.asarray(x.reshape(1, 48, 32)), jp["router"]))
    want = jax.jit(partial(j_routing, s=js, cap=cap))(jnp.asarray(j_probs))
    _assert_routing_equal(M.route(torch.from_numpy(j_probs.copy()), s, cap),
                          want)
    probs = torch.softmax(M.router_logits(p, torch.from_numpy(x).reshape(
        1, 48, 32)), dim=-1)
    mine = M.route(probs, s, cap)
    for name in ("expert_idx", "order", "kept", "slot_of_assign"):
        np.testing.assert_array_equal(mine[name].numpy().astype(np.int64),
                                      np.asarray(want[name]).astype(np.int64),
                                      err_msg=name)
    n_dropped = int(np.sum(~np.asarray(want["kept"])))
    assert drops.tolist() == [n_dropped, 0]        # no live mask: all live
    assert (n_dropped > 0) == (case == "drops")
    if case == "llama4_top1":
        assert want["expert_idx"].shape[-1] == 1
        # no renormalization: the gate is the router probability itself
        np.testing.assert_array_equal(
            mine["gate_vals"].numpy(),
            probs.numpy().max(-1, keepdims=True))


@pytest.mark.parametrize("live_rows", [(0, 1), (0,), (1,), ()])
def test_drop_counter_splits_live_and_pad(live_rows):
    """The drop counter at a capacity that drops, over 2 x 24 tokens with
    the rows of ``live_rows`` live (the others padding): its live and pad
    counts are ``repro``'s dropped assignments (``~kept``) summed over the
    live and over the other tokens, bitwise; the output does not depend on
    the mask."""
    s, js, jp, p = _block("drops")
    x = np.random.default_rng(1).normal(size=(2, 24, 32)).astype(np.float32)
    live = np.zeros((2, 24), bool)
    live[list(live_rows)] = True
    live[:, 20:] = False                      # a chunk's tail past a prompt
    drops = torch.zeros((2,), dtype=torch.int64)
    out = M.moe_apply(p, torch.from_numpy(x), s, drops=drops,
                      live=torch.from_numpy(live))
    np.testing.assert_array_equal(out.numpy(), M.moe_apply(
        p, torch.from_numpy(x), s).numpy())
    j_probs = jax.jit(lambda x, w: jax.nn.softmax(
        jnp.einsum("gtd,de->gte", x, w), axis=-1))(
        jnp.asarray(x.reshape(1, 48, 32)), jp["router"])
    kept = np.asarray(jax.jit(partial(j_routing, s=js, cap=M._capacity(
        48, s)))(j_probs)["kept"])
    lost = np.sum(~kept.reshape(2, 24, s.top_k), axis=-1)
    assert drops.tolist() == [int(lost[live].sum()), int(lost[~live].sum())]
    assert lost.sum() > 0


def test_paged_dense_rows_take_the_masked_dense_route():
    """``attn_apply`` on a paged cache, one chunk of 2 queries per slot,
    slot 0 written and slots 1 (an empty position track) and 2 (a stale
    one with a gap) write-masked and named in ``dense_rows``: every row
    equals the masked dense route over the gathered cache (kernel A's
    plain version for slot 0, the recomputed subset for slots 1 and 2)
    within ``MOE_TOL``.  Without ``dense_rows`` the empty-track slot
    differs: kernel A reads its block table where the dense route spreads
    the softmax over every gathered line."""
    from repro_torch.nn.attention import (_project_qkv, attn_apply,
                                          cached_attention, paged_dense_view,
                                          write_plan)
    cfg = cfgs("qwen3_moe_30b_a3b")[0]
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    p = lm._index(params["groups"]["b0"], 0)["attn"]
    s = lm.attn_spec(cfg, "moe")
    rng = np.random.default_rng(6)
    cache = lm.init_model_cache(cfg, 3, 16, paged=(12, 4), device="cpu")
    cache["bt"].copy_(torch.arange(12, dtype=torch.int32).reshape(3, 4))
    for name in ("k", "v"):
        cache[name].copy_(torch.from_numpy(rng.normal(
            size=tuple(cache[name].shape)).astype(np.float32)))
    cache["pos"].fill_(-1)
    cache["pos"][0, :6] = torch.arange(6, dtype=torch.int32)
    cache["pos"][2, :8] = torch.tensor([0, 1, 2, 3, -1, 5, 6, 7],
                                       dtype=torch.int32)
    positions = torch.tensor([[6, 7], [0, 1], [8, 9]], dtype=torch.int32)
    mask = torch.tensor([True, False, False])
    x = torch.from_numpy(rng.normal(size=(3, 2, cfg.d_model)).astype(
        np.float32))
    outs = {}
    for name, rows in (("dense", torch.tensor([1, 2])), ("kernel", None)):
        c = lm.clone_cache(cache)
        lc = lm.layer_cache(c, 0)
        plan = write_plan(lc, positions, mask)
        outs[name] = attn_apply(p, s, x, positions=positions, mode="chunk",
                                cache=lc, plan=plan, dense_rows=rows)
    q = _project_qkv(p, s, x, positions)[0]
    want = torch.einsum("bhsk,hkd->bsd", cached_attention(
        q, paged_dense_view(lc), positions, s), p["wo"])
    np.testing.assert_allclose(outs["dense"].numpy(), want.numpy(), rtol=0,
                               atol=MOE_TOL)
    assert (outs["kernel"][1] - want[1]).abs().max() > 100 * MOE_TOL


@pytest.mark.parametrize("case", ["dropless", "llama4_top1"])
def test_groups_one_against_four(case):
    """Dropless, every token's output is its own: four routing groups give
    the one-group result (and ``repro``'s four-group one)."""
    s, js, jp, p = _block(case, seed=1)
    x = np.random.default_rng(2).normal(size=(4, 6, 32)).astype(np.float32)
    one = M.moe_apply(p, torch.from_numpy(x), s, groups=1)
    four = M.moe_apply(p, torch.from_numpy(x), s, groups=4)
    ref = jax.jit(partial(JM.moe_apply, s=js, groups=4))(jp, jnp.asarray(x))
    np.testing.assert_allclose(four.numpy(), one.numpy(), rtol=0,
                               atol=MOE_TOL)
    np.testing.assert_allclose(four.numpy(), np.asarray(ref), rtol=0,
                               atol=MOE_TOL)
    # a group count that does not divide the tokens falls back to one
    np.testing.assert_array_equal(
        M.moe_apply(p, torch.from_numpy(x), s, groups=5).numpy(),
        one.numpy())


@pytest.mark.parametrize("k", [1, 2, 8])
def test_top_k_ties_take_the_lower_index_first(k):
    """A zero router gives every expert the same probability: the chosen
    experts are ``repro``'s, lowest index first."""
    n_e = 16
    probs = jnp.full((1, 5, n_e), 1.0 / n_e, jnp.float32)
    j_vals, j_idx = jax.lax.top_k(probs, k)
    vals, idx = M.top_k(torch.from_numpy(np.asarray(probs)), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(idx.numpy()[0, 0], np.arange(k))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    # mixed ties: equal pairs anywhere in the row
    row = np.array([3, 1, 3, 2, 1, 3, 0, 2] * 2, np.float32) / 8
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(row), k)
    vals, idx = M.top_k(torch.from_numpy(row), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_on_router_softmax_codes_and_ties():
    """Under ``ON`` the router softmax runs on the 8-bit log grid, where
    equal probabilities are common: from the same float32 logits the
    port's probabilities are ``repro``'s (jitted) bit for bit, no router
    code flips, and the tie-broken top-8 experts are equal."""
    s = get_config("qwen3_moe_30b_a3b").moe
    logits = np.random.default_rng(4).normal(
        size=(1, 64, s.n_experts)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda t: J_ON.softmax(t, axis=-1))(
        jnp.asarray(logits)))
    mine = ON.softmax(torch.from_numpy(logits), axis=-1).numpy()
    flips = int(np.sum(mine != ref))
    assert flips == 0, f"{flips} router codes flip"
    assert len(np.unique(ref[0, 0])) < s.n_experts     # ties on the grid
    _, j_idx = jax.lax.top_k(jnp.asarray(ref), s.top_k)
    _, idx = M.top_k(torch.from_numpy(mine), s.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_load_balance_loss_matches_repro():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 7, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (2, 7, 2)).astype(np.int32)
    ref = JM.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 8)
    mine = M.load_balance_loss(torch.from_numpy(logits),
                               torch.from_numpy(idx), 8)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------

def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _margin(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_off_logits_match_repro(arch):
    """``OFF`` at float32: whole-sequence logits, then a prefill and three
    decode steps against ``repro``'s."""
    cfg, j_cfg = cfgs(arch)
    toks = _tokens(6, (2, 20))
    p = from_jax(j_params(arch), device="cpu")
    ref, _ = jax.jit(partial(j_lm.forward, cfg=j_cfg, mode="train"))(
        j_params(arch), jnp.asarray(toks))
    mine = lm.forward(p, torch.from_numpy(toks), cfg, mode="train")
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=LOGIT_TOL)
    j_cache = j_lm.init_model_cache(j_cfg, 2, 24, dtype=jnp.float32)
    ref, j_cache = jax.jit(partial(j_lm.forward, cfg=j_cfg, mode="prefill"))(
        j_params(arch), jnp.asarray(toks[:, :17]), cache=j_cache)
    cache = lm.init_model_cache(cfg, 2, 24, device="cpu")
    sp = lm.serving_params(p, cfg)
    mine = lm.forward(sp, torch.from_numpy(toks[:, :17]), cfg,
                      mode="prefill", cache=cache)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_TOL)
    decode = jax.jit(partial(j_lm.decode_step, cfg=j_cfg))
    for t in range(17, 20):
        ref, j_cache = decode(j_params(arch), token=jnp.asarray(toks[:, t]),
                              pos=jnp.int32(t), cache=j_cache)
        lg = lm.decode_step(sp, cfg, torch.from_numpy(toks[:, t]), t, cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref), rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_bf16_logits_match_repro(arch):
    """bf16 activations: the serving copy cast once against ``repro``'s
    per-call casts, one bf16 rounding apart per layer."""
    cfg, j_cfg = cfgs(arch, act=torch.bfloat16)
    toks = _tokens(7, (2, 16))
    ref, _ = jax.jit(partial(j_lm.forward, cfg=j_cfg, mode="train"))(
        j_params(arch), jnp.asarray(toks))
    sp = lm.serving_params(from_jax(j_params(arch), device="cpu"), cfg)
    mine = lm.forward(sp, torch.from_numpy(toks), cfg, mode="train")
    ref = np.asarray(ref)
    np.testing.assert_allclose(mine.detach().numpy(), ref, rtol=0,
                               atol=BF16_TOL)
    clear = _margin(ref) > 2 * BF16_TOL
    np.testing.assert_array_equal(mine.detach().numpy().argmax(-1)[clear],
                                  ref.argmax(-1)[clear])


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS
                                       for m in ("ON", "FUSED")])
def test_reduced_model_nldpe_logits_match_repro(arch, mode):
    """``ON`` (the router softmax on the log grid, ACAM silu in the
    experts, log-domain DMMul products) and ``FUSED`` (kernel C's plain
    version in the prefill; the experts never reach kernel B) against
    jitted ``repro``, under the log-grid rule."""
    cfg, j_cfg = cfgs(arch)
    nl, j_nl = (ON, J_ON) if mode == "ON" else (FUSED, J_FUSED)
    toks = _tokens(8, (2, 18))
    j_cache = j_lm.init_model_cache(j_cfg, 2, 24, dtype=jnp.float32)
    ref, j_cache = jax.jit(lambda p, t, c: j_lm.forward(
        p, t, j_cfg, mode="prefill", cache=c, nldpe=j_nl))(
        j_params(arch), jnp.asarray(toks[:, :16]), j_cache)
    sp = lm.serving_params(from_jax(j_params(arch), device="cpu"), cfg, nl)
    cache = lm.init_model_cache(cfg, 2, 24, device="cpu")
    mine = lm.forward(sp, torch.from_numpy(toks[:, :16]), cfg,
                      mode="prefill", cache=cache, nldpe=nl)
    outs = [(mine.numpy(), np.asarray(ref))]
    decode = jax.jit(lambda p, t, pos, c: j_lm.decode_step(
        p, j_cfg, t, pos, c, nldpe=j_nl))
    for t in range(16, 18):
        ref, j_cache = decode(j_params(arch), jnp.asarray(toks[:, t]),
                              jnp.int32(t), j_cache)
        lg = lm.decode_step(sp, cfg, torch.from_numpy(toks[:, t]), t, cache,
                            nldpe=nl)
        outs.append((lg.numpy(), np.asarray(ref)))
    for m, r in outs:
        np.testing.assert_allclose(m, r, rtol=0, atol=NLDPE_FLIP_TOL)
        clear = _margin(r) > 2 * NLDPE_FLIP_TOL
        np.testing.assert_array_equal(m.argmax(-1)[clear],
                                      r.argmax(-1)[clear])


def _trace(seed, n=4):
    rng = np.random.default_rng(seed)
    return [(i, tuple(int(t) for t in rng.integers(0, 256,
                                                   int(rng.integers(3, 22)))),
             int(rng.integers(3, 7)), i) for i in range(n)]


@pytest.mark.parametrize("drop", [False, True])
def test_engines_match_repro_engines(drop):
    """One shared trace through ``ServeEngine`` and ``PagedServeEngine``
    of both packages (reduced Qwen3-MoE, 3 slots, prefill chunks of 8):
    each port engine's greedy tokens equal its ``repro`` twin's, dropless
    and again at a capacity that drops — the twins schedule the same
    chunks, padding rows included, so they drop the same assignments (the
    port's drop counter is then nonzero).  Dropless, the two engines agree
    with each other too; with drops they need not (the slotted engine's
    pad rows differ from the paged one's)."""
    cfg, j_cfg = cfgs("qwen3_moe_30b_a3b", **(DROPPING if drop else {}))
    kw = dict(max_slots=3, max_len=32, prefill_chunk=8, decode_block=2)
    trace = _trace(9)
    p = from_jax(j_params("qwen3_moe_30b_a3b"), device="cpu")
    jp = j_params("qwen3_moe_30b_a3b")
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
        st = eng.moe_stats
        assert (st["dropped_prefill"] > 0) == drop, st
        assert st["prefill_forwards"] > 0 and st["decode_forwards"] > 0
        assert eng.metrics.snapshot()["moe"] == st
    if not drop:
        assert got["slotted"] == got["paged"]


# ---------------------------------------------------------------------------
# parameters and configs
# ---------------------------------------------------------------------------

def test_serving_params_moe_leaves():
    """The router stays float32 in every mode; the expert gate is cast to
    the activation dtype under ``FUSED`` too (only the dense MLP gate,
    which kernel B programs, keeps its master)."""
    cfg, _ = cfgs("qwen3_moe_30b_a3b", act=torch.bfloat16)
    p = from_jax(j_params("qwen3_moe_30b_a3b"), device="cpu")
    for nl in (OFF, ON, FUSED):
        ffn = lm.serving_params(p, cfg, nl)["groups"]["b0"]["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert ffn["router"] is p["groups"]["b0"]["ffn"]["router"]
        for name in ("gate", "up", "down"):
            assert ffn[name].dtype == torch.bfloat16, (nl, name)
    dense = dataclasses.replace(get_config("qwen2_5_3b", reduced=True))
    dp = lm.init_params(dense, device="cpu")
    assert lm.serving_params(dp, dense, FUSED)["groups"]["b0"]["ffn"][
        "gate"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_repro(arch):
    for reduced in (False, True):
        cfg, j_cfg = get_config(arch, reduced), j_get_config(arch, reduced)
        assert cfg.param_count() == j_cfg.param_count()
        assert cfg.active_param_count() == j_cfg.active_param_count()
    assert get_config(arch).moe == dataclasses.replace(
        get_config(arch).moe)                     # frozen, comparable


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_carries_the_tree_leaf_for_leaf(arch):
    """``repro``'s reduced tree (stacked ``"groups"`` layout) lands leaf
    for leaf; the port's own ``init_params`` builds the same paths and
    shapes, and draws the experts at E^-1/2 as ``repro`` does."""
    jp = j_params(arch)
    mine, ref = _flat(from_jax(jp, device="cpu")), _flat(jp)
    assert list(mine) == list(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(mine[path].numpy(), np.asarray(leaf))
    cfg = get_config(arch, reduced=True)
    own = _flat(lm.init_params(cfg, generator=torch.Generator().manual_seed(
        0), device="cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(np.shape(v)) for k, v in ref.items()}
    e = cfg.moe.n_experts
    for name in ("gate", "up", "down"):
        w = own[("groups", "b0", "ffn", name)]
        j_w = np.asarray(ref[("groups", "b0", "ffn", name)])
        assert w.std().item() == pytest.approx(e ** -0.5, rel=0.1)
        assert float(j_w.std()) == pytest.approx(e ** -0.5, rel=0.1)

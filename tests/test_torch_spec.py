"""The port's speculative paged engine (``launch/spec_decode.py``) held
against ``repro``'s on the shared harness (tests/engine_harness.py: the
reduced Qwen2.5-3B with ``repro``'s seeded weights, 2 slots, a
zero-headroom page pool, the harness's bf16 activations).

Greedy spec tokens equal ``repro``'s spec engine's and the port's own
non-spec engine's up to near-ties: the verify chunk of k + 1 queries and
the k + 1 decode steps it stands for sum in different orders (kernel A's
plain version at Q = 1 and Q = k + 1, bf16 matmuls of other heights), so
where two tokens diverge ``repro``'s top-2 logit margin at that position
must be below ``TIE_MARGIN`` (tests/test_torch_serve.py's, several times
the measured bf16 logit deviation), and at most one such tie is allowed
per test.  The spec functions are held against ``repro``'s on identical
numpy inputs, each with its tolerance stated.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
from repro.core.logdomain import DEFAULT_CFG as J_LD
from repro.launch import sampling as j_sampling
from repro.launch import spec_decode as j_spec
from repro.launch.engine import PagedServeEngine as JPagedServeEngine
from repro.launch.kvpool import PagePool as JPagePool
from repro.models import lm as j_lm

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import FUSED, NLDPEConfig, ON
from repro_torch.core.logdomain import encode_live
from repro_torch.launch import sampling, spec_decode
from repro_torch.launch.engine import PagedServeEngine, Request
from repro_torch.launch.kvpool import PagePool

torch.set_num_threads(1)

CFG = get_config("qwen2_5_3b", reduced=True)
CFG32 = dataclasses.replace(CFG, activation_dtype=torch.float32)
WQ = NLDPEConfig(enabled=False)          # the weights-only drafter
TIE_MARGIN = 0.02                        # OFF at bf16, as test_torch_serve
SPEC_KS = (1, 2, 4)

_ENGINES = {}


def _params():
    if "params" not in _ENGINES:
        _ENGINES["params"] = from_jax(H.shared_params(), device="cpu")
    return _ENGINES["params"]


def port_engine(spec_k: int = 0, cfg=CFG, **over) -> PagedServeEngine:
    """Port engine singletons with the harness's settings (the weights-only
    drafter unless ``spec_draft`` is given)."""
    key = (spec_k, cfg, tuple(sorted(over.items())))
    if key not in _ENGINES:
        kw = H.engine_kwargs(page_size=H.PAGE, num_pages=H.NUM_PAGES,
                             **over)
        if spec_k:
            kw = {"spec_draft": WQ, **kw}
        _ENGINES[key] = PagedServeEngine(cfg, _params(), spec_k=spec_k,
                                         device="cpu", **kw)
    return _ENGINES[key]


def ref_engine(spec_k: int) -> JPagedServeEngine:
    """``repro``'s spec engine with the harness's settings, private to this
    module as ``port_engine``'s are.  The harness's singletons carry the
    state that other test files leave in them (their traces' radix
    caches), and from that state ``repro``'s drafts differ from a fresh
    engine's, so drafts compared on them would depend on which files a
    test worker ran first."""
    key = ("repro", spec_k)
    if key not in _ENGINES:
        _ENGINES[key] = JPagedServeEngine(
            H.CFG, H.shared_params(),
            **H.engine_kwargs(page_size=H.PAGE, num_pages=H.NUM_PAGES,
                              spec_k=spec_k, spec_draft=H.WQ_DRAFT))
    return _ENGINES[key]


def run_port(eng, trace) -> dict:
    reqs = [Request(rid=r.rid, tokens=r.tokens,
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, top_k=r.top_k, seed=r.seed,
                    arrival=r.arrival)
            for r in H.to_requests(trace, eng.tick)]
    comps = eng.run(reqs)
    assert sorted(c.rid for c in comps) == list(range(len(trace)))
    return {c.rid: (c.tokens, c.finish_reason) for c in comps}


def margin(tokens, cfg=H.CFG) -> float:
    """``repro``'s top-2 logit margin after ``tokens`` (OFF)."""
    logits, _ = j_lm.forward(H.shared_params(),
                             jnp.asarray([tokens], jnp.int32), cfg,
                             mode="train")
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


def near_ties(trace, got: dict, want: dict, cfg=H.CFG) -> int:
    """Assert ``got`` == ``want`` per request up to near-ties; returns the
    number of ties."""
    ties = 0
    for rid, (toks, reason) in want.items():
        mine, mine_reason = got[rid]
        if mine == toks:
            assert mine_reason == reason, rid
            continue
        i = next((i for i, (a, b) in enumerate(zip(mine, toks)) if a != b),
                 min(len(mine), len(toks)))
        m = margin(tuple(trace[rid][0]) + tuple(toks[:i]), cfg)
        assert m < TIE_MARGIN, (
            f"rid {rid} diverges at token {i} with a top-2 margin of {m} "
            f"(not a near-tie): {mine} vs {toks}")
        ties += 1
    return ties


def record_drafts(eng, log: list):
    """Log every draft phase of a spec engine (the port's or ``repro``'s):
    the slot owners' rids, the positions, the active mask and the drafts.
    Returns the call that stops logging."""
    def logged(fn, to_np):
        def call(params, cache, tok, pos, active, *rest):
            out = fn(params, cache, tok, pos, active, *rest)
            drafts = out[0] if isinstance(eng, PagedServeEngine) else out[1]
            log.append(([o.rid if o else None for o in eng._slot_owner],
                        to_np(pos), to_np(active), to_np(drafts)))
            return out
        return call

    if isinstance(eng, PagedServeEngine):
        plain = eng._draft_fn
        eng._draft_fn = logged(plain, lambda t: t.numpy().copy())
        return lambda: setattr(eng, "_draft_fn", plain)
    pair = eng._spec_fns_for(eng.spec_k)
    eng._spec_fn_cache[eng.spec_k] = (logged(pair[0], np.array), pair[1])
    return lambda: eng._spec_fn_cache.__setitem__(eng.spec_k, pair)


def drafter_ties(trace, ref_eng, ref_log, my_log, tokens) -> int:
    """Where the two engines drafted different tokens (the ticks align
    when the tokens agree), ``repro``'s drafter top-2 logit margin at that
    draft must be below ``TIE_MARGIN``; returns the number of such ties."""
    ties = 0
    assert len(ref_log) == len(my_log)
    for (rids, pos, active, d_ref), (_, _, _, d_mine) in zip(ref_log,
                                                            my_log):
        for s in np.flatnonzero(active):
            if np.array_equal(d_ref[s], d_mine[s]):
                continue
            j = int(np.flatnonzero(d_ref[s] != d_mine[s])[0])
            prompt = tuple(trace[rids[s]][0])
            ctx = (prompt + tuple(tokens[rids[s]][:pos[s] - len(prompt) + 1])
                   + tuple(int(t) for t in d_ref[s, :j]))
            logits, _ = j_lm.forward(ref_eng._draft_params,
                                     jnp.asarray([ctx], jnp.int32), H.CFG,
                                     mode="train")
            top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
            assert top[1] - top[0] < TIE_MARGIN, (
                f"rid {rids[s]}: drafts {d_mine[s]} vs {d_ref[s]} with a "
                f"drafter margin of {top[1] - top[0]} (not a near-tie)")
            ties += 1
    return ties


def audit(eng) -> None:
    """No page leaks: every slot free, every page reclaimable."""
    assert eng.free_slots == eng.max_slots
    eng.pool.check()
    assert eng.pool.available() == eng.pool.num_pages


@pytest.mark.parametrize("k", SPEC_KS)
def test_spec_engine_matches_repro_and_non_spec(k):
    """Two traces (shared prefixes with COW forks and evictions, then a
    tiny-alphabet Poisson trace) through the port's spec engine, ``repro``'s
    spec engine and the port's non-spec engine: equal greedy tokens (one
    near-tie at most), and where no token tie occurred, equal drafts up to
    a drafter near-tie (a log-grid drafter at bf16 has near-ties of its
    own) and, where none occurred either, equal drafted/accepted counts;
    no page leaks."""
    ref, mine, base = ref_engine(k), port_engine(k), port_engine()
    ties = 0
    for trace in (H.shared_prefix_cow_trace(),
                  H.random_greedy_trace(np.random.default_rng(k))):
        before = (ref.spec_stats["drafted"], ref.spec_stats["accepted"],
                  mine.spec_stats["drafted"], mine.spec_stats["accepted"])
        ref_log, my_log = [], []
        stops = [record_drafts(ref, ref_log), record_drafts(mine, my_log)]
        try:
            ref_toks = H.run_trace(ref, trace)
            got = run_port(mine, trace)
        finally:
            for stop in stops:
                stop()
        want = {rid: (t, None) for rid, t in ref_toks.items()}
        n = near_ties(trace, {r: (t, None) for r, (t, _) in got.items()},
                      want)
        n += near_ties(trace, got, run_port(base, trace))
        if n == 0:
            n = drafter_ties(trace, ref, ref_log, my_log, ref_toks)
        if n == 0:
            after = (ref.spec_stats["drafted"], ref.spec_stats["accepted"],
                     mine.spec_stats["drafted"], mine.spec_stats["accepted"])
            d = [a - b for a, b in zip(after, before)]
            assert d[:2] == d[2:] and d[0] > 0, d
        ties += n
        H.audit(ref)
        audit(mine)
    assert ties <= 1
    st = mine.spec_stats
    assert 0 <= st["accepted"] <= st["drafted"] == sum(st["drafted_by_slot"])
    assert st["spec_steps"] > 0 and st["draft_seconds"] > 0


def test_spec_eos_mid_speculation_truncates_like_non_spec():
    """``eos_id`` set to a token the trace generates mid-request: the spec
    engine (spec_k 4) stops each request where the non-spec engine does,
    with finish_reason "eos", dropping accepted drafts past the eos."""
    trace = H.random_greedy_trace(np.random.default_rng(8)) + [
        ((0, 1, 2), 6, 0)]
    first = run_port(port_engine(), trace)
    eos = next(t[2] for t, _ in first.values() if len(t) > 3)
    spec, base = port_engine(4, eos_id=eos), port_engine(0, eos_id=eos)
    got, want = run_port(spec, trace), run_port(base, trace)
    assert near_ties(trace, got, want) <= 1
    assert any(r == "eos" and len(t) < trace[rid][1]
               for rid, (t, r) in got.items())
    assert all(t.count(eos) <= 1 for t, _ in got.values())
    audit(spec)


def test_spec_request_at_the_max_len_cap_is_served():
    """plen + max_new_tokens == max_len with spec_k 4: the drafts past
    max_len are dropped (the page slack is capped at max_len) and the
    request is served as the non-spec engine serves it."""
    rng = np.random.default_rng(3)
    prompt = tuple(int(x) for x in rng.integers(0, CFG.vocab_size, 17))
    trace = [(prompt, H.MAX_LEN - len(prompt), 0),
             ((5, 6, 7), 6, 0)]
    spec = port_engine(4)
    got = run_port(spec, trace)
    assert len(got[0][0]) == H.MAX_LEN - len(prompt)
    assert near_ties(trace, got, run_port(port_engine(), trace)) <= 1
    audit(spec)


def test_on_drafter_rolls_back_rejected_positions():
    """The full analog drafter (``ON``: ACAM activations, log-domain DMMul
    and NL-DPE attention, which reads the position track) on a trace with
    rejections: greedy tokens equal the non-spec engine's, and after every
    tick no active slot has a valid position-track entry at or past its
    tip (the rollback clip)."""
    eng = port_engine(2, spec_draft=ON)
    seen = []
    step = eng.step

    def checked():
        out = step()
        pos, active = eng._pos.numpy(), eng._active.numpy()
        track = eng.cache["pos"].numpy()
        for s in np.flatnonzero(active):
            assert (track[s, pos[s]:] == -1).all(), (s, track[s], pos[s])
        seen.append(int(active.sum()))
        return out

    eng.step = checked
    try:
        trace = H.shared_prefix_cow_trace(seed=31)
        got = run_port(eng, trace)
    finally:
        del eng.step
    assert sum(seen) > 0
    st = eng.spec_stats
    assert 0 < st["accepted"] < st["drafted"], st
    assert near_ties(trace, got, run_port(port_engine(), trace)) <= 1
    audit(eng)


def test_fused_verifier_at_f32():
    """A FUSED verifier (kernel B's plain version on every gate, NL-DPE
    attention over the cache) at float32 activations: spec tokens equal
    the non-spec FUSED engine's (near-tie guarded)."""
    trace = H.shared_prefix_cow_trace(seed=5)
    spec = port_engine(2, cfg=CFG32, nldpe=FUSED)
    got = run_port(spec, trace)
    want = run_port(port_engine(0, cfg=CFG32, nldpe=FUSED), trace)
    assert got == want
    assert spec.spec_stats["drafted"] > 0
    audit(spec)


def test_sampled_requests_match_repro():
    """Temperature and top-k requests through both spec engines (spec_k
    2): every draw is a threefry draw on the same keys, so the tokens are
    ``repro``'s (as in tests/test_torch_prng.py)."""
    trace = [((3, 1, 2, 0, 1), 6, 0, 0.8, 0), ((2, 2, 1), 5, 1, 1.3, 3),
             ((0, 1), 4, 0, 0.0, 0)]
    want = H.run_trace(H.paged_engine(spec_k=2), trace)
    got = run_port(port_engine(2), trace)
    assert {rid: t for rid, (t, _) in got.items()} == want


# ---------------------------------------------------------------------------
# the spec functions on identical numpy inputs
# ---------------------------------------------------------------------------

def _logits(rng, s, v=50, scale=3.0):
    return rng.normal(size=(s, v)).astype(np.float32) * scale


def _temps():
    return (np.array([0.0, 0.7, 1.3, 0.5], np.float32),
            np.array([0, 0, 3, 64], np.int32))


def test_target_and_residual_probs_match_repro():
    """Softmaxes of the two frameworks round apart by an ulp: 1e-6
    absolute (probabilities <= 1); the greedy one-hot rows are exact."""
    rng = np.random.default_rng(0)
    lg = _logits(rng, 4)
    temp, topk = _temps()
    mine = sampling.target_probs(torch.from_numpy(lg), torch.from_numpy(temp),
                                 torch.from_numpy(topk)).numpy()
    ref = np.array(j_sampling.target_probs(jnp.asarray(lg),
                                           jnp.asarray(temp),
                                           jnp.asarray(topk)))
    np.testing.assert_array_equal(mine[0], ref[0])
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)
    q = np.array(j_sampling.target_probs(jnp.asarray(lg[::-1].copy()),
                                         jnp.asarray(temp),
                                         jnp.asarray(topk)))
    q[1] = ref[1]                      # p == q: the residual falls back to p
    r_mine = sampling.residual_probs(torch.from_numpy(ref),
                                     torch.from_numpy(q)).numpy()
    r_ref = np.asarray(j_sampling.residual_probs(jnp.asarray(ref),
                                                 jnp.asarray(q)))
    np.testing.assert_allclose(r_mine, r_ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(r_mine[1], ref[1])


def test_spec_fold_and_sample_from_probs_match_repro():
    """Keys bitwise, (S,) and (S, J) positions; draws from the same
    probabilities equal ``repro``'s (one-hot rows whatever the key)."""
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (0, 7, 99)])
    pos1 = np.array([3, 0, 17], np.int32)
    pos2 = pos1[:, None] + np.arange(4, dtype=np.int32)
    tk = torch.from_numpy(keys.astype(np.int64))
    fold = jax.jit(j_sampling.spec_fold, static_argnums=2)
    for pos in (pos1, pos2):
        for stream in (sampling.DRAFT_STREAM, sampling.ACCEPT_STREAM,
                       sampling.CORRECT_STREAM):
            ref = np.asarray(fold(jnp.asarray(keys), jnp.asarray(pos),
                                  stream))
            mine = sampling.spec_fold(tk, torch.from_numpy(pos), stream)
            np.testing.assert_array_equal(mine.numpy(), ref.astype(np.int64))
    rng = np.random.default_rng(1)
    probs = np.array(j_sampling.target_probs(
        jnp.asarray(_logits(rng, 3)), jnp.asarray([0.0, 1.0, 0.9]),
        jnp.asarray([0, 0, 5])))
    fk = np.asarray(fold(jnp.asarray(keys), jnp.asarray(pos1),
                         sampling.CORRECT_STREAM))
    ref = np.asarray(jax.jit(j_sampling.sample_from_probs)(
        jnp.asarray(fk), jnp.asarray(probs)))
    mine = sampling.sample_from_probs(torch.from_numpy(fk.astype(np.int64)),
                                      torch.from_numpy(probs))
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert mine[0] == probs[0].argmax()


def test_speculative_accept_matches_repro():
    """Accepted counts and corrections on identical inputs (greedy,
    temperature and top-k rows).  The accept test ``u * q_d < p_d``
    compares softmax outputs that may round an ulp apart between the
    frameworks, so a flipped decision is allowed only where ``repro``'s
    two sides are within 1e-6: every flip is reported with its margin."""
    rng = np.random.default_rng(2)
    s, k, v = 4, 3, 50
    temp, topk = _temps()
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in range(4)])
    pos = np.array([5, 0, 9, 2], np.int32)
    vlogits = rng.normal(size=(s, k + 1, v)).astype(np.float32) * 3
    dlogits = vlogits[:, :k] + rng.normal(size=(s, k, v)).astype(
        np.float32)
    q = np.array(jax.vmap(j_sampling.target_probs, (1, None, None), 1)(
        jnp.asarray(dlogits), jnp.asarray(temp), jnp.asarray(topk)))
    drafts = np.stack([q[:, j].argmax(-1) for j in range(k)], 1).astype(
        np.int32)
    drafts[2, 1] = int(q[2, 1].argmin())       # a certain rejection
    args = (drafts, q, vlogits, temp, topk, keys, pos)
    acc_r, cor_r = (np.asarray(x) for x in jax.jit(
        j_spec.speculative_accept)(*(jnp.asarray(a) for a in args)))
    acc_m, cor_m = spec_decode.speculative_accept(
        *(torch.from_numpy(a.astype(np.int64) if a is keys else a)
          for a in args))
    flips = np.flatnonzero(acc_m.numpy() != acc_r)
    for i in flips:                            # report, never widen
        p = np.asarray(j_sampling.target_probs(
            jnp.asarray(vlogits[i]), jnp.full((k + 1,), temp[i]),
            jnp.full((k + 1,), topk[i])))
        j = min(int(acc_r[i]), int(acc_m[i]))
        u = float(jax.random.uniform(j_sampling.spec_fold(
            jnp.asarray(keys[i:i + 1]), jnp.asarray([pos[i] + 1 + j]),
            j_sampling.ACCEPT_STREAM)[0]))
        gap = abs(u * q[i, j, drafts[i, j]] - p[j, drafts[i, j]])
        assert gap < 1e-6, f"slot {i}: accept flip with margin {gap}"
    same = acc_m.numpy() == acc_r
    np.testing.assert_array_equal(cor_m.numpy()[same], cor_r[same])
    assert acc_r[2] <= 1 and acc_r.max() > 0
    assert acc_m.dtype == torch.int32 and cor_m.dtype == torch.int32


def test_clip_positions_and_emits_tick_major_match_repro():
    """The rollback clip on a slotted position track, bitwise against
    ``repro``'s on its per-layer tracks, for (S,) and () bounds; the
    emits' tick-major layout."""
    rng = np.random.default_rng(4)
    track = rng.integers(-1, 20, (2, 24)).astype(np.int32)
    mask = np.array([True, False])
    j_cache = j_lm.init_model_cache(H.CFG, 2, 24, dtype=jnp.float32,
                                    slotted=True)
    j_cache = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.broadcast_to(jnp.asarray(track), x.shape)
        if j_spec.pos_leaf(p) else x, j_cache)
    for bound in (np.array([7, 3], np.int32), np.int32(11)):
        ref = j_spec.clip_positions(j_cache, jnp.asarray(mask),
                                    jnp.asarray(bound))
        ref_pos = np.asarray(ref["groups"]["b0"]["attn"]["pos"][0])
        mine = {"pos": torch.from_numpy(track.copy())}
        spec_decode.clip_positions(mine, torch.from_numpy(mask),
                                   torch.from_numpy(np.asarray(bound)))
        np.testing.assert_array_equal(mine["pos"].numpy(), ref_pos)
    emits = rng.integers(-1, 9, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        spec_decode.emits_tick_major(torch.from_numpy(emits)),
        j_spec.emits_tick_major(jnp.asarray(emits)))


def test_quantize_draft_params_codes_equal_repro():
    """The drafter's weights: every leaf of the reduced model's float32
    master through the log grid, bitwise ``repro``'s
    ``quantize_draft_params`` (0 code flips: the codes and signs of every
    leaf bitwise; the decoded values within 1 ulp, as ``exp`` rounds one
    ulp apart between the frameworks); the serving copy then casts them
    to the activation dtype."""
    ref = jax.tree_util.tree_leaves(
        j_spec.quantize_draft_params(H.shared_params()))
    grid = J_LD.mag_spec
    mine = spec_decode.quantize_draft_params(_params())
    flat = []

    def walk(x):
        if isinstance(x, dict):
            for key in sorted(x):
                walk(x[key])
        else:
            flat.append(x)
    walk(mine)
    assert len(flat) == len(ref)
    for m, r, w in zip(flat, ref,
                       jax.tree_util.tree_leaves(H.shared_params())):
        code, sign = encode_live(torch.from_numpy(np.array(w)))
        j_code, j_sign = grid.encode(w)
        j_sign = jnp.where(jnp.abs(w) < np.exp(grid.log_lo), 0.0, j_sign)
        np.testing.assert_array_equal(code.numpy(), np.asarray(j_code))
        np.testing.assert_array_equal(sign.numpy(), np.asarray(j_sign))
        np.testing.assert_allclose(m.numpy(), np.asarray(r), rtol=2.4e-7,
                                   atol=0)
    eng = port_engine(2)
    w = eng._draft_params["groups"]["b0"]["ffn"]["up"]
    assert w.dtype == CFG.activation_dtype
    assert torch.equal(w, mine["groups"]["b0"]["ffn"]["up"].to(w.dtype))


def test_publish_committed_matches_repro():
    """``committed_len``: only pages every position of which is committed
    enter the index (published counts and matches equal ``repro``'s); a
    length outside [0, len(tokens)] raises as ``repro``'s does."""
    fp = ("fp",)
    toks = tuple(range(11))
    for committed in (None, 0, 3, 4, 9, 11):
        pools = [PagePool(num_pages=4, page_size=4),
                 JPagePool(num_pages=4, page_size=4)]
        out = []
        for pool in pools:
            pages = pool.alloc(3)
            pool.publish_committed(fp, toks, pages, committed_len=committed)
            out.append((pool.stats["published"], pool.stats["gen_published"],
                        pool.match(fp, toks, peek=True)))
        assert out[0] == out[1], committed
    for bad in (-1, 12):
        for pool in (PagePool(4, 4), JPagePool(4, 4)):
            with pytest.raises(ValueError, match="committed_len"):
                pool.publish_committed(fp, toks, pool.alloc(3),
                                       committed_len=bad)


def test_spec_engine_validates_and_refuses_unported_options():
    with pytest.raises(ValueError, match="spec_k"):
        PagedServeEngine(CFG, _params(), max_slots=1, max_len=8,
                         spec_k=-1, device="cpu")
    # meshes are ported: the exact tables and serve serve; serve_dshard
    # and drift injection under a mesh are refused (ROADMAP A.2's queue)
    from repro_torch.launch.fidelity import DriftInjection
    from repro_torch.launch.mesh import single_device_mesh
    one = single_device_mesh()
    for opt, why in ((dict(mesh=one, rules="serve_dshard"),
                      "item 1: serve_dshard"),
                     (dict(mesh=one, drift=DriftInjection()),
                      "item 4: the async pipeline and drift")):
        with pytest.raises(NotImplementedError, match=why):
            PagedServeEngine(CFG, _params(), max_slots=1, max_len=8,
                             spec_k=2, device="cpu", **opt)
    for rules in ("serve_exact", "serve"):
        eng = PagedServeEngine(CFG, _params(), max_slots=1, max_len=8,
                               spec_k=2, device="cpu", mesh=one,
                               rules=rules)
        assert eng.rules.name == rules
    # the spill tier and prefill buckets are ported: accepted
    eng = PagedServeEngine(CFG, _params(), max_slots=1, max_len=8,
                           spec_k=2, device="cpu", host_cache_pages=4,
                           prefill_buckets=True)
    assert eng.pool.host_pages == 4 and eng._bucket_sizes
    eng = PagedServeEngine(CFG, _params(), max_slots=1, max_len=8,
                           spec_k=1, device="cpu")
    assert eng.spec_draft == ON                # repro's default drafter
    assert port_engine().spec_stats == {"spec_k": 0}


def test_spec_windowed_counters():
    eng = port_engine(1)
    run_port(eng, [((1, 2, 3), 4, 0)])
    st = eng.spec_stats
    assert st["window"]["drafted"] > 0 and st["ewma_acceptance"] is not None
    eng.reset_window()
    st2 = eng.spec_stats
    assert st2["window"]["drafted"] == 0 == st2["window"]["ticks"]
    assert st2["drafted"] == st["drafted"]


def test_cli_spec_serves_on_cpu(capsys):
    from repro_torch.launch.serve import run
    comps = run(["--paged", "--spec", "2", "--device", "cpu", "--requests",
                 "3", "--gen-len", "6", "--prompt-len", "20"])
    assert len(comps) == 3 and all(c.tokens for c in comps)
    assert "speculative:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run(["--spec", "2", "--device", "cpu"])

"""The port's host spill tier and priority preemption (DESIGN.md §13) held
against ``repro`` on the CPU.

* **pool** — ``tests/test_kvpool.py``'s battery (the spill tier's tests
  and the ones before them) run on the port's ``PagePool`` with its own
  assertions, and beside ``repro``'s ``PagePool`` on the same operations
  with every hook call (kind, page, free pages at the call) recorded: the
  logs, the stats, both tiers' node trees and the free lists must be
  equal.
* **engines** — the spill and preempt columns of
  ``tests/test_engine_differential.py`` at float32 activations: the port's
  two-tier engine (8 device pages, 6 host pages) against its own
  unlimited-pool twin and against ``repro``'s two-tier engine on the same
  traces, token for token, greedy, sampled and speculative; the mixed
  priority trace against a never-preempted FIFO twin; telemetry on == off
  with the new events; every trace spills, restores, preempts and resumes.
* **page rows** — ``gather_page_rows``/``scatter_page_rows`` over f32,
  int8 and log8 caches filled from one numpy draw: the rows equal
  ``repro``'s (codes and scales bitwise; decoded int8 bitwise, log8 within
  2 ulps: ``exp``'s ulp, then the scale's rounding), and spill -> restore
  is bitwise.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
import test_engine_differential as JD
import test_kvpool as JP
from repro.core.quantization import kv_decode as j_kv_decode
from repro.launch.engine import PagedServeEngine as JPagedServeEngine
from repro.launch.engine import Request as JRequest
from repro.launch.kvpool import PagePool as JPagePool
from repro.models import lm as j_lm
from repro.nn.attention import gather_page_rows as j_gather
from repro.nn.attention import scatter_page_rows as j_scatter

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import NLDPEConfig
from repro_torch.core.quantization import kv_decode
from repro_torch.launch.engine import PagedServeEngine, Request
from repro_torch.launch.kvpool import PagePool
from repro_torch.models import lm
from repro_torch.nn.attention import gather_page_rows, scatter_page_rows

torch.set_num_threads(1)

CFG32 = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                            activation_dtype=torch.float32)
J_CFG32 = dataclasses.replace(H.CFG, activation_dtype=jnp.float32)
WQ = NLDPEConfig(enabled=False)
SPILL_POOL, HOST_PAGES = JD.SPILL_POOL, JD.HOST_PAGES
SPEC_K = JD.TELEMETRY_SPEC_K

_STATE = {}


# ---------------------------------------------------------------------------
# the pool battery against repro's PagePool
# ---------------------------------------------------------------------------

POOL_TESTS = sorted(n for n, f in vars(JP).items()
                    if n.startswith("test_") and callable(f)
                    and not inspect.signature(f).parameters)


def recording(cls, log: list, pools: list):
    """``cls`` with every hook call logged as (hook, page, free pages when
    it fired, declined) and every instance kept."""

    class Rec(cls):
        def __init__(self, *args, **kw):
            self._hooks = {}
            super().__init__(*args, **kw)
            pools.append(self)

        def _wrap(self, name, fn):
            if fn is None:
                self._hooks[name] = None
                return

            def call(page):
                out = fn(page)
                log.append((name, page, self.free_pages, out is None))
                return out
            self._hooks[name] = call

        on_spill = property(lambda self: self._hooks.get("spill"),
                            lambda self, fn: self._wrap("spill", fn))
        on_evict = property(lambda self: self._hooks.get("evict"),
                            lambda self, fn: self._wrap("evict", fn))

    return Rec


def pool_state(pool) -> dict:
    """Everything observable of a pool: stats, tiers, free list, refcounts
    and each root's tree (key, page, payload, pinned), children sorted."""
    def tree(node):
        return (node.key, node.page, node.payload, node.pinned,
                [tree(c) for _, c in sorted(node.children.items())])
    return {"stats": dict(pool.stats), "free": list(pool._free),
            "ref": pool._ref.tolist(), "host_used": pool.host_used,
            "roots": [(fp, tree(r)) for fp, r in pool._roots.items()]}


@pytest.mark.parametrize("name", POOL_TESTS)
def test_pool_battery_equals_repro(name, monkeypatch):
    """``test_kvpool.<name>`` passes on the port's pool, and the port's and
    ``repro``'s pools give equal hook logs and end states on it."""
    runs = []
    for cls in (JPagePool, PagePool):
        log, pools = [], []
        monkeypatch.setattr(JP, "PagePool", recording(cls, log, pools))
        getattr(JP, name)()
        runs.append((log, [pool_state(p) for p in pools]))
    assert runs[0] == runs[1]
    assert runs[1][1], f"{name} built no pool"


def test_pool_battery_covers_the_spill_tier():
    spill = {"test_spill_then_restore_round_trip",
             "test_on_spill_fires_before_free_on_evict_after",
             "test_host_tier_lru_evicts_least_recently_matched_spill",
             "test_pinned_spilled_nodes_survive_host_pressure",
             "test_restore_validates_order_and_page_state",
             "test_publish_readopts_spilled_chunk",
             "test_fingerprint_isolation_across_tiers",
             "test_spilled_suffix_never_outlives_its_prefix",
             "test_spill_disabled_without_host_budget"}
    assert spill <= set(POOL_TESTS)
    with pytest.raises(ValueError, match="host_pages"):
        PagePool(4, 2, host_pages=-1)


# ---------------------------------------------------------------------------
# engines: the spill and preempt columns
# ---------------------------------------------------------------------------

def _params():
    if "params" not in _STATE:
        _STATE["params"] = from_jax(H.shared_params(), device="cpu")
    return _STATE["params"]


def port(spec_k: int = 0, fresh: bool = False, **over) -> PagedServeEngine:
    """Port engines at f32 (module singletons unless ``fresh``): the
    harness's settings, the weights-only drafter."""
    key = ("port", spec_k, tuple(sorted(over.items())))
    if fresh or key not in _STATE:
        kw = H.engine_kwargs(**{"page_size": H.PAGE,
                                "num_pages": H.NUM_PAGES, **over})
        if spec_k:
            kw.update(spec_k=spec_k, spec_draft=WQ)
        eng = PagedServeEngine(CFG32, _params(), device="cpu", **kw)
        if fresh:
            return eng
        _STATE[key] = eng
    return _STATE[key]


def ref(spec_k: int = 0, **over) -> JPagedServeEngine:
    """``repro``'s engines at f32 (module singletons)."""
    key = ("ref", spec_k, tuple(sorted(over.items())))
    if key not in _STATE:
        kw = H.engine_kwargs(**{"page_size": H.PAGE,
                                "num_pages": H.NUM_PAGES, **over})
        if spec_k:
            kw.update(spec_k=spec_k, spec_draft=H.WQ_DRAFT)
        _STATE[key] = JPagedServeEngine(J_CFG32, H.shared_params(), **kw)
    return _STATE[key]


def spill_port(spec_k: int = 0) -> PagedServeEngine:
    return port(spec_k, num_pages=SPILL_POOL, host_cache_pages=HOST_PAGES)


def spill_ref(spec_k: int = 0) -> JPagedServeEngine:
    return ref(spec_k, num_pages=SPILL_POOL, host_cache_pages=HOST_PAGES)


def to_port(reqs) -> list:
    return [Request(**{f.name: getattr(r, f.name)
                       for f in dataclasses.fields(JRequest)})
            for r in reqs]


def run(eng, trace) -> dict:
    reqs = H.to_requests(trace, eng.tick)
    if isinstance(eng, PagedServeEngine):
        reqs = to_port(reqs)
    comps = eng.run(reqs)
    assert sorted(c.rid for c in comps) == list(range(len(trace)))
    return {c.rid: c.tokens for c in comps}


def run_reqs(eng, make) -> dict:
    reqs = make(eng.tick)
    if isinstance(eng, PagedServeEngine):
        reqs = to_port(reqs)
    return {c.rid: c.tokens for c in eng.run(reqs)}


def audit(eng) -> None:
    assert eng.free_slots == eng.max_slots
    assert not eng._preempted, "preempted requests left unresumed"
    eng.pool.check()
    assert eng.pool.available() == eng.pool.num_pages, "page leak"


def grew(eng, before: dict, *keys) -> None:
    for k in keys:
        assert eng.pool.stats[k] > before[k], f"trace never {k}"


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_spill_restore_tokens_equal_twin_and_repro(kind):
    """The deterministic spill-then-restore trace and oversubscribed random
    traces: the two-tier engine's tokens equal its unlimited-pool twin's
    and ``repro``'s two-tier engine's, bit for bit; spills and restores
    fire; the pools' stats equal ``repro``'s after each trace."""
    eng, twin, jeng = spill_port(), port(), spill_ref()
    if kind == "greedy":
        traces = [JD.spill_restore_trace()] + [
            H.random_greedy_trace(np.random.default_rng(s))
            for s in (0, 2, 3)]
    else:
        traces = [H.random_mixed_trace(np.random.default_rng(s))
                  for s in (10, 12)]
    before = dict(eng.pool.stats)
    for trace in traces:
        got = run(eng, trace)
        audit(eng)
        assert got == run(twin, trace), "spill engine != unlimited twin"
        assert got == run(jeng, trace), "spill engine != repro's"
        assert eng.pool.stats == jeng.pool.stats
    if kind == "greedy":
        grew(eng, before, "spilled", "restored")


def test_spill_restore_speculative_column():
    """A spec engine over the two-tier pool: restored pages feed the
    drafts and the verify; tokens equal the unlimited spec twin's and
    ``repro``'s two-tier spec engine's, and so do the pool stats and the
    acceptance counters."""
    eng, jeng = spill_port(SPEC_K), spill_ref(SPEC_K)
    before = dict(eng.pool.stats)
    trace = JD.spill_restore_trace()
    got = run(eng, trace)
    audit(eng)
    grew(eng, before, "spilled", "restored")
    assert eng.spec_stats["drafted"] > 0
    assert got == run(port(SPEC_K), trace)
    assert got == run(jeng, trace)
    assert eng.pool.stats == jeng.pool.stats
    for k in ("drafted", "accepted"):
        assert eng.spec_stats[k] == jeng.spec_stats[k], k


@pytest.mark.parametrize("temps", [(0.0, 0.0), (0.9, 0.0)],
                         ids=["greedy", "sampled"])
def test_spill_preemption_mixed_priority(temps):
    """A priority-2 arrival preempts the saturated engine's lowest slot
    (state and pages to the host); the victim resumes, and every request —
    greedy and sampled — emits the tokens of a never-preempted FIFO twin
    (priorities stripped, unlimited pool) and of ``repro``'s two-tier
    engine, which preempts and resumes as often."""
    eng, jeng = spill_port(), spill_ref()
    counts = (eng.preempts, eng.resumes)
    jcounts = (jeng.preempts, jeng.resumes)

    def make(base):
        return JD.priority_requests(base, temps)

    got = run_reqs(eng, make)
    assert eng.preempts > counts[0], "high priority never preempted"
    assert eng.resumes > counts[1]
    audit(eng)
    assert got == run_reqs(jeng, make)
    assert (eng.preempts - counts[0], eng.resumes - counts[1]) == \
        (jeng.preempts - jcounts[0], jeng.resumes - jcounts[1])

    def plain(base):
        return [dataclasses.replace(r, priority=0)
                for r in make(base)]

    assert got == run_reqs(port(), plain)
    snap = eng.metrics.snapshot()
    assert snap["tiers"] == {"host_pages": HOST_PAGES,
                             "host_used": eng.pool.host_used,
                             "preempted_waiting": 0,
                             "preempts": eng.preempts,
                             "resumes": eng.resumes}
    assert snap["pool"] == eng.stats


def test_spill_preemption_speculative_column():
    """Preempting a speculating slot: its tokens, and the others', equal
    the unlimited spec twin's FIFO run and ``repro``'s two-tier spec
    engine's."""
    eng, jeng = spill_port(SPEC_K), spill_ref(SPEC_K)
    pre = eng.preempts

    def make(base):
        return JD.priority_requests(base, lens=(7, 6, 6), gens=(6, 6, 3))

    got = run_reqs(eng, make)
    assert eng.preempts > pre
    audit(eng)
    assert got == run_reqs(jeng, make)

    def plain(base):
        return [dataclasses.replace(r, priority=0) for r in make(base)]

    assert got == run_reqs(port(SPEC_K), plain)


def test_spill_telemetry_twin_and_events_equal_repro():
    """Fresh telemetry on/off twins of the two-tier spec engine over the
    spill trace and then the priority trace: tokens, pool stats, tier
    counters and spec counters equal; the instrumented twin records
    spill, restore, preempt and resume events, and its event sequence
    equals ``repro``'s instrumented engine's in every field that is not a
    wall time."""
    wall = {"t", "wall_s", "ttft_s", "tpot_s", "queue_wait_s"}

    def serve(eng):
        out = run(eng, JD.spill_restore_trace())

        def make(base):
            return [dataclasses.replace(r, rid=r.rid + 100)
                    for r in JD.priority_requests(base, lens=(7, 6, 6),
                                                  gens=(6, 6, 3))]
        out.update(run_reqs(eng, make))
        audit(eng)
        return out

    kw = dict(num_pages=SPILL_POOL, host_cache_pages=HOST_PAGES)
    on = port(SPEC_K, fresh=True, telemetry=True, **kw)
    off = port(SPEC_K, fresh=True, **kw)
    jon = JPagedServeEngine(J_CFG32, H.shared_params(), **H.engine_kwargs(
        page_size=H.PAGE, spec_k=SPEC_K, spec_draft=H.WQ_DRAFT,
        telemetry=True, **kw))
    got = serve(on)
    assert got == serve(off) == serve(jon)
    assert on.stats == off.stats == jon.pool.stats
    assert (on.preempts, on.resumes) == (off.preempts, off.resumes) \
        == (jon.preempts, jon.resumes)
    for k in ("drafted", "accepted"):
        assert on.spec_stats[k] == off.spec_stats[k]
    assert on.stats["spilled"] > 0 and on.stats["restored"] > 0
    kinds = {e["ev"] for e in on.telemetry.trace}
    assert {"spill", "restore", "preempt", "resume"} <= kinds, kinds
    mine = [{k: v for k, v in e.items() if k not in wall}
            for e in on.telemetry.trace]
    want = [{k: v for k, v in e.items() if k not in wall}
            for e in jon.telemetry.trace]
    assert mine == want


def test_spill_payload_fork_equals_twin_and_repro():
    """A page-aligned prompt whose whole chain was spilled, asked for again:
    the two leading pages restore and the boundary page forks straight
    from its host payload (a ``cow_fork`` with ``src=-1``); tokens equal
    the unlimited twin's and ``repro``'s two-tier engine's, and so do the
    pool stats."""
    rng = np.random.default_rng(8)
    shared = tuple(int(x) for x in rng.integers(0, H.CFG.vocab_size,
                                                3 * H.PAGE))
    fill = [tuple(int(x) for x in rng.integers(0, 64, n)) for n in (11, 10)]
    trace = [(shared, 2, 0), (fill[0], 6, 4), (fill[1], 6, 0),
             (shared, 3, 20)]
    kw = dict(num_pages=SPILL_POOL, host_cache_pages=HOST_PAGES)
    eng = port(fresh=True, telemetry=True, **kw)
    jeng = JPagedServeEngine(J_CFG32, H.shared_params(), **H.engine_kwargs(
        page_size=H.PAGE, **kw))
    got = run(eng, trace)
    audit(eng)
    forks = [e["src"] for e in eng.telemetry.trace if e["ev"] == "cow_fork"]
    assert forks == [-1], forks
    assert got == run(port(), trace) == run(jeng, trace)
    assert eng.stats == jeng.pool.stats


def test_host_cache_pages_zero_destroys_on_evict():
    """``host_cache_pages=0`` installs no spill hook: an oversubscribed
    pool destroys evicted pages as before, and the tier gauges read 0."""
    eng = port(num_pages=SPILL_POOL)
    assert eng.pool.on_spill is None
    trace = JD.spill_restore_trace()
    got = run(eng, trace)
    audit(eng)
    assert eng.stats["spilled"] == eng.stats["restored"] == 0
    assert eng.stats["evicted"] > 0
    assert got == run(port(), trace)
    assert eng.metrics.snapshot()["tiers"] == {
        "host_pages": 0, "host_used": 0, "preempted_waiting": 0,
        "preempts": 0, "resumes": 0}


# ---------------------------------------------------------------------------
# page rows: gather / scatter against repro, and the host round trip
# ---------------------------------------------------------------------------

def filled_caches(kv_quant, seed=0):
    """A port and a ``repro`` paged cache (2 layers, 12 pages) holding the
    same random K/V (codes and scales for a quantized pool)."""
    cfg = dataclasses.replace(CFG32, kv_cache_dtype=kv_quant or "float32")
    jcfg = dataclasses.replace(J_CFG32, kv_cache_dtype=kv_quant or "float32")
    mine = lm.init_model_cache(cfg, 2, H.MAX_LEN, paged=(12, H.PAGE),
                               device="cpu")
    theirs = j_lm.init_model_cache(jcfg, 2, H.MAX_LEN, dtype=jnp.float32,
                                   paged=(12, H.PAGE))
    leaves = theirs["groups"]["b0"]["attn"]
    rng = np.random.default_rng(seed)
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in mine:
            continue
        shape = tuple(mine[name].shape)
        if mine[name].dtype == torch.int8:
            x = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            x = rng.standard_normal(shape).astype(np.float32)
            if name.endswith("scale"):
                x = np.abs(x) + 0.01
        mine[name].copy_(torch.from_numpy(x))
        leaves[name] = jnp.asarray(x)
    return mine, theirs


@pytest.mark.parametrize("kv_quant", [None, "int8", "log8"])
def test_page_rows_equal_repro_and_round_trip(kv_quant):
    mine, theirs = filled_caches(kv_quant)
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in mine]
    rows = dict(zip(names, gather_page_rows(mine, 5)))
    jleaves = sorted(n for n in theirs["groups"]["b0"]["attn"]
                     if n not in ("pos", "bt"))
    jrows = dict(zip(jleaves, (np.asarray(r) for r in j_gather(theirs, 5))))
    assert sorted(rows) == sorted(jrows)
    for n in names:
        assert rows[n].shape == (CFG32.n_layers,) + jrows[n].shape[1:]
        np.testing.assert_array_equal(rows[n].numpy(), jrows[n])
    if kv_quant:
        for n in ("k", "v"):
            got = kv_decode(rows[n], rows[f"{n}_scale"], kv_quant).numpy()
            # jitted, as repro's engines decode (eager repro rounds the
            # log8 exp argument another way: ROADMAP C)
            want = np.asarray(jax.jit(j_kv_decode, static_argnums=2)(
                jnp.asarray(jrows[n]), jnp.asarray(jrows[f"{n}_scale"]),
                kv_quant))
            # exp rounds an ulp apart (ROADMAP C), the scale's multiply
            # may round that to two
            ulps = np.abs(got.view(np.int32).astype(np.int64)
                          - want.view(np.int32).astype(np.int64))
            assert ulps.max() <= (2 if kv_quant == "log8" else 0)
    # scatter into page 9 in both packages: every pool leaf equal after
    host = [r.to("cpu", copy=True) for r in gather_page_rows(mine, 5)]
    scatter_page_rows(mine, host, 9)
    theirs = j_scatter(theirs, j_gather(theirs, 5), 9)
    for n in names:
        np.testing.assert_array_equal(
            mine[n].numpy(), np.asarray(theirs["groups"]["b0"]["attn"][n]))
    with pytest.raises(ValueError, match="rows"):
        scatter_page_rows(mine, host[:1], 9)
    with pytest.raises(ValueError, match="pool's"):
        scatter_page_rows(mine, [r[0] for r in host], 9)


@pytest.mark.parametrize("kv_quant", [None, "int8", "log8"])
def test_engine_spill_payload_is_a_copy_and_restores_bitwise(kv_quant):
    """The engine's spill hook returns host copies, not views: overwriting
    the page afterwards leaves the payload as it was, and restoring it into
    another page gives that page the original bytes."""
    eng = port(fresh=True, kv_quant=kv_quant, num_pages=SPILL_POOL,
               host_cache_pages=HOST_PAGES)
    run(eng, JD.spill_restore_trace())
    before = [r.clone() for r in gather_page_rows(eng.cache, 2)]
    payload = eng._spill_page(2)
    for leaf in gather_page_rows(eng.cache, 2):
        leaf.fill_(3)
    for got, want in zip(payload, before):
        assert torch.equal(got, want)
        assert got.data_ptr() != want.data_ptr()
    eng._restore_page(payload, 4)
    for got, want in zip(gather_page_rows(eng.cache, 4), before):
        assert torch.equal(got, want)

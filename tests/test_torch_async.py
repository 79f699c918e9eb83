"""The port's async pipeline (``launch/async_engine.py``) and prefill
buckets (DESIGN.md §14) held against the port's tick loop and ``repro``
on the CPU.

* **the async column** of ``tests/test_engine_differential.py`` (without
  the sharded case) at float32 activations: the pipeline over a bucketed
  engine emits the plain tick loop's tokens — slotted and paged, greedy,
  sampled, speculative, spill and preemption — and ``repro``'s async
  engine's; an instrumented pipeline records the tick loop's lifecycle
  events plus its dispatch and drain phases.
* **buckets**: the port's ladder equals ``repro``'s ``_build_buckets`` for
  the same arguments; a bucketed sync engine equals the plain one and
  counts its pad chunks.
* **the streaming API** (``tests/test_async_engine.py``): submit/results,
  reuse across traces, duplicate rids, caller-side validation, errors on
  the scheduler and drain threads raised on the caller, close/restart,
  the ``"async"`` metrics group, ``drain_depth``.
* **the CLI**: ``repro``'s incoherent flag sets exit 2 here too (all but
  ``--mesh``, which the port does not have), and so do the new flags'.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
import test_engine_differential as JD
from repro.launch.async_engine import AsyncServeEngine as JAsync
from repro.launch.engine import PagedServeEngine as JPagedServeEngine
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import NLDPEConfig
from repro_torch.launch.async_engine import AsyncServeEngine
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine

torch.set_num_threads(1)

CFG32 = dataclasses.replace(get_config("qwen2_5_3b", reduced=True),
                            activation_dtype=torch.float32)
J_CFG32 = dataclasses.replace(H.CFG, activation_dtype=jnp.float32)
WQ = NLDPEConfig(enabled=False)
SPEC_K = JD.TELEMETRY_SPEC_K
SPILL = dict(num_pages=JD.SPILL_POOL, host_cache_pages=JD.HOST_PAGES)

_STATE = {}


def _params():
    if "params" not in _STATE:
        _STATE["params"] = from_jax(H.shared_params(), device="cpu")
    return _STATE["params"]


def sync(kind: str = "paged", spec_k: int = 0, **over):
    """Port tick-loop engines at f32 (module singletons)."""
    key = ("sync", kind, spec_k, tuple(sorted(over.items())))
    if key not in _STATE:
        if kind == "slotted":
            eng = ServeEngine(CFG32, _params(), device="cpu",
                              **H.engine_kwargs(**over))
        else:
            kw = H.engine_kwargs(**{"page_size": H.PAGE,
                                    "num_pages": H.NUM_PAGES, **over})
            if spec_k:
                kw.update(spec_k=spec_k, spec_draft=WQ)
            eng = PagedServeEngine(CFG32, _params(), device="cpu", **kw)
        _STATE[key] = eng
    return _STATE[key]


def pipeline(kind: str = "paged", spec_k: int = 0, drain_depth: int = 4,
             **over) -> AsyncServeEngine:
    """The async pipeline over the bucketed twin of ``sync(...)``."""
    key = ("async", kind, spec_k, drain_depth, tuple(sorted(over.items())))
    if key not in _STATE:
        eng = sync(kind, spec_k, prefill_buckets=True, **over)
        _STATE[key] = AsyncServeEngine(eng, drain_depth=drain_depth)
    return _STATE[key]


def ref_async(kind: str = "paged", **over) -> JAsync:
    """``repro``'s async pipeline at f32 over its AOT-bucketed engine."""
    key = ("ref", kind, tuple(sorted(over.items())))
    if key not in _STATE:
        if kind == "slotted":
            eng = JServeEngine(J_CFG32, H.shared_params(),
                               **H.engine_kwargs(prefill_buckets=True,
                                                 **over))
        else:
            eng = JPagedServeEngine(J_CFG32, H.shared_params(),
                                    **H.engine_kwargs(**{
                                        "page_size": H.PAGE,
                                        "num_pages": H.NUM_PAGES,
                                        "prefill_buckets": True, **over}))
        _STATE[key] = JAsync(eng)
    return _STATE[key]


def port_reqs(reqs) -> list:
    return [Request(**{f.name: getattr(r, f.name)
                       for f in dataclasses.fields(JRequest)})
            for r in reqs]


def is_port(eng) -> bool:
    return isinstance(eng, (AsyncServeEngine, ServeEngine))


def run(eng, trace) -> dict:
    reqs = H.to_requests(trace, eng.tick)
    comps = eng.run(port_reqs(reqs) if is_port(eng) else reqs)
    assert sorted(c.rid for c in comps) == list(range(len(trace)))
    return {c.rid: c.tokens for c in comps}


def audit(eng) -> None:
    assert eng.free_slots == eng.max_slots
    assert not eng._preempted
    eng.pool.check()
    assert eng.pool.available() == eng.pool.num_pages


def _trace(seed):
    return H.random_greedy_trace(np.random.default_rng(seed))


# ---------------------------------------------------------------------------
# the async column
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["slotted", "paged"])
def test_async_greedy_equals_tick_loop_and_repro(kind):
    a = pipeline(kind)
    for seed in (0, 1, 2):
        trace = _trace(seed)
        got = run(a, trace)
        assert got == run(sync(kind), trace), f"seed {seed}"
        assert got == run(ref_async(kind), trace), f"seed {seed}"
        if kind == "paged":
            audit(a.engine)
    assert not a.engine.aot_prefill and a.engine._bucket_sizes


def test_async_sampled_equals_tick_loop_and_repro():
    for seed in (10, 11, 12):
        trace = H.random_mixed_trace(np.random.default_rng(seed))
        got = run(pipeline("paged"), trace)
        assert got == run(sync("paged"), trace)
        assert got == run(ref_async("paged"), trace)
        assert run(pipeline("slotted"), trace) == run(sync("slotted"), trace)
        audit(pipeline("paged").engine)


def test_async_speculative_column():
    """Spec ticks arrive on the host already; the pipeline overlaps only
    admission and decode around them, and tokens stay the sync spec
    engine's (shared-prefix COW trace included)."""
    a = pipeline("paged", SPEC_K)
    for trace in (_trace(3), H.shared_prefix_cow_trace()):
        assert run(a, trace) == run(sync("paged", SPEC_K), trace)
        audit(a.engine)
    assert a.engine.spec_stats["drafted"] > 0


def test_async_spill_preemption_column():
    """The two-tier engine through the pipeline: spill/restore traffic and
    a priority preemption — the flush before admission keeps the scheduler
    from preempting or re-tenanting slots whose finishes sit un-harvested
    in the drain queue.  Tokens equal the sync two-tier engine's and
    ``repro``'s two-tier async engine's."""
    a = pipeline("paged", **SPILL)
    trace = JD.spill_restore_trace()
    before = dict(a.engine.pool.stats)
    got = run(a, trace)
    audit(a.engine)
    assert a.engine.pool.stats["spilled"] > before["spilled"]
    assert a.engine.pool.stats["restored"] > before["restored"]
    assert got == run(sync("paged", **SPILL), trace)
    assert got == run(ref_async("paged", **SPILL), trace)
    pre, res = a.engine.preempts, a.engine.resumes
    got = {c.rid: c.tokens
           for c in a.run(port_reqs(JD.priority_requests(a.tick)))}
    assert a.engine.preempts > pre and a.engine.resumes > res
    audit(a.engine)
    s = sync("paged", **SPILL)
    assert {c.rid: c.tokens for c in s.run(
        port_reqs(JD.priority_requests(s.tick)))} == got
    j = ref_async("paged", **SPILL)
    assert {c.rid: c.tokens for c in j.run(
        JD.priority_requests(j.tick))} == got


def test_async_telemetry_twin():
    """An instrumented pipeline emits the plain tick loop's tokens and
    records the lifecycle events the tick loop records, plus its dispatch
    and drain phase walls."""
    trace = _trace(4)
    a = pipeline("paged", telemetry=True)
    a.telemetry.reset()
    assert run(a, trace) == run(sync("paged"), trace)
    audit(a.engine)
    s = a.telemetry.summary()
    assert s["requests_finished"] == len(trace)
    assert s["ttft_s"]["count"] == len(trace)
    assert {"dispatch", "drain", "decode", "admission"} <= set(s["phases"])
    kinds = {e["ev"] for e in a.telemetry.trace}
    assert {"enqueue", "admit", "first_token", "finish",
            "admission_wave", "decode_block"} <= kinds


def test_async_drain_depth_one_and_many_agree():
    """Depth 1 (no overlap) and 2 give the tick loop's tokens; each wrapper
    owns a fresh engine (one scheduler thread per engine) and is closed."""
    trace = _trace(6)
    want = run(sync("paged"), trace)
    for depth in (1, 2):
        eng = PagedServeEngine(CFG32, _params(), device="cpu",
                               prefill_buckets=True, **H.engine_kwargs(
                                   page_size=H.PAGE, num_pages=H.NUM_PAGES))
        a = AsyncServeEngine(eng, drain_depth=depth)
        assert run(a, trace) == want
        assert a.metrics.snapshot()["async"]["max_inflight"] <= depth
        a.close()


# ---------------------------------------------------------------------------
# prefill buckets
# ---------------------------------------------------------------------------

def repro_buckets(spec, *, max_len, chunk, slots=2):
    """``repro``'s ``ServeEngine._build_buckets`` on a stand-in engine
    whose mesh is set: it then builds lazy jits and compiles nothing."""
    stub = types.SimpleNamespace(
        prefill_chunk=min(chunk, max_len), max_slots=slots, max_len=max_len,
        cache={}, mesh=object(), _bucket_fns={}, _ctx=lambda f: f,
        _build_bucket_fn=lambda n: (lambda *a: None))
    JServeEngine._build_buckets(stub, spec)
    return stub._bucket_sizes


@pytest.mark.parametrize("spec", [True, (3, 2, 99), (1,), (0, -4, 5),
                                  (6, 6), range(1, 9)],
                         ids=["auto", "clamp", "one", "low", "dup", "all"])
@pytest.mark.parametrize("max_len,chunk", [(24, 4), (1024, 64), (100, 16),
                                           (16, 64)])
def test_bucket_table_equals_repro(spec, max_len, chunk):
    eng = types.SimpleNamespace(max_len=max_len,
                                prefill_chunk=min(chunk, max_len))
    assert ServeEngine._bucket_table(eng, spec) == \
        repro_buckets(spec, max_len=max_len, chunk=chunk)


def test_bucketed_sync_engine_pads_and_matches():
    """A sync engine with explicit buckets (2, 3, max): waves that fit a
    bucket exactly pad nothing, a 4-chunk wave pads to 6, and the tokens
    equal the plain engine's; the engine gauges report both numbers."""
    explicit = sync("slotted", prefill_buckets=(3, 2, 99))
    assert explicit._bucket_sizes == [2, 3, 6]
    pad0 = explicit.prefill_pad_chunks
    for trace, pads in (([((0, 1, 2, 3, 4, 5, 6, 7, 8), 3, 0)], 0),
                        ([((0, 1, 2, 3, 4), 3, 0)], 0),
                        ([((0,) * 13, 3, 0)], 2)):
        assert run(explicit, trace) == run(sync("slotted"), trace)
        assert explicit.prefill_pad_chunks == pad0 + pads
        pad0 = explicit.prefill_pad_chunks
    # not sync("paged", prefill_buckets=True): an async wrapper's scheduler
    # thread owns that engine
    eng = sync("paged", prefill_buckets=(1, 2, 4))
    assert eng._bucket_sizes == sync("paged", prefill_buckets=(1, 2, 4))\
        ._bucket_table(True)
    for seed in (0, 6):
        trace = _trace(seed)
        assert run(eng, trace) == run(sync("paged"), trace)
        audit(eng)
    st = eng.metrics.snapshot()["engine"]
    assert st["prefill_buckets"] == len(eng._bucket_sizes) == 4
    assert st["prefill_pad_chunks"] == eng.prefill_pad_chunks


# ---------------------------------------------------------------------------
# the streaming API
# ---------------------------------------------------------------------------

def test_async_streaming_submit_results():
    trace = _trace(7)
    want = run(sync("slotted"), trace)
    a = pipeline("slotted")
    for r in port_reqs(H.to_requests(trace, a.tick)):
        a.submit(r)
    got = {c.rid: c.tokens for c in a.results(timeout=120.0)}
    assert got == want
    assert list(a.results(timeout=0.2)) == []


def test_async_run_reusable_and_close_restarts():
    a = pipeline("slotted")
    for seed in (8, 9):
        trace = _trace(seed)
        assert run(a, trace) == run(sync("slotted"), trace)
    a.close()
    a.close()
    trace = _trace(14)
    assert run(a, trace) == run(sync("slotted"), trace)


def test_async_duplicate_rid_rejected():
    a = pipeline("slotted")
    reqs = port_reqs(H.to_requests([((0, 1, 2), 4, 0), ((2, 1), 3, 0)],
                                   a.tick))
    a.submit(reqs[0])
    with pytest.raises(ValueError, match="already in flight"):
        a.submit(Request(rid=reqs[0].rid, tokens=(1,), max_new_tokens=2,
                         arrival=a.tick))
    a.submit(reqs[1])
    assert sorted(c.rid for c in a.results(timeout=120.0)) == [0, 1]
    with pytest.raises(ValueError, match="duplicate rids"):
        a.run([Request(rid=0, tokens=(0,), max_new_tokens=2),
               Request(rid=0, tokens=(2,), max_new_tokens=2)])


def test_async_caller_side_validation_keeps_pipeline_clean():
    a = pipeline("slotted")
    with pytest.raises(ValueError):
        a.submit(Request(rid=999, tokens=tuple(range(H.MAX_LEN + 4)),
                         max_new_tokens=2, arrival=a.tick))
    trace = _trace(13)
    assert run(a, trace) == run(sync("slotted"), trace)


def test_async_scheduler_error_propagates_to_caller():
    """A deadlocked schedule (admission shut) raises on the scheduler
    thread and reaches the caller as RuntimeError with the cause chained,
    never a hang."""
    eng = sync("slotted")
    wrapper = AsyncServeEngine(eng)
    orig = eng._can_admit
    eng._can_admit = lambda waiting: False
    try:
        with pytest.raises(RuntimeError) as ei:
            wrapper.run([Request(rid=0, tokens=(0, 1), max_new_tokens=2,
                                 arrival=eng.tick)])
        assert "deadlock" in str(ei.value.__cause__)
    finally:
        del eng._can_admit
    assert eng._can_admit == orig


def test_async_drain_error_propagates():
    """An error on the drain thread travels the harvest queue and is
    raised on the caller; the pipeline stays failed (a fresh engine: the
    poisoned run leaves a slot un-harvested)."""
    eng = ServeEngine(CFG32, _params(), device="cpu", **H.engine_kwargs())
    wrapper = AsyncServeEngine(eng)
    wrapper._harvest_q.put(RuntimeError("drain died"))
    with pytest.raises(RuntimeError):
        wrapper.run([Request(rid=0, tokens=(0, 1), max_new_tokens=2,
                             arrival=eng.tick)])
    with pytest.raises(RuntimeError):
        wrapper.submit(Request(rid=1, tokens=(0,), max_new_tokens=2,
                               arrival=eng.tick))


def test_async_metrics_group_counters():
    a = pipeline("slotted")
    n = len(_trace(15))
    before = a.metrics.snapshot()["async"]["completed"]
    run(a, _trace(15))
    st = a.metrics.snapshot()["async"]
    assert st["submitted"] == st["completed"] == before + n
    assert st["dispatched_ticks"] >= 1
    assert 1 <= st["max_inflight"] <= st["drain_depth"] == a.drain_depth


def test_async_drain_depth_validation():
    with pytest.raises(ValueError, match="drain_depth"):
        AsyncServeEngine(sync("slotted"), drain_depth=0)


# ---------------------------------------------------------------------------
# the CLI's incoherent flag sets (argument validation only: no model work)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--continuous", "--paged"],
    ["--async-serve"],                       # engine flag, lockstep path
    ["--telemetry"],
    ["--metrics"],
    ["--slots", "8"],
    ["--spec", "2"],                         # paged flag, lockstep path
    ["--continuous", "--spec", "2"],         # paged flag, wrong engine
    ["--continuous", "--kv-quant", "log8"],
    ["--continuous", "--priority", "2"],
    ["--continuous", "--host-cache-pages", "4"],
    ["--host-cache-pages", "4"],
    ["--profile-dir", "/tmp/x", "--continuous"],  # dir without ticks
    ["--continuous", "--python-loop"],
    ["--paged", "--batch", "2"],
    ["--paged", "--drift", "0.5"],           # drift without --spec
    ["--mesh", "1,1"],                       # engine flag, lockstep path
])
def test_async_serve_cli_rejects_incoherent_flags(argv):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as ei:
        serve.run(argv + ["--device", "cpu"])
    assert ei.value.code == 2


def test_async_concurrent_submitters_stress():
    """More submitting threads than cores, a shortened switch interval:
    every request completes exactly once, the pending set drains and the
    counters balance (a lost update to the pending set or a counter would
    leave ``results`` waiting or the counts unequal).  Each wrapper owns a
    fresh engine; every join is bounded."""
    import os
    import sys
    import threading
    eng = ServeEngine(CFG32, _params(), device="cpu", **H.engine_kwargs())
    a = AsyncServeEngine(eng)
    n_threads = max(8, (os.cpu_count() or 1) + 2)
    per = 2
    start = threading.Barrier(n_threads)
    errors = []

    def submitter(t):
        try:
            start.wait(timeout=60)
            for k in range(per):
                a.submit(Request(rid=t * per + k, tokens=(t % 3, k % 3, 1),
                                 max_new_tokens=2, arrival=0))
        except BaseException as exc:       # reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        got = [c.rid for c in a.results(timeout=120.0)]
    finally:
        sys.setswitchinterval(old)
        a.close()
    assert not errors, errors
    assert sorted(got) == list(range(n_threads * per))
    st = a.metrics.snapshot()["async"]
    assert st["submitted"] == st["completed"] == n_threads * per
    assert not a._pending

"""The port's serve observability (``repro_torch/obs``, the engines' telemetry
hooks and metrics registry) held against ``repro.obs`` and ``repro``'s
engines on the CPU.

* **obs units** — the same calls on the same fake clock through the port's
  and ``repro.obs``'s classes give equal summaries, percentiles, snapshots
  and Prometheus text, and JSONL flushes equal byte for byte; the ring's
  drop count, schema rejection and thread safety; the profiler's recorded
  failure.
* **engines** — telemetry on == off token for token (slotted, paged and
  paged-spec engines, greedy and sampled); the port's paged ``OFF`` event
  sequence equals ``repro``'s at float32 activations in every field that
  is not a wall time; the registry's groups ``==`` the legacy dicts;
  per-request accepted counts sum to the engine totals.
"""
import dataclasses
import json
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_harness as H
from repro import obs as j_obs
from repro.launch.engine import PagedServeEngine as JPagedServeEngine

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core.engine import NLDPEConfig
from repro_torch.launch.engine import PagedServeEngine, Request, ServeEngine

torch.set_num_threads(1)

CFG = get_config("qwen2_5_3b", reduced=True)
CFG32 = dataclasses.replace(CFG, activation_dtype=torch.float32)
J_CFG32 = dataclasses.replace(H.CFG, activation_dtype=jnp.float32)
WQ = NLDPEConfig(enabled=False)
# event fields that hold wall-clock readings (never equal across runs)
WALL = {"t", "wall_s", "ttft_s", "tpot_s", "queue_wait_s"}

_STATE = {}


def fake_clock(step=0.25):
    return iter(np.arange(0.0, 1e4, step)).__next__


def both(name, *args, **kw):
    """The port's and ``repro.obs``'s instance of ``name``."""
    return (getattr(obs, name)(*args, **kw),
            getattr(j_obs, name)(*args, **kw))


# ---------------------------------------------------------------------------
# obs units against repro.obs
# ---------------------------------------------------------------------------

def test_schema_and_exports_equal_repro():
    assert obs.EVENT_SCHEMA == j_obs.EVENT_SCHEMA
    assert obs.SCHEMA_VERSION == j_obs.SCHEMA_VERSION == 2
    assert obs.telemetry.BASE_FIELDS == j_obs.telemetry.BASE_FIELDS
    assert sorted(obs.__all__) == sorted(j_obs.__all__)


def test_bounded_log_ring_and_drop_count_match_repro():
    for log in both("BoundedLog", capacity=3):
        for i in range(7):
            log.append(i)
        assert list(log) == [4, 5, 6] and log[0] == 4
        assert len(log) == 3 and log.dropped == 4
        log.clear()
        assert len(log) == 0 and log.dropped == 0
    for mod in (obs, j_obs):
        with pytest.raises(ValueError, match="capacity"):
            mod.BoundedLog(capacity=0)


def test_event_trace_schema_and_jsonl_bytes_match_repro(tmp_path):
    """Rejections (unknown kind, missing and extra fields) raise in both
    without burning a sequence number; a ring overflow counts its drops;
    the JSONL flushes are equal byte for byte."""
    paths = []
    for mod in (obs, j_obs):
        tr = mod.EventTrace(capacity=3, clock=fake_clock())
        tr.emit("enqueue", 3, rid=7)
        with pytest.raises(ValueError, match="unknown event kind"):
            tr.emit("nope", 0)
        with pytest.raises(ValueError, match="fields"):
            tr.emit("enqueue", 0)
        with pytest.raises(ValueError, match="fields"):
            tr.emit("enqueue", 0, rid=1, extra=2)
        assert tr.emit("enqueue", 4, rid=8)["seq"] == 1
        tr.emit("admit", 5, rid=8, slot=1, prompt_len=4, reuse=0,
                queue_wait_ticks=1)
        tr.emit("fidelity", 6, kind="backoff", spec_k=2, ewma=0.4,
                vclock_s=12.5)
        tr.emit("decode_block", 7, n_active=2, block=4, wall_s=0.5)
        assert tr.dropped == 2 and len(tr) == 3
        path = tmp_path / f"{mod.__name__}.jsonl"
        assert tr.flush_jsonl(path) == 3
        assert len(tr) == 3                 # a flush observes
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    meta = json.loads(paths[0].read_text().splitlines()[0])
    assert meta == {"ev": "meta", "schema_version": 2, "events": 3,
                    "dropped": 2}


@pytest.mark.parametrize("window", [10, 4096])
def test_percentiles_match_repro(window):
    """Under the window the summary is exact (numpy's percentile); above it
    the freshest ``window`` samples; both packages give equal dicts."""
    rng = np.random.default_rng(5)
    vals = rng.exponential(size=300)
    mine, ref = both("Percentiles", window)
    assert mine.summary() == ref.summary()          # empty: None-filled
    for v in vals:
        mine.add(v)
        ref.add(v)
    assert mine.summary() == ref.summary()
    tail = vals[-window:]
    for q in (50, 90, 99):
        assert mine.summary()[f"p{q}"] == float(np.percentile(tail, q))
    mine.reset()
    ref.reset()
    assert mine.summary() == ref.summary()
    with pytest.raises(ValueError):
        obs.Percentiles(0)


def test_phase_timers_and_request_records_match_repro():
    snaps = []
    for mod in (obs, j_obs):
        t = mod.PhaseTimers(clock=iter([0.0, 1.5, 2.0, 2.25]).__next__)
        assert t.add("decode", t.now()) == 1.5
        t.add("decode", t.now())
        t.record("draft", 0.125)
        snaps.append(t.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["decode"] == {"seconds": 1.75, "calls": 2}
    recs = []
    for mod in (obs, j_obs):
        r = mod.RequestRecord(rid=1, enqueue_s=10.0, enqueue_tick=0)
        derived = [(r.ttft_s, r.tpot_s, r.queue_wait_s, r.acceptance)]
        r.admit_s, r.admit_tick, r.first_token_s = 10.5, 4, 10.75
        r.finish_s, r.finish_tick = 12.75, 9
        r.n_tokens, r.drafted, r.accepted = 5, 8, 6
        derived.append((r.ttft_s, r.tpot_s, r.queue_wait_s,
                        r.queue_wait_ticks, r.acceptance))
        r.n_tokens = 1
        derived.append(r.tpot_s)
        recs.append(derived)
    assert recs[0] == recs[1]
    assert recs[0][1] == (0.75, 0.5, 0.5, 4, 0.75)


def _drive_facade(tel) -> None:
    tel.enqueue(1, tick=0)
    tel.enqueue(1, tick=0)                  # duplicate: silent
    tel.tick_boundary(0)
    tel.admit(1, tick=2, slot=0, prompt_len=4, reuse=2, pages_held=3)
    tel.first_token(1, tick=2)
    tel.first_token(1, tick=3)              # only the first counts
    tel.event("cow_fork", 2, src=3, dst=5)
    tel.phases.add("admission", tel.phases.now())
    tel.tick_boundary(2)
    tel.finish(1, tick=8, reason="length", n_tokens=3, drafted=6,
               accepted=4)
    tel.admit(9, tick=4, slot=1, prompt_len=2)       # synthesized enqueue
    tel.finish(9, tick=5, reason="eos", n_tokens=1)
    tel.finish(9, tick=5, reason="eos", n_tokens=1)  # ignored
    tel.event("eviction", 6, page=2)


def test_telemetry_facade_on_fake_clock_matches_repro(tmp_path):
    tels = [mod.Telemetry(clock=fake_clock(), capacity=8)
            for mod in (obs, j_obs)]
    for tel in tels:
        _drive_facade(tel)
    mine, ref = tels
    assert mine.summary() == ref.summary()
    assert list(mine.trace) == list(ref.trace)
    assert ([dataclasses.asdict(r) for r in mine.records]
            == [dataclasses.asdict(r) for r in ref.records])
    paths = [tmp_path / "mine.jsonl", tmp_path / "ref.jsonl"]
    for tel, path in zip(tels, paths):
        tel.flush_jsonl(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    s = mine.summary()
    assert s["requests_finished"] == 2 and s["ticks"] == 2
    assert s["events_dropped"] > 0          # capacity 8 overflowed
    for tel in tels:
        tel.reset()
    assert mine.summary() == ref.summary()
    assert len(mine.trace) == 0 and mine.summary()["requests_finished"] == 0


def test_metrics_registry_matches_repro():
    regs = [mod.MetricsRegistry() for mod in (obs, j_obs)]
    for reg in regs:
        c = reg.counter("reqs", "requests served")
        c.inc()
        c.inc(6)
        g = reg.gauge("depth")
        g.set(3)
        g.dec()
        g.inc(0.5)
        reg.gauge("lazy", fn=lambda: 42)
        h = reg.histogram("lat", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v)
        reg.histogram("lat_default").observe(0.003)
        reg.register_group("pool", lambda: {
            "hits": 3, "miss_rate": 0.25, "tag": "ignored", "flag": True,
            "np": np.int64(4), "key-with-dash": 1.5})
        reg.register_group("listy", lambda: [1, 2])
        with pytest.raises(ValueError, match="duplicate"):
            reg.counter("reqs")
        with pytest.raises(ValueError, match="identifier"):
            reg.counter("bad-name")
        with pytest.raises(ValueError, match="decrease"):
            c.inc(-1)
        with pytest.raises(ValueError, match="increasing"):
            reg.histogram("bad", buckets=(1.0, 0.5))
    mine, ref = regs
    assert mine.snapshot() == ref.snapshot()
    assert mine.prometheus_text() == ref.prometheus_text()
    assert mine.prometheus_text(prefix="x") == ref.prometheus_text(prefix="x")
    text = mine.prometheus_text()
    assert "nldpe_reqs 7" in text and "tag" not in text
    assert "nldpe_pool_key_with_dash 1.5" in text


def test_obs_accumulators_are_thread_safe():
    """Phase timers, percentiles and the event trace hammered from more
    threads than this host has cores, with a short switch interval: no
    update is lost and no sequence number is used twice."""
    timers, perc = obs.PhaseTimers(), obs.Percentiles(window=128)
    trace = obs.EventTrace(capacity=256)
    n, threads_n = 2000, 8
    start = threading.Barrier(threads_n)

    def hammer(i):
        start.wait()
        for k in range(n):
            timers.record("drain", 0.001)
            perc.add(float(k))
            trace.emit("enqueue", k, rid=i * n + k)
            if k % 256 == 0:
                timers.snapshot()
                perc.summary()
                list(trace)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = timers.snapshot()["drain"]
    assert snap["calls"] == threads_n * n
    assert perc.count == threads_n * n
    assert np.isclose(perc.total, threads_n * sum(range(n)))
    assert len(trace) + trace.dropped == threads_n * n
    seqs = [e["seq"] for e in trace]
    assert len(set(seqs)) == len(seqs)


def test_tick_profiler_exports_or_records_its_failure(tmp_path,
                                                      monkeypatch):
    """On the CPU the profiler traces N ticks and writes a Chrome trace; a
    profiler that cannot start is warned about once and recorded in the
    summary, and ticks go on."""
    with pytest.raises(ValueError):
        obs.TickProfiler(str(tmp_path), 0)
    tel = obs.Telemetry(profile_ticks=2, profile_dir=str(tmp_path / "p"))
    for i in range(4):
        tel.tick_boundary(i)
    st = tel.summary()["profiler"]
    assert st["done"] and st["error"] is None
    assert json.loads((tmp_path / "p" / "trace.json").read_text())

    import torch.profiler as tp

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tp, "profile", broken)
    tel = obs.Telemetry(profile_ticks=3, profile_dir=str(tmp_path / "q"))
    with pytest.warns(RuntimeWarning, match="no profiler here"):
        tel.tick_boundary(0)
    for i in range(1, 5):
        tel.tick_boundary(i)                # no second warning, no raise
    st = tel.summary()["profiler"]
    assert st["done"] and "no profiler here" in st["error"]
    assert tel.summary()["ticks"] == 5
    tel.close()
    assert "profiler" not in obs.Telemetry().summary()


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _params():
    if "params" not in _STATE:
        _STATE["params"] = from_jax(H.shared_params(), device="cpu")
    return _STATE["params"]


def port_engine(kind: str, telemetry: bool, cfg=CFG):
    key = (kind, telemetry, cfg)
    if key not in _STATE:
        kw = H.engine_kwargs()
        if kind == "slotted":
            eng = ServeEngine(cfg, _params(), telemetry=telemetry,
                              device="cpu", **kw)
        else:
            spec = dict(spec_k=2, spec_draft=WQ) if kind == "spec" else {}
            eng = PagedServeEngine(cfg, _params(), page_size=H.PAGE,
                                   num_pages=H.NUM_PAGES,
                                   telemetry=telemetry, device="cpu",
                                   **spec, **kw)
        _STATE[key] = eng
    return _STATE[key]


def run_port(eng, trace) -> dict:
    reqs = [Request(rid=r.rid, tokens=r.tokens,
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, top_k=r.top_k,
                    arrival=r.arrival)
            for r in H.to_requests(trace, eng.tick)]
    comps = eng.run(reqs)
    assert sorted(c.rid for c in comps) == list(range(len(trace)))
    return {c.rid: c.tokens for c in comps}


@pytest.mark.parametrize("kind", ["slotted", "paged", "spec"])
def test_telemetry_on_equals_off_bitwise(kind):
    """Greedy and sampled requests (temperature, top-k), COW forks and
    evictions: the instrumented engine emits the plain engine's tokens bit
    for bit, and its trace saw every request."""
    on, off = port_engine(kind, True), port_engine(kind, False)
    for trace in (H.shared_prefix_cow_trace(seed=23),
                  H.random_mixed_trace(np.random.default_rng(4))):
        on.telemetry.reset()
        assert run_port(on, trace) == run_port(off, trace)
        s = on.telemetry.summary()
        assert s["requests_finished"] == len(trace) and s["inflight"] == 0
    if kind == "spec":
        assert on.spec_stats == {**off.spec_stats,
                                 "draft_seconds": on.spec_stats[
                                     "draft_seconds"]}


def _fields(e: dict) -> dict:
    return {k: v for k, v in e.items() if k not in WALL}


def test_paged_event_sequence_matches_repro_at_f32():
    """The paged ``OFF`` engine at float32 activations on a trace with radix
    hits, COW forks and evictions: the port's event sequence equals
    ``repro``'s — kind, tick, sequence number and every field that is not
    a wall time — and so do the tokens."""
    rng = np.random.default_rng(23)
    trace = H.shared_prefix_cow_trace(seed=23) + [
        (tuple(int(x) for x in rng.integers(0, 64, n)), 4, 1)
        for n in (13, 10, 14)]
    kw = H.engine_kwargs(page_size=H.PAGE, num_pages=H.NUM_PAGES)
    ref = JPagedServeEngine(J_CFG32, H.shared_params(), telemetry=True, **kw)
    mine = PagedServeEngine(CFG32, _params(), telemetry=True, device="cpu",
                            **kw)
    assert run_port(mine, trace) == H.run_trace(ref, trace)
    got = [_fields(e) for e in mine.telemetry.trace]
    want = [_fields(e) for e in ref.telemetry.trace]
    assert got == want
    kinds = {e["ev"] for e in got}
    assert {"enqueue", "admit", "first_token", "finish", "admission_wave",
            "decode_block", "cow_fork", "eviction"} <= kinds
    s, r = mine.telemetry.summary(), ref.telemetry.summary()
    for key in ("requests_enqueued", "requests_finished", "tokens_emitted",
                "ticks", "inflight"):
        assert s[key] == r[key], key
    assert {p: d["calls"] for p, d in s["phases"].items()} == \
        {p: d["calls"] for p, d in r["phases"].items()}


def test_registry_groups_equal_legacy_dicts():
    eng = port_engine("spec", True)
    eng.telemetry.reset()
    run_port(eng, H.shared_prefix_cow_trace(seed=29))
    snap = eng.metrics.snapshot()
    assert snap["pool"] == eng.stats
    assert snap["spec"] == {**eng.spec_stats,
                            "draft_seconds": snap["spec"]["draft_seconds"]}
    assert snap["fidelity"] == eng.fidelity_stats
    assert snap["fidelity"]["enabled"] is False
    assert snap["tiers"] == {"host_pages": 0, "host_used": 0,
                             "preempted_waiting": 0, "preempts": 0,
                             "resumes": 0}
    assert snap["engine"] == {"tick": eng.tick, "free_slots": eng.max_slots,
                              "active_slots": 0, "inflight": 0,
                              "prefill_buckets": 0, "prefill_pad_chunks": 0}
    assert snap["latency"]["requests_finished"] >= 1
    text = eng.metrics.prometheus_text()
    assert f"nldpe_spec_drafted {eng.spec_stats['drafted']}" in text
    assert f"nldpe_pool_evicted {eng.stats['evicted']}" in text
    assert set(snap) == {"engine", "latency", "pool", "spec", "fidelity",
                         "tiers"}
    slotted = port_engine("slotted", False)
    assert set(slotted.metrics.snapshot()) == {"engine"}


def test_per_request_acceptance_sums_to_totals(tmp_path):
    """Each finished request's drafted/accepted counts are its slot
    counters' deltas over its tenure, so they sum to the trace's totals;
    the flushed trace is schema-valid and reconciles with the
    completions."""
    eng = port_engine("spec", True)
    eng.telemetry.reset()
    before = (eng.spec_stats["drafted"], eng.spec_stats["accepted"])
    trace = H.shared_prefix_cow_trace(seed=31)
    outs = run_port(eng, trace)
    recs = list(eng.telemetry.records)
    assert len(recs) == len(trace)
    drafted, accepted = (eng.spec_stats["drafted"] - before[0],
                         eng.spec_stats["accepted"] - before[1])
    assert sum(r.drafted for r in recs) == drafted > 0
    assert sum(r.accepted for r in recs) == accepted
    for r in recs:
        assert 0 <= r.accepted <= r.drafted
        assert r.n_tokens == len(outs[r.rid]) and r.pages_held >= 1
    s = eng.telemetry.summary()
    for phase in ("admission", "draft", "verify"):
        assert s["phases"][phase]["seconds"] > 0, phase
    path = tmp_path / "serve.jsonl"
    n = eng.telemetry.flush_jsonl(path)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["schema_version"] == obs.SCHEMA_VERSION
    assert len(lines) == n + 1
    for e in lines[1:]:
        assert set(e) == {"ev", "t", "tick", "seq", *obs.EVENT_SCHEMA[e["ev"]]}
    verify = [e for e in lines[1:] if e["ev"] == "spec_verify"]
    assert sum(e["drafted"] for e in verify) == drafted
    for rid, toks in outs.items():
        edges = {e["ev"]: e for e in lines[1:] if e.get("rid") == rid}
        assert edges["finish"]["n_tokens"] == len(toks)
        assert (edges["enqueue"]["t"] <= edges["admit"]["t"]
                <= edges["first_token"]["t"] <= edges["finish"]["t"])


def test_cli_telemetry_flags(tmp_path, capsys):
    from repro_torch.launch.serve import run
    path = tmp_path / "trace.jsonl"
    comps = run(["--paged", "--spec", "2", "--device", "cpu", "--requests",
                 "3", "--gen-len", "6", "--prompt-len", "20",
                 "--trace-out", str(path), "--metrics"])
    out = capsys.readouterr().out
    assert len(comps) == 3
    assert "telemetry: 3 finished" in out
    assert "nldpe_spec_drafted" in out and "nldpe_engine_tick" in out
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["ev"] == "meta" and len(lines) > 1
    comps = run(["--continuous", "--device", "cpu", "--requests", "2",
                 "--gen-len", "4", "--prompt-len", "8", "--telemetry"])
    assert "telemetry: 2 finished" in capsys.readouterr().out
    for bad in (["--telemetry", "--device", "cpu"],
                ["--paged", "--profile-dir", "x", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            run(bad)


@pytest.mark.parametrize("kind", ["slotted", "paged", "spec"])
def test_dropped_engine_is_freed_without_the_cycle_collector(kind):
    """The registry's groups and the pool's eviction hook hold the engine
    weakly: an engine with telemetry, served and then dropped, is freed at
    once (its device memory with it), not when the cyclic collector runs."""
    import gc
    import weakref
    gc.disable()
    try:
        kw = H.engine_kwargs()
        if kind == "slotted":
            eng = ServeEngine(CFG, _params(), telemetry=True, device="cpu",
                              **kw)
        else:
            spec = dict(spec_k=2, spec_draft=WQ) if kind == "spec" else {}
            eng = PagedServeEngine(CFG, _params(), page_size=H.PAGE,
                                   num_pages=H.NUM_PAGES, telemetry=True,
                                   device="cpu", **spec, **kw)
        run_port(eng, H.shared_prefix_cow_trace(seed=37))
        assert eng.metrics.snapshot()["engine"]["free_slots"] == 2
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()

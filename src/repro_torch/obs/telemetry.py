"""Per-request latency tracing + structured serve-event trace (port of
``repro.obs.telemetry``; DESIGN.md §12).

Three cooperating pieces, all host-side and allocation-bounded:

* :class:`EventTrace` — a ring buffer of typed events with a committed
  schema (:data:`EVENT_SCHEMA`).  Every event the engines emit — admission
  waves, decode blocks, the draft/verify split, COW forks, evictions,
  fidelity-ladder transitions, request lifecycle edges — is one dict
  validated against the schema at emit time and flushable as JSONL.  The
  buffer is a ``deque(maxlen=capacity)``: a week-long serve cannot grow it,
  old events fall off the far end and are *counted*, never silently lost.

* :class:`RequestRecord` + :class:`Percentiles` — the per-request
  lifecycle (enqueue → admit → first token → finish) measured on
  ``time.perf_counter`` (monotonic: an NTP step can never produce a
  negative phase) and on the engine's tick clock, yielding TTFT, TPOT,
  queue wait, pages held, and per-request speculative acceptance, folded
  into streaming p50/p90/p99 summaries.

* :class:`PhaseTimers` — wall-clock accumulators per engine phase
  (admission / decode / draft / verify).  **Sync discipline**: timers wrap
  only regions the engine already synchronizes (the device-to-host copy of
  a tick's emitted tokens, the draft phase's device sync); telemetry never
  adds a device sync of its own, so the enabled-vs-disabled token streams
  stay bit-identical.

:class:`TickProfiler` is the opt-in deep lens: capture N engine ticks with
``torch.profiler`` (a Chrome trace, loadable in perfetto) and stop —
serving continues.

The accumulators (:class:`BoundedLog`, :class:`Percentiles`,
:class:`PhaseTimers`) are internally locked: an async serve pipeline
(DESIGN.md §14) has its drain thread fold "drain" phase walls while the
scheduler thread owns every other write, and a reader may snapshot
mid-serve.  The locks bound tiny host-side critical sections — never a
device sync — so the zero-behavioral-footprint bar is untouched.

Nothing here imports from ``launch`` (the engines import *us*), and torch
is imported only inside the profiler, so the module stays a pure
host-side dependency.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from collections import deque

import numpy as np

# ---------------------------------------------------------------------------
# committed event schema
# ---------------------------------------------------------------------------

#: Version stamp written into every JSONL flush; bump on any field change.
#: v2: hierarchical-cache events — "spill" reshaped from its reserved
#: placeholder to per-page, plus "restore"/"preempt"/"resume".
SCHEMA_VERSION = 2

#: Committed schema: event kind -> exactly these payload fields (every
#: event additionally carries the BASE_FIELDS).  ``emit`` validates the
#: field *set* — a call site cannot drift from the schema unnoticed, and a
#: consumer can rely on every field being present.
EVENT_SCHEMA: dict[str, tuple[str, ...]] = {
    # request lifecycle edges
    "enqueue": ("rid",),
    "admit": ("rid", "slot", "prompt_len", "reuse", "queue_wait_ticks"),
    "first_token": ("rid",),
    "finish": ("rid", "reason", "n_tokens", "ttft_s", "tpot_s",
               "queue_wait_s", "pages_held", "drafted", "accepted"),
    # engine phases
    "admission_wave": ("n_reqs", "n_chunks", "wall_s"),
    "decode_block": ("n_active", "block", "wall_s"),
    "spec_draft": ("k", "n_active", "wall_s"),
    "spec_verify": ("k", "drafted", "accepted", "wall_s"),
    # paged-pool lifecycle
    "cow_fork": ("src", "dst"),          # src == -1: forked off a host
    #                                      payload (spilled boundary page)
    "eviction": ("page",),
    # hierarchical cache (DESIGN.md §13): device→host page demotion,
    # host→device promotion, and priority preempt/resume swaps
    "spill": ("page",),
    "restore": ("page",),
    "preempt": ("rid", "slot", "pages", "priority"),
    "resume": ("rid", "slot", "pages"),
    # closed-loop fidelity ladder transitions (DESIGN.md §10)
    "fidelity": ("kind", "spec_k", "ewma", "vclock_s"),
}

#: Fields every event carries: kind, wall timestamp (perf_counter), the
#: engine tick it was observed at, and a monotone sequence number (gaps
#: after a flush reveal ring overwrites).
BASE_FIELDS = ("ev", "t", "tick", "seq")


class BoundedLog:
    """A ring buffer that counts what it drops.

    The shared bounding policy for every unbounded-growth log in the serve
    path (the event trace here, the fidelity ladder's event log): a
    ``deque(maxlen=capacity)`` plus a ``dropped`` counter, so a multi-day
    serve holds memory constant while the telemetry stream still records
    *that* (and how much) history was lost.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"BoundedLog capacity={capacity} must be >= 1")
        self.capacity = capacity
        self._items: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.RLock()   # re-entrant: EventTrace.emit
        #                                  holds it across seq-stamp+append

    def append(self, item) -> None:
        with self._lock:
            if len(self._items) == self.capacity:
                self.dropped += 1
            self._items.append(item)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        # iterate a point-in-time copy: a concurrent append to a full ring
        # mutates both ends and would invalidate a live deque iterator
        with self._lock:
            return iter(list(self._items))

    def __getitem__(self, i):
        with self._lock:
            return self._items[i]

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self.dropped = 0


class EventTrace(BoundedLog):
    """Bounded structured trace of typed serve events.

    ``emit`` validates the payload field set against :data:`EVENT_SCHEMA`
    (exact match — missing and extra fields both raise: the schema is a
    contract, not a suggestion) and stamps the base fields.
    """

    def __init__(self, capacity: int = 4096,
                 clock=time.perf_counter):
        super().__init__(capacity)
        self._clock = clock
        self._seq = 0

    def emit(self, ev: str, tick: int, **fields) -> dict:
        want = EVENT_SCHEMA.get(ev)
        if want is None:
            raise ValueError(f"unknown event kind {ev!r} "
                             f"(EVENT_SCHEMA has {sorted(EVENT_SCHEMA)})")
        if set(fields) != set(want):
            raise ValueError(
                f"event {ev!r} fields {sorted(fields)} != schema "
                f"{sorted(want)}")
        with self._lock:
            rec = {"ev": ev, "t": self._clock(), "tick": int(tick),
                   "seq": self._seq, **fields}
            self._seq += 1
            self.append(rec)
        return rec

    def flush_jsonl(self, path) -> int:
        """Write the buffered events as JSON Lines: one meta record (schema
        version, drop count) followed by one line per event, oldest first.
        Returns the number of event lines written.  The buffer is left
        intact (flush is an observation too)."""
        with self._lock:
            events = list(self._items)
            dropped = self.dropped
        with open(path, "w") as f:
            meta = {"ev": "meta", "schema_version": SCHEMA_VERSION,
                    "events": len(events), "dropped": dropped}
            f.write(json.dumps(meta) + "\n")
            for rec in events:
                f.write(json.dumps(rec) + "\n")
        return len(events)


# ---------------------------------------------------------------------------
# streaming percentiles + phase timers
# ---------------------------------------------------------------------------

class Percentiles:
    """Streaming percentile summary over a sliding observation window.

    Retains the most recent ``window`` observations exactly and computes
    percentiles with numpy's default linear interpolation — below the
    window size the summary is *exact* (asserted against ``np.percentile``
    in tests/test_torch_telemetry.py), above it the summary covers the freshest
    ``window`` samples, which is the operationally useful statistic (a
    latency SLO cares about now, not the lifetime average).  ``count`` and
    ``total`` keep lifetime accounting either way.
    """

    QUANTILES = (50.0, 90.0, 99.0)

    def __init__(self, window: int = 4096):
        if window < 1:
            raise ValueError(f"Percentiles window={window} must be >= 1")
        self.window = window
        self._vals: deque[float] = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self._lock = threading.Lock()

    def add(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._vals.append(v)
            self.count += 1
            self.total += v

    def summary(self) -> dict:
        """{count, mean, max, p50, p90, p99} — None-filled when empty."""
        with self._lock:
            if not self._vals:
                return {"count": 0, "mean": None, "max": None,
                        **{f"p{int(q)}": None for q in self.QUANTILES}}
            arr = np.asarray(self._vals, dtype=np.float64)
            count, total = self.count, self.total
        out = {"count": count,
               "mean": float(total / count),
               "max": float(arr.max())}
        ps = np.percentile(arr, self.QUANTILES)
        for q, p in zip(self.QUANTILES, ps):
            out[f"p{int(q)}"] = float(p)
        return out

    def reset(self) -> None:
        with self._lock:
            self._vals.clear()
            self.count = 0
            self.total = 0.0


class PhaseTimers:
    """Per-phase wall accumulators on ``time.perf_counter``.

    Used bracket-style (``t0 = timers.now(); ...; timers.add(phase, t0)``)
    so the engine controls exactly where the brackets sit — always at
    boundaries it already synchronizes.  ``add`` returns the elapsed wall
    seconds so the same measurement can ride into an event payload without
    a second clock read.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._lock = threading.Lock()

    def now(self) -> float:
        return self._clock()

    def add(self, phase: str, t0: float) -> float:
        return self.record(phase, self._clock() - t0)

    def record(self, phase: str, dt: float) -> float:
        """Fold an externally-measured duration (an engine that already
        metered the phase for its own stats hands the same value here,
        instead of paying a second clock read).  This is the one telemetry
        write the async drain thread performs, hence the lock."""
        with self._lock:
            self.seconds[phase] = self.seconds.get(phase, 0.0) + dt
            self.calls[phase] = self.calls.get(phase, 0) + 1
        return dt

    def snapshot(self) -> dict:
        with self._lock:
            return {p: {"seconds": self.seconds[p], "calls": self.calls[p]}
                    for p in self.seconds}

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()


# ---------------------------------------------------------------------------
# request lifecycle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle timestamps (perf_counter wall + engine
    ticks) and footprint counters.  Derived latencies are ``None`` until
    the corresponding edge has happened."""

    rid: int
    enqueue_s: float
    enqueue_tick: int
    admit_s: float | None = None
    admit_tick: int | None = None
    first_token_s: float | None = None
    finish_s: float | None = None
    finish_tick: int | None = None
    prompt_len: int = 0
    reuse: int = 0                  # radix-hit prompt positions (paged)
    n_tokens: int = 0
    reason: str | None = None
    pages_held: int = 0
    drafted: int = 0                # speculative drafts during tenure
    accepted: int = 0

    @property
    def queue_wait_s(self) -> float | None:
        return None if self.admit_s is None else self.admit_s - self.enqueue_s

    @property
    def queue_wait_ticks(self) -> int | None:
        return (None if self.admit_tick is None
                else self.admit_tick - self.enqueue_tick)

    @property
    def ttft_s(self) -> float | None:
        """Enqueue -> first generated token (the first token is sampled at
        the end of the request's admission wave)."""
        return (None if self.first_token_s is None
                else self.first_token_s - self.enqueue_s)

    @property
    def tpot_s(self) -> float | None:
        """Mean wall seconds per generated token after the first."""
        if self.finish_s is None or self.first_token_s is None:
            return None
        if self.n_tokens <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.n_tokens - 1)

    @property
    def acceptance(self) -> float | None:
        return None if self.drafted == 0 else self.accepted / self.drafted


# ---------------------------------------------------------------------------
# the engine-facing facade
# ---------------------------------------------------------------------------

class Telemetry:
    """Facade the serve engines drive: event trace + lifecycle records +
    phase timers + latency percentile accumulators, behind one object so an
    engine call site is a single ``if self.telemetry is not None`` guard.

    Everything is host-side observation — no method here may dispatch
    device work or change what the engine computes.  The bit-identity
    contract (telemetry on == off, token for token) is asserted across the
    slotted, paged and speculative engines in tests/test_torch_telemetry.py.
    """

    def __init__(self, *, capacity: int = 4096,
                 percentile_window: int = 4096,
                 record_capacity: int = 4096,
                 profile_ticks: int = 0,
                 profile_dir: str | None = None,
                 clock=time.perf_counter):
        self._clock = clock
        self.trace = EventTrace(capacity, clock=clock)
        self.phases = PhaseTimers(clock=clock)
        self.ttft = Percentiles(percentile_window)
        self.tpot = Percentiles(percentile_window)
        self.queue_wait = Percentiles(percentile_window)
        self.live: dict[int, RequestRecord] = {}
        self.records = BoundedLog(record_capacity)   # finished lifecycles
        self.profiler = (TickProfiler(profile_dir, profile_ticks)
                         if profile_ticks > 0 else None)
        self._counters: dict[str, int] = {
            "requests_enqueued": 0, "requests_finished": 0,
            "tokens_emitted": 0, "ticks": 0}

    # -- request lifecycle ------------------------------------------------

    def enqueue(self, rid: int, tick: int) -> None:
        if rid in self.live:                 # engine validation rejects
            return                           # dup rids; stay silent here
        self.live[rid] = RequestRecord(rid=rid, enqueue_s=self._clock(),
                                       enqueue_tick=int(tick))
        self._counters["requests_enqueued"] += 1
        self.trace.emit("enqueue", tick, rid=rid)

    def admit(self, rid: int, tick: int, *, slot: int, prompt_len: int,
              reuse: int = 0, pages_held: int = 0) -> None:
        rec = self.live.get(rid)
        if rec is None:                      # direct _admit_wave callers
            self.enqueue(rid, tick)          # (bench probes): synthesize
            rec = self.live[rid]
        rec.admit_s = self._clock()
        rec.admit_tick = int(tick)
        rec.prompt_len = int(prompt_len)
        rec.reuse = int(reuse)
        rec.pages_held = int(pages_held)
        self.trace.emit("admit", tick, rid=rid, slot=int(slot),
                        prompt_len=int(prompt_len), reuse=int(reuse),
                        queue_wait_ticks=rec.queue_wait_ticks)

    def first_token(self, rid: int, tick: int) -> None:
        rec = self.live.get(rid)
        if rec is None or rec.first_token_s is not None:
            return
        rec.first_token_s = self._clock()
        self.trace.emit("first_token", tick, rid=rid)

    def finish(self, rid: int, tick: int, *, reason: str, n_tokens: int,
               drafted: int = 0, accepted: int = 0) -> None:
        rec = self.live.pop(rid, None)
        if rec is None:
            return
        rec.finish_s = self._clock()
        rec.finish_tick = int(tick)
        rec.reason = reason
        rec.n_tokens = int(n_tokens)
        rec.drafted = int(drafted)
        rec.accepted = int(accepted)
        self.records.append(rec)
        self._counters["requests_finished"] += 1
        self._counters["tokens_emitted"] += rec.n_tokens
        if rec.ttft_s is not None:
            self.ttft.add(rec.ttft_s)
        if rec.tpot_s is not None:
            self.tpot.add(rec.tpot_s)
        if rec.queue_wait_s is not None:
            self.queue_wait.add(rec.queue_wait_s)
        self.trace.emit("finish", tick, rid=rid, reason=reason,
                        n_tokens=rec.n_tokens, ttft_s=rec.ttft_s,
                        tpot_s=rec.tpot_s, queue_wait_s=rec.queue_wait_s,
                        pages_held=rec.pages_held, drafted=rec.drafted,
                        accepted=rec.accepted)

    # -- phases + generic events ------------------------------------------

    def event(self, ev: str, tick: int, **fields) -> None:
        self.trace.emit(ev, tick, **fields)

    def tick_boundary(self, tick: int) -> None:
        """Called once at the top of every engine tick: counts ticks and
        drives the opt-in N-tick profiler window."""
        self._counters["ticks"] += 1
        if self.profiler is not None:
            self.profiler.tick()

    # -- summaries ---------------------------------------------------------

    def summary(self) -> dict:
        """The latency story in one dict: lifecycle counters, TTFT / TPOT /
        queue-wait percentile summaries (seconds), and per-phase wall
        accumulators; with a profiler attached, also its state (and the
        error it failed to start with, if any)."""
        out = {**self._counters,
               "inflight": len(self.live),
               "records_dropped": self.records.dropped,
               "events_dropped": self.trace.dropped,
               "ttft_s": self.ttft.summary(),
               "tpot_s": self.tpot.summary(),
               "queue_wait_s": self.queue_wait.summary(),
               "phases": self.phases.snapshot()}
        if self.profiler is not None:
            out["profiler"] = self.profiler.state()
        return out

    def flush_jsonl(self, path) -> int:
        return self.trace.flush_jsonl(path)

    def reset(self) -> None:
        """Zero every accumulator (a bench/epoch boundary); the profiler —
        if any — keeps its window state."""
        self.trace.clear()
        self.trace._seq = 0
        self.phases.reset()
        self.ttft.reset()
        self.tpot.reset()
        self.queue_wait.reset()
        self.live.clear()
        self.records.clear()
        for k in self._counters:
            self._counters[k] = 0

    def close(self) -> None:
        if self.profiler is not None:
            self.profiler.stop()


class TickProfiler:
    """Opt-in ``torch.profiler`` capture of the first N engine ticks.

    The trace starts at the first tick boundary after attach (CPU activity,
    and CUDA activity where a GPU is present) and stops N boundaries later,
    exporting a Chrome trace to ``<logdir>/trace.json`` (loadable in
    perfetto).  ``logdir`` defaults to ``nldpe_profile`` under the working
    directory.  torch is imported lazily so the rest of the telemetry stack
    stays a pure host-side module.  A profiler that fails to start or to
    export does not take serving down: the failure is warned about once and
    kept in :meth:`state` (``Telemetry.summary()["profiler"]``).
    """

    def __init__(self, logdir: str | None, n_ticks: int):
        if n_ticks < 1:
            raise ValueError(f"TickProfiler n_ticks={n_ticks} must be >= 1")
        self.logdir = logdir or "nldpe_profile"
        self.n_ticks = n_ticks
        self._remaining = n_ticks
        self._prof = None
        self.active = False
        self.done = False
        self.error: str | None = None
        self.trace_path: str | None = None

    def _fail(self, what: str, exc: Exception) -> None:
        self.error = f"{what}: {type(exc).__name__}: {exc}"
        warnings.warn(f"TickProfiler: {self.error}; serving continues "
                      f"without the trace", RuntimeWarning, stacklevel=3)

    def tick(self) -> None:
        if self.done:
            return
        if not self.active:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                self._prof = profile(activities=acts)
                self._prof.start()
            except Exception as exc:         # profiler unavailable here
                self._prof = None
                self.done = True
                self._fail("start failed", exc)
                return
            self.active = True
            return
        self._remaining -= 1
        if self._remaining <= 0:
            self.stop()

    def stop(self) -> None:
        if self.active:
            self.active = False
            try:
                self._prof.stop()
                os.makedirs(self.logdir, exist_ok=True)
                path = os.path.join(self.logdir, "trace.json")
                self._prof.export_chrome_trace(path)
                self.trace_path = path
            except Exception as exc:         # export failed: keep serving
                self._fail("stop/export failed", exc)
            self._prof = None
        self.done = True

    def state(self) -> dict:
        return {"n_ticks": self.n_ticks, "active": self.active,
                "done": self.done, "trace": self.trace_path,
                "error": self.error}

"""Async serving pipeline over the tick engines (port of
``repro.launch.async_engine``, DESIGN.md §14).

``ServeEngine``/``PagedServeEngine`` split a decode tick into a device
dispatch (``_dispatch_tick``) and a host harvest (``_harvest``).  This
module threads that seam: a **scheduler** thread owns every mutation of the
engine (admission, preemption and resume, tick dispatch, harvest
bookkeeping), and a **drain** thread only waits for each tick's emitted
tokens to reach the host, so dispatch never blocks on them.  Requests
stream in through :meth:`AsyncServeEngine.submit` and out through
:meth:`~AsyncServeEngine.results`; :meth:`~AsyncServeEngine.run` serves a
whole trace with the tick loop's arrival semantics.

Queues (single producer and consumer on every edge)::

    caller --submit_q--> scheduler --drain_q--> drain --harvest_q--> scheduler
    scheduler --results_q--> caller (results()/run())

**Why tokens stay the tick loop's.**  The pipeline changes *when* the host
looks at a tick's results, never what the device computes: sampling folds
(request seed, position), spec acceptance folds the verified position, and
preempt/resume round trips are exact.  Three ordering rules keep the host
bookkeeping as exact, with the cache written in place on the card:

* **Snap.**  The tick's emitted tokens and post-tick active mask are the
  tick's own tensors: ``_dispatch_tick`` and every later state update
  (admission's merge, preemption's deactivation, the next tick) rebind
  ``_tok``/``_pos``/``_active`` to new tensors and never write these.
* **Drain.**  Right after dispatch the scheduler thread enqueues the
  tick's device->host copy into pinned buffers on the engine's stream and
  records a CUDA event; the drain thread waits on that event alone (a
  ``.cpu()`` there would wait for every later tick on the shared stream),
  then hands the arrays over.  On the CPU the tensors are the host arrays.
* **Flush before admission.**  Every in-flight tick is harvested before
  any admission, resume or preemption, so a freed slot is reused, or a
  victim chosen, only after every earlier tick's finishes are seen.

Speculative ticks are host-synchronous in the engine (the fidelity ladder
reads every tick): they arrive as host arrays, and the pipeline degrades to
admission-vs-decode overlap.

Telemetry: the scheduler thread emits every event the tick loop would; the
drain thread adds a "drain" phase wall (``PhaseTimers`` is lock-guarded),
and "dispatch" meters the enqueue side.  An error on either thread is
parked and raised on the caller's next call; nothing falls back.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
import weakref

import numpy as np
import torch

from .engine import Completion, Request

_STOP = object()


class _HostCopy:
    """One tick's emitted tokens and active mask on their way to the host.
    A CUDA tensor is copied into a pinned buffer without blocking, on the
    current stream, behind a recorded event; ``wait`` blocks on that event
    alone.  A host array or CPU tensor is already there."""

    __slots__ = ("arrays", "event")

    def __init__(self, *tensors):
        self.event = None
        arrays = []
        for t in tensors:
            if torch.is_tensor(t) and t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                arrays.append(buf)
                if self.event is None:
                    self.event = torch.cuda.Event()
            else:
                arrays.append(t)
        if self.event is not None:
            self.event.record()
        self.arrays = arrays

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [a.numpy() if torch.is_tensor(a) else np.asarray(a)
                for a in self.arrays]


class AsyncServeEngine:
    """Streaming wrapper running a serve engine on a background pipeline.

    Wraps a constructed ``ServeEngine``/``PagedServeEngine`` (paged,
    speculative, spill and priority, telemetry, prefill buckets) without
    touching its state layout.  Exactly one scheduler thread mutates the
    engine; the public methods only exchange messages with it, so
    ``submit`` is safe from any thread, and ``results()``/``run()`` assume
    one consumer.  ``drain_depth`` bounds the ticks in flight (1: none
    overlap).

    The threads start on first use and idle between traces, so one wrapper
    (and its warm engine) serves many runs; :meth:`close` stops them.
    """

    def __init__(self, engine, *, drain_depth: int = 4,
                 poll_s: float = 0.02):
        if drain_depth < 1:
            raise ValueError("drain_depth >= 1 (1 disables pipelining)")
        if getattr(engine, "mesh", None) is not None:
            raise NotImplementedError(
                "the async pipeline under a mesh: its scheduler and drain "
                "threads would issue each rank's collectives out of step "
                "(ROADMAP.md A.2 queue, item 4: the async pipeline and "
                "drift injection under a mesh)")
        self.engine = engine
        self.drain_depth = drain_depth
        self._poll_s = poll_s
        self._submit_q: queue.Queue = queue.Queue()
        self._drain_q: queue.Queue = queue.Queue()
        self._harvest_q: queue.Queue = queue.Queue()
        self._results_q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._pending: set[int] = set()       # submitted, not yet finished
        self._error: BaseException | None = None
        self._closing = False
        self._started = False
        self._sched_t: threading.Thread | None = None
        self._drain_t: threading.Thread | None = None
        self._inflight = 0
        # pipeline counters, a lazy group of the engine's registry (held
        # weakly: the engine must not keep its wrapper alive)
        self._submitted = 0
        self._completed = 0
        self._dispatched_ticks = 0
        self._flushes = 0
        self._max_inflight = 0
        me = weakref.ref(self)
        engine.metrics.register_group(
            "async", lambda: me()._async_stats() if me() else {})

    # -- public API -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue one request (thread-safe).  Validation errors raise here,
        on the caller; a scheduler-side failure raises on the next
        ``submit``/``results``/``run`` call."""
        self._check_error()
        with self._lock:
            if req.rid in self._pending:
                raise ValueError(
                    f"request {req.rid}: rid already in flight")
            # the static checks on the caller's thread; the in-flight rid
            # check is the pending set above, which the scheduler cannot race
            self.engine._validate(req)
            self._pending.add(req.rid)
            self._submitted += 1
        self._start()
        self._submit_q.put(req)

    def results(self, *, timeout: float | None = None):
        """Yield completions as the pipeline finishes them; return when
        nothing submitted is pending.  ``timeout`` bounds the wait for the
        *next* completion (None: forever)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._check_error()
            try:
                comp = self._results_q.get(timeout=self._poll_s)
            except queue.Empty:
                with self._lock:
                    drained = not self._pending
                if drained:
                    # a completion is queued before its rid leaves the
                    # pending set: one last sweep has every one of them
                    while True:
                        try:
                            yield self._results_q.get_nowait()
                        except queue.Empty:
                            return
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no completion within {timeout}s "
                        f"({len(self._pending)} pending)")
                continue
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            yield comp

    def run(self, requests: list[Request]) -> list[Completion]:
        """Serve a whole trace as ``ServeEngine.run`` does (arrival ticks
        respected by the scheduler): submit everything, wait for all of it,
        return completions sorted by rid.  The wrapper stays live."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError(f"duplicate rids in one trace: {rids}")
        for r in sorted(requests, key=lambda r: r.arrival):
            self.submit(r)
        out, expect = [], set(rids)
        for comp in self.results():
            if comp.rid in expect:
                expect.discard(comp.rid)
                out.append(comp)
            if not expect:
                break
        if expect:
            self._check_error()
            raise RuntimeError(f"pipeline drained with {sorted(expect)} "
                               f"unfinished")
        return sorted(out, key=lambda c: c.rid)

    def close(self) -> None:
        """Finish outstanding work, stop both threads, raise any pipeline
        error.  Idempotent; the next ``submit`` starts them again."""
        self._closing = True
        if self._sched_t is not None:
            self._sched_t.join()
            self._sched_t = None
        if self._drain_t is not None:
            self._drain_q.put(_STOP)
            self._drain_t.join()
            self._drain_t = None
        self._started = False
        self._check_error()

    # engine passthroughs that harnesses read
    @property
    def tick(self) -> int:
        return self.engine.tick

    @property
    def telemetry(self):
        return self.engine.telemetry

    @property
    def metrics(self):
        return self.engine.metrics

    def _async_stats(self) -> dict:
        return {"submitted": self._submitted,
                "completed": self._completed,
                "dispatched_ticks": self._dispatched_ticks,
                "pipeline_flushes": self._flushes,
                "max_inflight": self._max_inflight,
                "drain_depth": self.drain_depth}

    # -- plumbing -------------------------------------------------------------

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                "async serve pipeline failed") from self._error

    def _start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        self._closing = False
        self._error = None
        self._drain_t = threading.Thread(
            target=self._drain_loop, name="nldpe-drain", daemon=True)
        self._sched_t = threading.Thread(
            target=self._scheduler_loop, name="nldpe-sched", daemon=True)
        self._drain_t.start()
        self._sched_t.start()

    def _finish(self, comp: Completion) -> None:
        self._completed += 1
        self._results_q.put(comp)
        with self._lock:
            self._pending.discard(comp.rid)

    # -- drain thread: waits for device->host copies only --------------------

    def _drain_loop(self) -> None:
        tel = self.engine.telemetry
        while True:
            item = self._drain_q.get()
            if item is _STOP:
                return
            copy, fin = item
            try:
                t0 = time.perf_counter()
                emits, active = copy.wait()
                if tel is not None:
                    tel.phases.record("drain", time.perf_counter() - t0)
                self._harvest_q.put((emits, active, fin))
            except BaseException as exc:          # forward, never die silent
                self._harvest_q.put(exc)

    # -- scheduler thread: the engine's only mutator -------------------------

    def _apply_harvests(self, down_to: int) -> None:
        """Apply drained ticks to the engine, blocking until at most
        ``down_to`` dispatched ticks are un-harvested.  ``down_to=0`` is the
        flush that precedes every admission, resume or preemption."""
        while self._inflight:
            if self._inflight > down_to:
                item = self._harvest_q.get()
            else:
                try:
                    item = self._harvest_q.get_nowait()
                except queue.Empty:
                    return
            self._inflight -= 1
            if isinstance(item, BaseException):
                raise item
            emits, active, fin = item
            if fin is not None:
                fin()
            for comp in self.engine._harvest(emits, active):
                self._finish(comp)

    def _flush(self) -> None:
        if self._inflight:
            self._flushes += 1
            self._apply_harvests(0)

    def _scheduler_loop(self) -> None:
        try:
            self._inflight = 0
            self._serve()
            self._apply_harvests(0)
        except BaseException as exc:
            self._error = exc
            # unblock the consumer: pending rids will never finish
            with self._lock:
                self._pending.clear()
        finally:
            self._started = False

    def _ingest(self, arrivals: list, r: Request) -> None:
        i = 0
        while i < len(arrivals) and arrivals[i].arrival <= r.arrival:
            i += 1
        arrivals.insert(i, r)

    def _serve(self) -> None:
        eng = self.engine
        tel = eng.telemetry
        arrivals: list[Request] = []          # sorted by arrival
        waiting = collections.deque()
        while True:
            while True:
                try:
                    self._ingest(arrivals, self._submit_q.get_nowait())
                except queue.Empty:
                    break
            # apply whatever the drain thread has finished
            self._apply_harvests(self._inflight)

            progressed = False
            while arrivals and arrivals[0].arrival <= eng.tick:
                r = arrivals.pop(0)
                if tel is not None:
                    tel.enqueue(r.rid, r.arrival)
                waiting.append(r)
                progressed = True

            # admission, resume and preemption need a fully harvested
            # engine; pay the flush only when one of them can happen
            if eng._preempted or (waiting and eng._can_admit(waiting)):
                self._flush()
                n_pre = len(eng._preempted)
                eng._resume_preempted(waiting)
                progressed |= len(eng._preempted) != n_pre
                if waiting and eng._can_admit(waiting):
                    wave = eng._select_wave(waiting)
                    if wave:
                        for comp in eng._admit_wave(wave):
                            self._finish(comp)
                        progressed = True

            if eng.any_active:
                if self._inflight >= self.drain_depth:
                    self._apply_harvests(self.drain_depth - 1)
                    continue
                t0 = time.perf_counter()
                emits, active, fin = eng._dispatch_tick()
                copy = _HostCopy(emits, active)
                if tel is not None:
                    tel.phases.record("dispatch", time.perf_counter() - t0)
                self._inflight += 1
                self._max_inflight = max(self._max_inflight, self._inflight)
                self._dispatched_ticks += 1
                self._drain_q.put((copy, fin))
                continue

            # nothing active on the device
            if self._inflight:
                self._apply_harvests(0)
                continue
            if progressed:
                continue
            if arrivals:                      # idle until the next arrival
                eng.tick = max(eng.tick, arrivals[0].arrival)
                continue
            if waiting or eng._preempted:
                raise RuntimeError(
                    f"scheduler deadlock: {len(waiting)} waiting and "
                    f"{len(eng._preempted)} preempted request(s), no "
                    f"active slots, no future arrivals, and admission "
                    f"made no progress (admission blocked or the pool "
                    f"is too small for the requests)")
            if self._closing:
                return
            try:
                r = self._submit_q.get(timeout=self._poll_s)
            except queue.Empty:
                continue
            self._ingest(arrivals, r)

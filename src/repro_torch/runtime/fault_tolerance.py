"""Fault-tolerant step loop: checkpoint/restart, watchdog, deterministic
data (port of ``repro.runtime.fault_tolerance``).

``resilient_loop`` wraps any ``(state, step) -> state`` function with:

* periodic atomic checkpoints (``checkpoint.manager``);
* restore-and-continue on an exception, up to ``max_restarts`` — a node
  failure surfaces as exactly this: the job controller restarts the
  process and the loop resumes from ``LATEST``;
* a watchdog that flags straggling steps (more than ``straggler_factor``
  times the median of the trailing 32 step times); the event is recorded
  so that callers can act on it;
* deterministic batch indexing (the data is a pure function of the
  step), so restarts never repeat or skip data.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

from ..checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class LoopReport:
    completed_steps: int
    restarts: int
    straggler_events: list
    step_times: list


def resilient_loop(step_fn: Callable, state, *, steps: int,
                   manager: CheckpointManager | None = None,
                   ckpt_every: int = 50, max_restarts: int = 3,
                   straggler_factor: float = 5.0,
                   fail_injector: Callable | None = None) -> tuple:
    """Run ``state = step_fn(state, i)`` for i in [resume, steps)."""
    start = 0
    if manager is not None:
        restored = manager.restore_latest(state)
        if restored is not None:
            state, start = restored
    restarts = 0
    stragglers = []
    times = []
    i = start
    while i < steps:
        try:
            if fail_injector is not None:
                fail_injector(i, restarts)
            # perf_counter, not time.time(): an NTP step makes wall-clock
            # durations negative or garbage and poisons the median
            t0 = time.perf_counter()
            state = step_fn(state, i)
            dt = time.perf_counter() - t0
            times.append(dt)
            if len(times) >= 8:
                med = statistics.median(times[-32:])
                if dt > straggler_factor * med:
                    stragglers.append({"step": i, "dt": dt, "median": med})
            if manager is not None and (i + 1) % ckpt_every == 0:
                manager.save(state, i + 1)
            i += 1
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            if restarts > max_restarts or manager is None:
                raise
            restored = manager.restore_latest(state)
            if restored is None:
                # nothing to roll back to: rewinding i to 0 while keeping
                # the last good state would repeat consumed batches, so
                # the failure goes to the job controller instead
                raise
            state, i = restored
    if manager is not None:
        manager.save(state, steps)
    return state, LoopReport(completed_steps=steps - start, restarts=restarts,
                             straggler_events=stragglers, step_times=times)

"""Closed-loop device fidelity for the serve engines (port of
``repro.launch.fidelity``; DESIGN.md §10).

The paged engine's speculative acceptance rate is a live, free measurement
of how faithfully the programmed analog drafter tracks the exact digital
path (the paper's Fig 14 correlation, observed in production).  This
module turns that signal into a control loop:

* :class:`DriftInjection` configures the *plant*: a ``core.drift``
  device model applied to the drafter's programmed conductances on a
  virtual clock the engine advances per tick (``dt_step`` virtual seconds
  per exact decode position — a verify chunk is one parallel pass;
  ``draft_cost`` bills the analog draft steps, ~0 on the chip), plus the
  metered downtime of a reprogramming pass.  Deterministic given ``seed``:
  no wall-clock reads anywhere.

* :class:`FidelityMonitor` is the *controller*: it folds per-tick
  drafted/accepted counts into a windowed + EWMA acceptance estimate and
  walks a three-stage graceful-degradation ladder —

      acceptance < soft_threshold   ->  halve spec_k ("backoff")
      acceptance < hard_threshold   ->  reprogram the drafter
      reprogramming fails to recover -> disable the draft path entirely
                                         (exact decode; correctness was
                                         never at risk, only throughput)

  with the reverse transitions on recovery: EWMA back above
  ``recover_threshold`` re-escalates spec_k toward its configured maximum
  and clears the failed-reprogram count, and a disabled drafter can be
  re-probed at ``probe_interval_s`` to detect a recovered device.

The load-bearing invariant (tests/test_torch_fidelity.py): none of this
can change emitted tokens.  Faults and drift touch only the draft proposal
distribution; the exact-digital verify pass owns every accept/reject and
every correction draw, so greedy output stays the no-injection,
no-speculation run's no matter how degraded the drafter is — degradation
moves tokens/second, never tokens (in the port up to the verify route's
near-ties, ROADMAP.md C).
"""
from __future__ import annotations

import dataclasses
import math

from ..core.drift import DriftModel
from ..obs.telemetry import BoundedLog


def _finite(name: str, v, lo: float | None = None, hi: float | None = None):
    if not (isinstance(v, (int, float)) and math.isfinite(v)):
        raise ValueError(f"{name}={v!r} must be a finite number")
    if lo is not None and v < lo:
        raise ValueError(f"{name}={v} must be >= {lo}")
    if hi is not None and v > hi:
        raise ValueError(f"{name}={v} must be <= {hi}")


@dataclasses.dataclass(frozen=True)
class DriftInjection:
    """Drift/fault plant configuration for ``PagedServeEngine(drift=...)``.

    ``model``        the :class:`core.drift.DriftModel` applied to the
                     drafter's programmed conductances.
    ``seed``         device seed: programming draws, fault arrival times,
                     reprogramming passes, and (optional) read noise all
                     derive from it — a trace replays bit-identically.
    ``dt_step``      virtual seconds per exact decode position/pass.  One
                     speculative tick costs ``dt_step * (1 + draft_cost *
                     k)``; one plain decode tick costs ``dt_step *
                     decode_block``.  Large values accelerate the clock
                     (days of field time in hundreds of ticks).
    ``draft_cost``   relative virtual cost of one analog draft step
                     (default 0: the chip's draft side is nearly free —
                     DESIGN.md §8 economics).
    ``reprogram_s``  virtual downtime of one full reprogramming pass,
                     added to the clock and metered in
                     ``fidelity_stats["downtime_s"]`` — reprogramming is
                     never free, which is why the policy waits for the
                     hard threshold.
    ``read_noise``   additionally draw one read-fluctuation sample
                     (``NoiseModel.read``) per tick, keyed by the tick.
    """

    model: DriftModel = dataclasses.field(default_factory=DriftModel)
    seed: int = 0
    dt_step: float = 1.0
    draft_cost: float = 0.0
    reprogram_s: float = 0.0
    read_noise: bool = False

    def __post_init__(self):
        _finite("DriftInjection.dt_step", self.dt_step, lo=0.0)
        if self.dt_step <= 0:
            raise ValueError(
                f"DriftInjection.dt_step={self.dt_step} must be > 0")
        _finite("DriftInjection.draft_cost", self.draft_cost, lo=0.0)
        _finite("DriftInjection.reprogram_s", self.reprogram_s, lo=0.0)

    def tick_seconds(self, spec_k_live: int, decode_block: int) -> float:
        """Virtual seconds one engine tick advances the device clock."""
        if spec_k_live > 0:
            return self.dt_step * (1.0 + self.draft_cost * spec_k_live)
        return self.dt_step * decode_block


@dataclasses.dataclass(frozen=True)
class FidelityPolicy:
    """Thresholds and cadence of the graceful-degradation ladder."""

    window: int = 16            # spec ticks per decision window
    ewma_alpha: float = 0.25    # weight of the newest window in the EWMA
    soft_threshold: float = 0.5   # EWMA below -> spec_k backoff
    hard_threshold: float = 0.3   # EWMA below -> reprogram
    recover_threshold: float = 0.6  # EWMA above -> re-escalate spec_k
    min_spec_k: int = 1
    reprogram_patience: int = 1   # windows a reprogram gets before judging
    max_reprograms: int = 2       # consecutive failures before disable
    probe_interval_s: float = 0.0  # re-probe cadence once disabled (0: off)
    event_log_cap: int = 512      # ladder events retained (ring buffer)

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"FidelityPolicy.window={self.window} must "
                             f"be >= 1")
        _finite("FidelityPolicy.ewma_alpha", self.ewma_alpha, lo=0.0, hi=1.0)
        if not (self.ewma_alpha > 0):
            raise ValueError("FidelityPolicy.ewma_alpha must be in (0, 1]")
        for name in ("soft_threshold", "hard_threshold", "recover_threshold"):
            _finite(f"FidelityPolicy.{name}", getattr(self, name),
                    lo=0.0, hi=1.0)
        if not (self.hard_threshold <= self.soft_threshold
                <= self.recover_threshold):
            raise ValueError(
                f"FidelityPolicy thresholds must be ordered hard <= soft "
                f"<= recover, got {self.hard_threshold} / "
                f"{self.soft_threshold} / {self.recover_threshold}")
        if self.min_spec_k < 1:
            raise ValueError("FidelityPolicy.min_spec_k must be >= 1")
        if self.reprogram_patience < 0 or self.max_reprograms < 1:
            raise ValueError("reprogram_patience >= 0, max_reprograms >= 1")
        _finite("FidelityPolicy.probe_interval_s", self.probe_interval_s,
                lo=0.0)
        if self.event_log_cap < 1:
            raise ValueError(
                f"FidelityPolicy.event_log_cap={self.event_log_cap} must "
                f"be >= 1")


class FidelityMonitor:
    """Windowed/EWMA acceptance tracker driving the degradation ladder.

    The engine calls :meth:`observe` once per decode tick (speculative or
    not) with that tick's drafted/accepted counts and the virtual time;
    at every full decision window the monitor may return one action —

        "backoff"    halve ``spec_k`` (floored at ``min_spec_k``)
        "reprogram"  rewrite the drafter's conductances (engine executes)
        "disable"    ``spec_k -> 0``: fall back to exact decode
        "probe"      re-enable a disabled drafter at ``min_spec_k``
        "escalate"   double ``spec_k`` back toward its maximum

    — and updates its own ``spec_k`` to the post-action depth the engine
    mirrors.  Pure host-side bookkeeping: nothing here touches a device.
    """

    def __init__(self, policy: FidelityPolicy, spec_k: int):
        if spec_k < 1:
            raise ValueError("FidelityMonitor needs spec_k >= 1")
        self.policy = policy
        self.spec_k_max = int(spec_k)
        self.spec_k = int(spec_k)
        self.ewma: float | None = None
        self.disabled = False
        # bounded with the serve-wide ring policy (DESIGN.md §12): a ladder
        # that oscillates for weeks cannot grow host memory — old events
        # fall off and events.dropped counts them
        self.events = BoundedLog(policy.event_log_cap)
        self._win_drafted = 0
        self._win_accepted = 0
        self._win_ticks = 0
        self._grace = 0              # windows left of reprogram patience
        self._failed_reprograms = 0
        self._probing = False
        self._disabled_at = 0.0

    # ------------------------------------------------------------------

    def _event(self, kind: str, t: float, tick: int) -> str:
        self.events.append({"event": kind, "t": float(t), "tick": int(tick),
                            "spec_k": self.spec_k,
                            "ewma": None if self.ewma is None
                            else round(self.ewma, 4)})
        return kind

    def _disable(self, t: float, tick: int) -> str:
        self.disabled = True
        self._probing = False
        self.spec_k = 0
        self._disabled_at = float(t)
        return self._event("disable", t, tick)

    def observe(self, *, drafted: int, accepted: int, t: float,
                tick: int) -> str | None:
        """Fold one tick's counts; return the action due (if any)."""
        if self.disabled:
            p = self.policy
            if (p.probe_interval_s > 0
                    and t - self._disabled_at >= p.probe_interval_s):
                self.disabled = False
                self._probing = True
                self.spec_k = p.min_spec_k
                self._failed_reprograms = 0
                self._win_drafted = self._win_accepted = self._win_ticks = 0
                kind = self._event("probe", t, tick)
                self.ewma = None     # stale estimate: measure the device
                return kind          # fresh after the intervention
            return None
        self._win_drafted += int(drafted)
        self._win_accepted += int(accepted)
        self._win_ticks += 1
        if self._win_ticks < self.policy.window:
            return None
        if self._win_drafted == 0:       # idle window: nothing to judge
            self._win_ticks = 0
            return None
        acc = self._win_accepted / self._win_drafted
        a = self.policy.ewma_alpha
        self.ewma = acc if self.ewma is None else a * acc + (1 - a) * self.ewma
        self._win_drafted = self._win_accepted = self._win_ticks = 0
        return self._decide(t, tick)

    def _decide(self, t: float, tick: int) -> str | None:
        p, acc = self.policy, self.ewma
        if acc >= p.recover_threshold:
            # healthy again: a reprogram (or probe) worked — clear failure
            # state and climb back toward the configured depth
            self._failed_reprograms = 0
            self._grace = 0
            self._probing = False
            if self.spec_k < self.spec_k_max:
                self.spec_k = min(self.spec_k_max, max(self.spec_k * 2, 1))
                return self._event("escalate", t, tick)
            return None
        if self._grace > 0:              # a reprogram is still settling
            self._grace -= 1
            return None
        if acc < p.hard_threshold:
            if self._probing:            # probe failed: back to sleep
                return self._disable(t, tick)
            if self._failed_reprograms >= p.max_reprograms:
                return self._disable(t, tick)
            self._failed_reprograms += 1
            self._grace = p.reprogram_patience
            kind = self._event("reprogram", t, tick)
            # the EWMA that tripped the threshold describes the *old*
            # programming; start a fresh estimate so recovery (or its
            # failure) is judged on the rewritten device alone
            self.ewma = None
            return kind
        if acc < p.soft_threshold and self.spec_k > p.min_spec_k:
            self.spec_k = max(p.min_spec_k, self.spec_k // 2)
            return self._event("backoff", t, tick)
        return None

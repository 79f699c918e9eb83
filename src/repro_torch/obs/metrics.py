"""Unified metrics registry: counters, gauges, histograms (port of
``repro.obs.metrics``; DESIGN.md §12).

The serve stack grew three disjoint stats dicts — ``PagePool.stats``,
``ServeEngine.spec_stats``, ``fidelity_stats`` — each with its own access
path.  :class:`MetricsRegistry` puts one facade over all of them: engines
register *group collectors* (zero-cost closures over state they already
maintain) next to directly-driven instruments, and a single ``snapshot()``
returns everything as one nested dict, with ``prometheus_text()`` as the
line-protocol exposition for scrapers.

Deprecation-shim contract (asserted in tests/test_torch_telemetry.py): for
every legacy dict there is a group whose snapshot compares ``==`` to the
dict, so dashboards can migrate group-by-group with no value drift.

Like the rest of ``repro_torch.obs`` this is pure host-side bookkeeping —
no torch imports, no device work, nothing fed back into scheduling.
"""
from __future__ import annotations

import re

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"metric name {name!r} must match {_NAME_RE.pattern}"
                         " (prometheus-compatible identifier)")
    return name


class Counter:
    """Monotonically non-decreasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"Counter {self.name} cannot decrease (inc {n})")
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value; can move either way or be lazily collected."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", fn=None):
        self.name = _check_name(name)
        self.help = help
        self.value = 0.0
        self._fn = fn                      # optional collect-on-read closure

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n

    def snapshot(self):
        return self._fn() if self._fn is not None else self.value


class Histogram:
    """Cumulative-bucket histogram (prometheus ``le`` convention).

    Buckets are fixed at construction; each observation lands in every
    bucket whose upper bound is >= the value (cumulative), with ``+Inf``
    implicit via ``count``.  ``sum``/``count`` give the mean; percentile
    queries belong to :class:`~repro_torch.obs.telemetry.Percentiles`, which
    keeps raw samples — the histogram is the cheap fixed-memory aggregate.
    """

    kind = "histogram"

    DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 5e-1,
                       1.0, 5.0)

    def __init__(self, name: str, help: str = "", buckets=None):
        self.name = _check_name(name)
        self.help = help
        bs = tuple(float(b) for b in (buckets or self.DEFAULT_BUCKETS))
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"Histogram {name} buckets must be strictly "
                             f"increasing, got {bs}")
        self.buckets = bs
        self.counts = np.zeros(len(bs), dtype=np.int64)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        # cumulative: every bucket with upper bound >= v takes the sample
        self.counts[np.searchsorted(self.buckets, v):] += 1

    def snapshot(self):
        return {"count": self.count, "sum": self.sum,
                "buckets": {b: int(c)
                            for b, c in zip(self.buckets, self.counts)}}


class MetricsRegistry:
    """Instruments + lazy group collectors behind one ``snapshot()``.

    Two registration styles:

    * ``counter/gauge/histogram(name)`` — directly-driven instruments the
      caller holds and updates on the hot path (attribute access + int add;
      no locks: all engine-state mutation stays on one thread — the tick
      loop, or the async pipeline's scheduler thread (DESIGN.md §14) —
      and group collectors read plain ints/dicts, so a snapshot taken
      from another thread is merely point-in-time, never corrupt).
    * ``register_group(name, fn)`` — a zero-argument closure returning a
      dict, evaluated only at snapshot time.  This is how the legacy stats
      dicts plug in without the engines paying anything per tick:
      ``reg.register_group("pool", lambda: dict(pool.stats))``.
    """

    def __init__(self):
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}
        self._groups: dict[str, object] = {}

    # -- registration -----------------------------------------------------

    def _add(self, inst):
        if inst.name in self._instruments:
            raise ValueError(f"duplicate metric {inst.name!r}")
        self._instruments[inst.name] = inst
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._add(Counter(name, help))

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        return self._add(Gauge(name, help, fn=fn))

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._add(Histogram(name, help, buckets))

    def register_group(self, name: str, fn) -> None:
        """Attach a lazy collector; ``snapshot()[name]`` becomes ``fn()``.
        Re-registering a name replaces the collector (engine re-init)."""
        _check_name(name)
        self._groups[name] = fn

    # -- exposition --------------------------------------------------------

    def snapshot(self) -> dict:
        """One nested dict: every group collector evaluated now, plus every
        directly-driven instrument under ``"metrics"``."""
        out = {name: fn() for name, fn in self._groups.items()}
        if self._instruments:
            out["metrics"] = {n: i.snapshot()
                              for n, i in self._instruments.items()}
        return out

    def prometheus_text(self, prefix: str = "nldpe") -> str:
        """Prometheus text exposition (v0.0.4 line protocol).

        Instruments expose with TYPE/HELP headers; group collectors are
        flattened as ``<prefix>_<group>_<key>`` gauges for their numeric
        scalar leaves (non-numeric leaves — lists, nested dicts beyond one
        level — are skipped: the JSONL trace is the structured channel).
        """
        lines: list[str] = []
        for name, inst in sorted(self._instruments.items()):
            full = f"{prefix}_{name}"
            if inst.help:
                lines.append(f"# HELP {full} {inst.help}")
            lines.append(f"# TYPE {full} {inst.kind}")
            if isinstance(inst, Histogram):
                snap = inst.snapshot()
                acc_fmt = "{0}_bucket{{le=\"{1}\"}} {2}"
                for b, c in snap["buckets"].items():
                    lines.append(acc_fmt.format(full, repr(b), c))
                lines.append(acc_fmt.format(full, "+Inf", snap["count"]))
                lines.append(f"{full}_sum {snap['sum']}")
                lines.append(f"{full}_count {snap['count']}")
            else:
                lines.append(f"{full} {inst.snapshot()}")
        for gname, fn in sorted(self._groups.items()):
            d = fn()
            if not isinstance(d, dict):
                continue
            for key, val in sorted(d.items()):
                if isinstance(val, bool) or not isinstance(
                        val, (int, float, np.integer, np.floating)):
                    continue
                key = re.sub(r"[^a-zA-Z0-9_]", "_", str(key))
                lines.append(f"{prefix}_{gname}_{key} {val}")
        return "\n".join(lines) + "\n"

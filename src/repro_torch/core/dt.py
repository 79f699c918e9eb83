"""Per-bit decision trees for ACAM function approximation (paper §III-C).

Port of ``repro.core.dt``: host numpy, copied so the tables are built by
the same code and come out bit-identical.

A single-variable function ``f`` quantized to ``n`` output bits is computed
bit-by-bit: output bit ``i`` as a function of the (analog) input ``x`` is a
piecewise-constant 0/1 signal.  The paper trains one DT per bit that
*memorizes* the toggle thresholds exactly ("intentionally overfitting"); each
maximal interval where the bit is 1 becomes one ACAM row storing
``[lo, hi]``; the bit value is the OR of the row matches.

Gray-coding the output (Fig 5, right axis) halves the toggle rate of every
bit below the MSB, which halves the ACAM row count (Table I).

We build the trees deterministically: evaluate ``f`` on a dense input grid,
quantize, and extract the exact runs of 1s per bit-plane.  This is equivalent
to (and stronger than) fitting sklearn DTs on 5000 samples, and is fully
reproducible.  All heavy lifting is host-side numpy; the resulting
``ACAMTable`` is consumed by jit-side evaluators in ``acam.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .functions import FUNCTIONS, FunctionSpec
from .quantization import QuantSpec, spec_for

_NEVER_LO = np.float32(np.finfo(np.float32).max)   # padding rows never match
_NEVER_HI = np.float32(np.finfo(np.float32).min)
_WILD = 1e30  # wildcard extension at domain edges ("X" cells, Fig 2(d))


@dataclasses.dataclass
class ACAMTable:
    """Interval thresholds for all output bit-planes of one function.

    lo/hi are (bits, max_rows) float32, bit index 0 = LSB.  Rows beyond
    ``rows_per_bit[i]`` are padding that can never match.
    """

    name: str
    bits: int
    encoding: str                  # "gray" | "binary"
    in_domain: tuple[float, float]
    out_spec: QuantSpec
    lo: np.ndarray
    hi: np.ndarray
    rows_per_bit: tuple[int, ...]

    @property
    def total_rows(self) -> int:
        return int(sum(self.rows_per_bit))

    def padded(self, rows: int) -> "ACAMTable":
        """Re-pad the row dimension to exactly ``rows`` (for fixed HW sizing).

        Shrinking is allowed only down to ``max(rows_per_bit)`` — anything
        dropped beyond that is never-match padding, so no interval is lost.
        """
        if rows < max(self.rows_per_bit):
            raise ValueError(
                f"{self.name}: need {max(self.rows_per_bit)} rows, got {rows}")
        lo = np.full((self.bits, rows), _NEVER_LO, np.float32)
        hi = np.full((self.bits, rows), _NEVER_HI, np.float32)
        keep = min(rows, self.lo.shape[1])
        lo[:, :keep] = self.lo[:, :keep]
        hi[:, :keep] = self.hi[:, :keep]
        return dataclasses.replace(self, lo=lo, hi=hi)


def _bit_planes(codes: np.ndarray, bits: int) -> np.ndarray:
    """(N,) int -> (bits, N) {0,1}; bit 0 = LSB."""
    return ((codes[None, :] >> np.arange(bits)[:, None]) & 1).astype(np.int8)


def _runs_of_ones(plane: np.ndarray, xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Extract maximal runs of 1s -> (lo, hi) interval arrays.

    Interval bounds are placed at the midpoint between the last grid point of
    one region and the first of the next, so the piecewise reconstruction is
    exact for any input resolved by the grid.
    """
    p = plane.astype(np.int8)
    d = np.diff(p)
    starts = np.where(d == 1)[0] + 1          # index of first 1 of a run
    ends = np.where(d == -1)[0]               # index of last 1 of a run
    if p[0] == 1:
        starts = np.concatenate([[0], starts])
    if p[-1] == 1:
        ends = np.concatenate([ends, [len(p) - 1]])
    los, his = [], []
    for s, e in zip(starts, ends):
        lo = -_WILD if s == 0 else 0.5 * (xs[s - 1] + xs[s])
        hi = _WILD if e == len(p) - 1 else 0.5 * (xs[e] + xs[e + 1])
        los.append(lo)
        his.append(hi)
    return np.asarray(los, np.float32), np.asarray(his, np.float32)


def build_table(
    fn: FunctionSpec | str,
    bits: int = 8,
    encoding: str = "gray",
    in_domain: tuple[float, float] | None = None,
    out_spec: QuantSpec | None = None,
    dense: int = 1 << 18,
) -> ACAMTable:
    """Build the per-bit ACAM threshold table for ``fn``."""
    if isinstance(fn, str):
        fn = FUNCTIONS[fn]
    lo_x, hi_x = in_domain if in_domain is not None else fn.domain
    xs = np.linspace(lo_x, hi_x, dense, dtype=np.float64)
    ys = np.asarray(fn.fn(xs), dtype=np.float64)
    spec = out_spec if out_spec is not None else spec_for(ys, bits=bits)
    levels = np.clip(np.round((ys - spec.lo) / spec.step), 0, spec.levels - 1
                     ).astype(np.int64)
    if encoding == "gray":
        codes = levels ^ (levels >> 1)
    elif encoding == "binary":
        codes = levels
    else:
        raise ValueError(f"unknown encoding {encoding!r}")

    planes = _bit_planes(codes, bits)
    per_bit = [_runs_of_ones(planes[i], xs) for i in range(bits)]
    rows = tuple(len(l) for l, _ in per_bit)
    max_rows = max(max(rows), 1)
    lo = np.full((bits, max_rows), _NEVER_LO, np.float32)
    hi = np.full((bits, max_rows), _NEVER_HI, np.float32)
    for i, (l, h) in enumerate(per_bit):
        lo[i, : len(l)] = l
        hi[i, : len(h)] = h
    return ACAMTable(
        name=fn.name, bits=bits, encoding=encoding, in_domain=(lo_x, hi_x),
        out_spec=spec, lo=lo, hi=hi, rows_per_bit=rows)

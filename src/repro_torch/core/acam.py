"""ACAM array evaluation (port of ``repro.core.acam``).

* ``match_bits`` / ``gray_decode_bits`` / ``eval_table`` / ``eval_acam``
  — the hardware-faithful interval matcher: per-bit row match
  (lo <= x <= hi), OR across rows, XOR Gray decode.  These are the plain
  versions the ACAM kernel (D) and the fused crossbar->ACAM kernel's
  epilogue (B) are held against.
* ``compile_piecewise`` / ``eval_piecewise`` — the noise-free fast path
  the ``ON`` numerics use: the whole unit is a piecewise-constant map of
  the scalar input, evaluated with a sorted-breakpoint search.
* ``compile_thresholds`` / ``eval_compiled`` / ``table_map`` — the exact
  compile of any threshold pair (noisy ones too) into breakpoints and the
  code at and between each, bit for bit the interval matcher: the map the
  kernels B and D search.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dt import ACAMTable, build_table


def match_bits(lo: torch.Tensor, hi: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """(bits, rows) thresholds, (...,) inputs -> (..., bits) {0,1} int32,
    bit 0 = LSB: a row matches iff lo <= x <= hi, a bit is the OR of its
    rows."""
    xe = x[..., None, None]
    m = (xe >= lo) & (xe <= hi)
    return torch.any(m, dim=-1).to(torch.int32)


def gray_decode_bits(g: torch.Tensor) -> torch.Tensor:
    """(..., bits) Gray bit-planes -> (..., bits) binary planes:
    b_i = XOR(g_{n-1}, ..., g_i), the reverse cumulative XOR."""
    rev = torch.flip(g, dims=(-1,))
    csum = torch.cumsum(rev, dim=-1) % 2
    return torch.flip(csum, dims=(-1,)).to(torch.int32)


def eval_table(lo: torch.Tensor, hi: torch.Tensor, x: torch.Tensor,
               out_lo: float, out_step: float,
               encoding: str = "gray") -> torch.Tensor:
    """Full ACAM unit: thresholds -> dequantized value (f32)."""
    g = match_bits(lo, hi, x)
    b = gray_decode_bits(g) if encoding == "gray" else g
    weights = 2 ** torch.arange(b.shape[-1], device=b.device)
    code = torch.sum(b.to(torch.int64) * weights, dim=-1).to(torch.float32)
    return code * out_step + out_lo


def eval_acam(table: ACAMTable, x: torch.Tensor,
              lo: torch.Tensor | None = None,
              hi: torch.Tensor | None = None) -> torch.Tensor:
    """The interval match of ``table`` on ``x``; pass noisy (lo, hi) to
    simulate device noise."""
    dev_lo, dev_hi = table_thresholds(table, x.device)
    return eval_table(dev_lo if lo is None else lo,
                      dev_hi if hi is None else hi, x,
                      float(table.out_spec.lo), float(table.out_spec.step),
                      table.encoding)


def eval_table_np(table: ACAMTable, x: np.ndarray) -> np.ndarray:
    """numpy oracle (host side, copied)."""
    x = np.asarray(x, np.float64)
    xe = x[..., None, None]
    m = (xe >= table.lo) & (xe <= table.hi)
    g = np.any(m, axis=-1).astype(np.int64)
    if table.encoding == "gray":
        rev = g[..., ::-1]
        b = (np.cumsum(rev, axis=-1) % 2)[..., ::-1]
    else:
        b = g
    code = (b * (1 << np.arange(table.bits))).sum(-1)
    return code * table.out_spec.step + table.out_spec.lo


def table_thresholds(table: ACAMTable,
                     device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) as f32 tensors on ``device``, uploaded once per table and
    device (the decode loop reads them every layer of every step)."""
    device = torch.device(device)
    dev = table.__dict__.setdefault("_torch_thresholds", {})
    if device not in dev:
        dev[device] = (torch.from_numpy(table.lo).to(device),
                       torch.from_numpy(table.hi).to(device))
    return dev[device]


@dataclasses.dataclass
class AcamMap:
    """An ACAM unit compiled exactly: sorted breakpoints b_0 <= ... <=
    b_{n-1} and 2n + 1 codes, ``codes[2i + 1]`` the code at x == b_i and
    ``codes[2i]`` the code on the open gap (b_{i-1}, b_i) — gap 0 below
    b_0, gap n above b_{n-1}.  What kernels B and D search."""

    breakpoints: torch.Tensor  # (n,)      float32
    codes: torch.Tensor        # (2n + 1,) int32


def compile_thresholds(lo: torch.Tensor, hi: torch.Tensor,
                       encoding: str = "gray",
                       unique: bool = False) -> AcamMap:
    """Compile a threshold pair (bits, rows), any values, into an
    ``AcamMap`` on their device, equal to ``eval_table`` bit for bit.

    Every threshold is a breakpoint (NaN ones become +inf: an extra
    breakpoint is harmless, and the rows keep their NaN, which matches
    nothing).  On the open gap between neighbouring breakpoints b_i < b_j
    a row matches iff lo <= b_i and hi >= b_j, since its lo and hi are
    breakpoints themselves; at a breakpoint the rows are matched as the
    walk matches them.  Below the first and above the last breakpoint no
    row matches, and a NaN input (compared false everywhere) lands there,
    as in the walk.  ``unique`` drops repeated breakpoints (the search
    gets shorter) at the cost of a data-dependent size, which on the card
    waits for the device; without it a repeated value gives an empty gap
    that no input reaches."""
    v = torch.cat([lo.reshape(-1), hi.reshape(-1)]).to(torch.float32)
    v = torch.where(torch.isnan(v), torch.inf, v)
    bp = torch.unique(v) if unique else torch.sort(v).values
    lo_, hi_ = lo[None], hi[None]                   # (1, bits, rows)
    pt = (lo_ <= bp[:, None, None]) & (bp[:, None, None] <= hi_)
    gap = ((lo_ <= bp[:-1, None, None]) & (hi_ >= bp[1:, None, None]))
    g = torch.cat([torch.any(pt, -1), torch.any(gap, -1)]).to(torch.int32)
    b = gray_decode_bits(g) if encoding == "gray" else g
    weights = 2 ** torch.arange(b.shape[-1], device=b.device)
    code = torch.sum(b.to(torch.int64) * weights, dim=-1).to(torch.int32)
    n = bp.shape[0]
    codes = torch.zeros(2 * n + 1, dtype=torch.int32, device=bp.device)
    codes[1::2] = code[:n]
    codes[2:-1:2] = code[n:]
    return AcamMap(bp.contiguous(), codes)


def eval_compiled(acam_map: AcamMap, x: torch.Tensor, out_lo: float,
                  out_step: float) -> torch.Tensor:
    """The compiled unit on ``x`` (float32): the first breakpoint not
    below x, its code or its gap's, dequantized as ``eval_table``
    dequantizes."""
    bp, codes = acam_map.breakpoints, acam_map.codes
    x = x.to(torch.float32).contiguous()
    first = torch.searchsorted(bp, x, side="left")
    at = bp[first.clamp(max=bp.shape[0] - 1)] == x
    code = codes[2 * first + at.to(first.dtype)].to(torch.float32)
    return code * out_step + out_lo


def table_map(table: ACAMTable, device) -> AcamMap:
    """``table`` compiled (``unique``) on the host once and uploaded once
    per device, beside ``table_thresholds``: the serve path's kernel B and
    ``acam_apply`` read it without a per-call compile."""
    device = torch.device(device)
    dev = table.__dict__.setdefault("_torch_maps", {})
    if device not in dev:
        m = compile_thresholds(torch.from_numpy(table.lo),
                               torch.from_numpy(table.hi), table.encoding,
                               unique=True)
        dev[device] = AcamMap(m.breakpoints.to(device), m.codes.to(device))
    return dev[device]


@dataclasses.dataclass
class PiecewiseFn:
    """Sorted breakpoints b_0<...<b_{K-1} and K+1 region values."""

    name: str
    breakpoints: np.ndarray    # (K,)   float32
    values: np.ndarray         # (K+1,) float32

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        device = torch.device(device)
        dev = self.__dict__.setdefault("_torch", {})
        if device not in dev:
            dev[device] = (torch.from_numpy(self.breakpoints).to(device),
                           torch.from_numpy(self.values).to(device))
        return dev[device]


def compile_piecewise(table: ACAMTable) -> PiecewiseFn:
    """Collapse the per-bit intervals into one piecewise-constant map."""
    bps = np.unique(np.concatenate([
        table.lo[table.lo < 1e29].ravel(), table.hi[table.hi > -1e29].ravel()]))
    edges = np.concatenate([[bps[0] - 1.0], bps, [bps[-1] + 1.0]])
    mids = 0.5 * (edges[:-1] + edges[1:])
    vals = eval_table_np(table, mids).astype(np.float32)
    return PiecewiseFn(table.name, bps.astype(np.float32), vals)


def eval_piecewise(breakpoints: torch.Tensor, values: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """values[searchsorted(breakpoints, x, side="left")]."""
    idx = torch.searchsorted(breakpoints, x.to(torch.float32).contiguous(),
                             side="left")
    return values[idx]


_TABLE_CACHE: dict[tuple, ACAMTable] = {}
_PW_CACHE: dict[tuple, PiecewiseFn] = {}


def get_table(name: str, bits: int = 8, encoding: str = "gray",
              in_domain: tuple[float, float] | None = None) -> ACAMTable:
    """The table of ``name`` over ``in_domain`` (default: the function's
    reference domain), built once per (name, bits, encoding, domain)."""
    key = (name, bits, encoding, in_domain)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = build_table(name, bits=bits, encoding=encoding,
                                        in_domain=in_domain)
    return _TABLE_CACHE[key]


def get_piecewise(name: str, bits: int = 8,
                  in_domain: tuple[float, float] | None = None
                  ) -> PiecewiseFn:
    key = (name, bits, in_domain)
    if key not in _PW_CACHE:
        _PW_CACHE[key] = compile_piecewise(
            get_table(name, bits, "gray", in_domain))
    return _PW_CACHE[key]


def acam_activation(x: torch.Tensor, name: str, bits: int = 8,
                    in_domain: tuple[float, float] | None = None
                    ) -> torch.Tensor:
    """Model-level op: the ACAM-computed activation (piecewise fast path)."""
    bp, vals = get_piecewise(name, bits, in_domain).on(x.device)
    return eval_piecewise(bp, vals, x).to(x.dtype)

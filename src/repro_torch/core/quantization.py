"""Quantizers of the NL-DPE numerics (port of ``repro.core.quantization``).

Scalars on a quantization path follow the reference's rounding, not
PyTorch's defaults (``scalar_div``):

* float32: ``repro`` divides by a Python-float ``step`` inside ``jit``,
  and XLA rewrites ``x / c`` as ``x * (1/c)`` with the reciprocal taken in
  float32.  PyTorch's CPU kernel divides exactly while its CUDA kernel
  multiplies by a reciprocal, so the same expression would round
  differently on the two devices.  The port multiplies by ``recip(c)``.
* bfloat16: JAX rounds a Python scalar to the array's type first (weak
  typing) and then divides; PyTorch would keep the scalar in float32.
  The port rounds the scalar first (``weak``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def recip(s: float) -> float:
    """float32 reciprocal of ``s`` (XLA's rewrite of division by ``s``)."""
    return float(np.float32(1.0) / np.float32(s))


def weak(s: float, x: torch.Tensor) -> float:
    """Python scalar ``s`` rounded to ``x``'s dtype, as JAX's weak typing
    rounds it before a binary op."""
    if x.dtype == torch.float32:
        return s
    return float(torch.tensor(s, dtype=x.dtype))


def scalar_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded as the reference rounds it under ``jit``."""
    if x.dtype == torch.float32:
        return x * recip(s)
    return x / weak(s, x)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Uniform affine quantizer on [lo, hi] with ``bits`` bits."""

    lo: float
    hi: float
    bits: int = 8

    @property
    def levels(self) -> int:
        return 1 << self.bits

    @property
    def step(self) -> float:
        return (self.hi - self.lo) / (self.levels - 1)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """float -> integer code in [0, levels-1] (round-half-even, clipped)."""
        q = torch.round(scalar_div(x - weak(self.lo, x), self.step))
        return torch.clamp(q, 0, self.levels - 1).to(torch.int32)

    def dequantize(self, code: torch.Tensor) -> torch.Tensor:
        return code.to(torch.float32) * self.step + self.lo

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Quantize-dequantize (the value an ideal n-bit ACAM/ADC emits)."""
        return self.dequantize(self.quantize(x))


def spec_for(values, bits: int = 8, symmetric: bool = False) -> QuantSpec:
    """Fit a QuantSpec to observed values (host-side helper)."""
    v = np.asarray(values, dtype=np.float64)
    lo, hi = float(v.min()), float(v.max())
    if symmetric:
        m = max(abs(lo), abs(hi))
        lo, hi = -m, m
    if hi <= lo:
        hi = lo + 1e-6
    return QuantSpec(lo=lo, hi=hi, bits=bits)


@dataclasses.dataclass(frozen=True)
class LogQuantSpec:
    """Sign-magnitude log-domain quantizer: ``log|x|`` on a uniform
    ``bits``-bit grid over ``[log_lo, log_hi]``, the sign carried apart."""

    log_lo: float
    log_hi: float
    bits: int = 8

    @property
    def levels(self) -> int:
        return 1 << self.bits

    @property
    def step(self) -> float:
        return (self.log_hi - self.log_lo) / (self.levels - 1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x -> (code int32, sign float {-1, 0, +1})."""
        sign = torch.sign(x)
        floor = weak(float(np.exp(np.float32(self.log_lo))), x)
        logm = torch.log(torch.clamp(torch.abs(x), min=floor))
        code = torch.clamp(torch.round(scalar_div(
            logm - weak(self.log_lo, x), self.step)),
            0, self.levels - 1).to(torch.int32)
        return code, sign

    def decode(self, code: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
        return sign * torch.exp(code.to(torch.float32) * self.step
                                + self.log_lo)

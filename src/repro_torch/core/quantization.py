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


# ---------------------------------------------------------------------------
# The KV-cache log grid (DESIGN.md §11): the drafter's sign-magnitude log
# quantizer renormalized per storage granule.  Scales carry the absmax, so
# magnitudes land on (0, 1] and 7 bits of log grid cover four decades at a
# uniform ~3.6% max relative error; the int8 sign carries the sign and code
# 0 is the flushed zero.
# ---------------------------------------------------------------------------

KV_LOG_SPEC = LogQuantSpec(log_lo=float(np.log(1e-4)), log_hi=0.0, bits=7)

# The committed error contract of the log8 KV grid: for every element x of a
# granule with absmax scale,
#   |decode(encode(x)) - x| <= max(KV_LOG8_REL_ERR * |x|,
#                                  KV_LOG8_FLUSH * scale)
# (half a log-grid step of relative error; magnitudes under the flush
# threshold reconstruct as 0).
KV_LOG8_REL_ERR = float(np.expm1(KV_LOG_SPEC.step / 2))         # ~3.7%
KV_LOG8_FLUSH = float(np.exp(KV_LOG_SPEC.log_lo + KV_LOG_SPEC.step / 2))

KV_QUANT_MODES = ("int8", "log8")


def kv_log_arg(codes: torch.Tensor) -> torch.Tensor:
    """The exp argument ``|code| * step + log_lo`` of the log8 grid, rounded
    once to float32 as XLA contracts it into an FMA under ``jit``: the
    product of a 7-bit code and a float32 step is exact in float64, and so
    is the sum, so one rounding of the float64 value is the FMA's."""
    c = codes.to(torch.float64).abs()
    return (c * float(np.float32(KV_LOG_SPEC.step))
            + float(np.float32(KV_LOG_SPEC.log_lo))).to(torch.float32)


def kv_decode(codes: torch.Tensor, scale: torch.Tensor | None = None,
              mode: str = "int8") -> torch.Tensor:
    """Dequantize signed int8 KV codes (``nn.attention._quantize_kv``'s
    inverse up to the grid); ``scale`` broadcasts over the trailing
    (feature) axis.

    ``"int8"``: value = code * scale (scale carries absmax / 127).
    ``"log8"``: sign-magnitude — |code| indexes ``KV_LOG_SPEC``'s 7-bit log
    grid, the sign of the code is the sign (0 = flushed zero), and scale
    carries the granule's absmax.
    """
    c = codes.to(torch.float32)
    if mode == "log8":
        v = torch.sign(c) * torch.exp(kv_log_arg(codes))
    elif mode == "int8":
        v = c
    else:
        raise ValueError(f"unknown kv quant mode {mode!r}")
    if scale is not None:
        v = v * scale[..., None]
    return v


def kv_table(mode: str, device) -> torch.Tensor:
    """``kv_decode`` of every int8 code, -128..127, as a (256,) float32
    table on ``device``, built there once per (mode, device) with the plain
    formula and cached: ``table[code + 128] * scale`` is then bit for bit
    ``kv_decode(code, scale, mode)`` on that device (kernel A's
    quantized-pool variant decodes through it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (mode, device)
    if key not in _KV_TABLES:
        codes = torch.arange(-128, 128, dtype=torch.int32, device=device)
        _KV_TABLES[key] = kv_decode(codes.to(torch.int8), None, mode)
    return _KV_TABLES[key]


_KV_TABLES: dict[tuple, torch.Tensor] = {}


# ---------------------------------------------------------------------------
# Stochastic-free fake-quant for NAF training (straight-through estimator)
# ---------------------------------------------------------------------------

class _FakeQuantSTE(torch.autograd.Function):
    """``spec.apply(x)`` forward, identity backward (``repro``'s
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, spec):
        return spec.apply(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant_ste(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize-dequantize ``x`` on ``spec``'s grid; the gradient passes
    through unchanged (straight-through estimator)."""
    return _FakeQuantSTE.apply(x, spec)

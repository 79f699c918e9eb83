"""Log-domain DMMul and Softmax (port of ``repro.core.logdomain``, paper
§III-D, Fig 6).

    a * b = exp(log a + log b)                       (Eq 3)

``log`` and ``exp`` are single-variable functions computed by 8-bit ACAMs,
so every log/exp crossing quantizes to an 8-bit grid: the DMMul number
format is sign-magnitude 8-bit log quantization.  Only the ``fused`` mode
(a plain matmul over log-quantized reconstructions) is on the serve path.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .quantization import LogQuantSpec, QuantSpec, weak


@dataclasses.dataclass(frozen=True)
class LogDomainConfig:
    """Quantization grids for the DMMul/Softmax pipeline."""

    bits: int = 8
    mag_spec: LogQuantSpec = LogQuantSpec(log_lo=math.log(1e-4),
                                          log_hi=math.log(16.0), bits=8)
    # scores are max-shifted into [-score_range, 0] before exp
    score_range: float = 8.0


DEFAULT_CFG = LogDomainConfig()


def log_quantize(x: torch.Tensor,
                 cfg: LogDomainConfig = DEFAULT_CFG) -> torch.Tensor:
    """sign * exp(q8(log|x|)); |x| below the grid floor flushes to 0."""
    code, sign = cfg.mag_spec.encode(x)
    dead = torch.abs(x) < weak(math.exp(cfg.mag_spec.log_lo), x)
    return torch.where(dead, 0.0, cfg.mag_spec.decode(code, sign))


def nldpe_mul(a: torch.Tensor, b: torch.Tensor,
              cfg: LogDomainConfig = DEFAULT_CFG) -> torch.Tensor:
    """Element-wise DMMul, fused mode (the gated-MLP gate * up product)."""
    return log_quantize(a, cfg) * log_quantize(b, cfg)


def nldpe_log_softmax(y: torch.Tensor, cfg: LogDomainConfig = DEFAULT_CFG,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Fig 6b steps 1-4 over the last axis, output left in the log domain
    for the DMMul_2 bypass.  ``mask`` (True = attend) gates masked
    positions digitally, before the adder tree."""
    if mask is not None:
        y = torch.where(mask, y, -torch.inf)
    mx = torch.amax(y, dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    y = y - mx
    in_spec = QuantSpec(lo=-cfg.score_range, hi=0.0, bits=cfg.bits)
    yq = in_spec.apply(torch.where(torch.isfinite(y), y, -cfg.score_range))
    s = torch.exp(yq)                                      # step 1: exp ACAM
    exp_spec = QuantSpec(lo=0.0, hi=1.0, bits=cfg.bits)
    sq = exp_spec.apply(s)                                 # 8-bit exp output
    if mask is not None:
        sq = torch.where(mask, sq, 0.0)                    # digital gating
    total = torch.sum(sq, dim=-1, keepdim=True)            # step 2: adders
    length = y.shape[-1]
    log_spec = QuantSpec(lo=-cfg.score_range,
                         hi=float(math.log(length + 1)), bits=cfg.bits)
    log_total = log_spec.apply(torch.log(torch.clamp(total, min=1e-9)))
    out = yq - log_total                                   # step 4: subtract
    if mask is not None:
        out = torch.where(mask, out, -torch.inf)
    return out


def nldpe_matmul_loga(log_a: torch.Tensor, b: torch.Tensor,
                      cfg: LogDomainConfig = DEFAULT_CFG,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """exp(log_a) @ B with B entering through log ACAMs; masked entries
    contribute exactly 0."""
    la_spec = QuantSpec(lo=-2 * cfg.score_range, hi=0.0, bits=cfg.bits)
    a_lin = torch.exp(la_spec.apply(torch.where(
        torch.isfinite(log_a), log_a, -2 * cfg.score_range)))
    if mask is not None:
        a_lin = torch.where(mask, a_lin, 0.0)
    return torch.matmul(a_lin, log_quantize(b, cfg))


def inv_sqrt(d: int) -> float:
    """1/sqrt(d) rounded as the reference computes it (f32 sqrt, then an
    f32 division)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))

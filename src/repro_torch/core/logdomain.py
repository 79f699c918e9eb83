"""Log-domain DMMul and Softmax (port of ``repro.core.logdomain``, paper
§III-D, Fig 6).

    a * b = exp(log a + log b)                       (Eq 3)

``log`` and ``exp`` are single-variable functions computed by 8-bit ACAMs,
so every log/exp crossing quantizes to an 8-bit grid: the DMMul number
format is sign-magnitude 8-bit log quantization.  The ``fused`` mode (a
plain matmul over log-quantized reconstructions) is on the serve path;
``exact`` re-quantizes every product and is the fidelity oracle.
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

    def exp_out_spec(self) -> QuantSpec:
        """Grid for q8(exp(la+lb)) outputs in ``exact`` mode."""
        hi = math.exp(2 * self.mag_spec.log_hi)
        return QuantSpec(lo=0.0, hi=hi, bits=self.bits)


DEFAULT_CFG = LogDomainConfig()


def encode_live(x: torch.Tensor, cfg: LogDomainConfig = DEFAULT_CFG
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(code, sign) on the DMMul grid, sign 0 where |x| is below the grid
    floor (a flushed zero)."""
    code, sign = cfg.mag_spec.encode(x)
    dead = torch.abs(x) < weak(math.exp(cfg.mag_spec.log_lo), x)
    return code, torch.where(dead, 0.0, sign)


def log_quantize(x: torch.Tensor,
                 cfg: LogDomainConfig = DEFAULT_CFG) -> torch.Tensor:
    """sign * exp(q8(log|x|)); |x| below the grid floor flushes to 0."""
    return cfg.mag_spec.decode(*encode_live(x, cfg))


def _exp_lut_arg(sums: torch.Tensor, cfg: LogDomainConfig) -> torch.Tensor:
    """exp's argument for a code sum: ``sum * step + 2 * log_lo``."""
    spec = cfg.mag_spec
    return sums.to(torch.float32) * spec.step + 2 * spec.log_lo


def nldpe_matmul(a: torch.Tensor, b: torch.Tensor,
                 cfg: LogDomainConfig = DEFAULT_CFG, mode: str = "fused",
                 block_k: int = 64) -> torch.Tensor:
    """C = A @ B through the log-domain ACAM pipeline (Fig 6a).
    a: (..., M, K), b: (..., K, N).

    * ``fused`` — a plain matmul over the log-quantized reconstructions
      (exp(la + lb) = exp(la) * exp(lb) on the grid; kernel G computes
      this mode from int8 codes).
    * ``exact`` — each product's exp is its own 8-bit ACAM output:
      C = sum_k s * q8(exp(la + lb)), a LUT over code sums, summed in
      ``block_k`` slices of K."""
    if mode == "fused":
        return torch.matmul(log_quantize(a, cfg), log_quantize(b, cfg))
    if mode != "exact":
        raise ValueError(mode)
    ca, sa = encode_live(a, cfg)
    cb, sb = encode_live(b, cfg)
    sums = torch.arange(2 * cfg.mag_spec.levels - 1, device=a.device)
    lut = cfg.exp_out_spec().apply(torch.exp(_exp_lut_arg(sums, cfg)))
    k = a.shape[-1]
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, k, block_k):
        k1 = min(k0 + block_k, k)
        idx = ca[..., :, k0:k1, None] + cb[..., None, k0:k1, :]
        prod = lut[idx.long()]                       # (..., M, kb, N)
        sgn = sa[..., :, k0:k1, None] * sb[..., None, k0:k1, :]
        out = out + torch.sum(prod * sgn, dim=-2)
    return out


def nldpe_mul(a: torch.Tensor, b: torch.Tensor,
              cfg: LogDomainConfig = DEFAULT_CFG,
              mode: str = "fused") -> torch.Tensor:
    """Element-wise DMMul (the gated-MLP gate * up product): ``fused``
    multiplies the log-quantized values, ``exact`` re-quantizes each
    product's exp on the 8-bit output grid."""
    if mode == "fused":
        return log_quantize(a, cfg) * log_quantize(b, cfg)
    if mode != "exact":
        raise ValueError(mode)
    ca, sa = encode_live(a, cfg)
    cb, sb = encode_live(b, cfg)
    mag = cfg.exp_out_spec().apply(torch.exp(_exp_lut_arg(ca + cb, cfg)))
    return mag * (sa * sb)


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
    # step 2: the adder tree.  Every 8-bit exp output is 0 or at least
    # 1/255, a multiple of 2^-32, so a float64 sum is exact below 2^21
    # terms: rounded once, the sum is the same in any order (kernel C's
    # fixed-point sum, csrc/logdomain_flash.cu, gives the same bits)
    total = torch.sum(sq.to(torch.float64), dim=-1, keepdim=True).to(sq.dtype)
    length = y.shape[-1]
    log_spec = QuantSpec(lo=-cfg.score_range,
                         hi=float(math.log(length + 1)), bits=cfg.bits)
    log_total = log_spec.apply(torch.log(torch.clamp(total, min=1e-9)))
    out = yq - log_total                                   # step 4: subtract
    if mask is not None:
        out = torch.where(mask, out, -torch.inf)
    return out


def nldpe_softmax(y: torch.Tensor, cfg: LogDomainConfig = DEFAULT_CFG,
                  axis: int = -1) -> torch.Tensor:
    """Full Fig 6b: steps 1-4, then step 5's exp ACAM back to the linear
    scale on the [0, 1] 8-bit grid."""
    logp = nldpe_log_softmax(y.movedim(axis, -1), cfg).movedim(-1, axis)
    out_spec = QuantSpec(lo=0.0, hi=1.0, bits=cfg.bits)
    p_spec_in = QuantSpec(lo=-2 * cfg.score_range, hi=0.0, bits=cfg.bits)
    return out_spec.apply(torch.exp(p_spec_in.apply(logp)))   # step 5


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

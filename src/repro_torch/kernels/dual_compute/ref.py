"""Plain PyTorch versions of the dual-compute kernels (port of
``repro.kernels.dual_compute.ref``).

* ``fused_crossbar_acam_ref`` — the crossbar VMM, then the plain ACAM
  interval match and Gray decode.
* ``logdomain_flash_ref`` — NL-DPE attention with the scores materialized:
  the whole (Lq, Lk) score matrix through ``nldpe_attention``, GQA heads
  repeated on entry.

W_eff is formed as the reference's kernel forms it, with the residual
scaled by the float32 reciprocal of ``res_gain`` (what ``ref.py``'s
``/ res_gain`` becomes under ``jit``).
"""
from __future__ import annotations

import torch

from ...core.acam import eval_table
from ...core.attention import nldpe_attention
from ...core.logdomain import DEFAULT_CFG, LogDomainConfig
from ...core.quantization import recip


def effective_weight(g_pos, g_neg, g_pos_res, g_neg_res, inv_g_ratio,
                     res_gain: float = 10.0) -> torch.Tensor:
    w = (g_pos - g_neg) + (g_pos_res - g_neg_res) * recip(res_gain)
    return w * inv_g_ratio


def fused_crossbar_acam_ref(x, g_pos, g_neg, g_pos_res, g_neg_res,
                            inv_g_ratio, lo, hi, bits: int = 8,
                            out_lo: float = 0.0, out_step: float = 1.0,
                            res_gain: float = 10.0) -> torch.Tensor:
    """x (M, K) f32, cells (K, N) f32, inv_g_ratio 0-d f32 -> (M, N)."""
    del bits                             # implied by lo/hi
    y = x @ effective_weight(g_pos, g_neg, g_pos_res, g_neg_res,
                             inv_g_ratio, res_gain)
    return eval_table(lo, hi, y, out_lo, out_step)


def logdomain_flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cfg: LogDomainConfig = DEFAULT_CFG,
                        causal: bool = True) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, Hkv, Lk, D), raw (not yet log-quantized)
    -> (B, H, Lq, D) float32.  Inputs are upcast to float32 before they
    are log-quantized, as the kernel's wrapper (and ``repro``'s kernel
    path) upcasts them: bf16 arithmetic would move their log-grid codes."""
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    return nldpe_attention(q, k, v, cfg, causal=causal)

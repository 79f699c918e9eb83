"""Plain PyTorch fused crossbar->ACAM: the crossbar VMM, then the plain
ACAM interval match and Gray decode (port of
``repro.kernels.dual_compute.ref.fused_crossbar_acam_ref``).

W_eff is formed as the reference's kernel forms it, with the residual
scaled by the float32 reciprocal of ``res_gain`` (what ``ref.py``'s
``/ res_gain`` becomes under ``jit``).
"""
from __future__ import annotations

import torch

from ...core.acam import eval_table
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

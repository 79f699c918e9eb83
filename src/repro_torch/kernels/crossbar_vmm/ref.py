"""Plain PyTorch version of the crossbar VMM kernel (port of
``repro.kernels.crossbar_vmm.ref``): W_eff formed as kernels B and E form
it — the residual scaled by the float32 reciprocal of ``res_gain`` (the
reference kernel's ``* (1.0 / res_gain)``), then ``* inv`` — and one
float32 matmul."""
from __future__ import annotations

import torch

from ..dual_compute.ref import effective_weight


def crossbar_vmm_ref(x: torch.Tensor, g_pos: torch.Tensor,
                     g_neg: torch.Tensor, g_pos_res: torch.Tensor,
                     g_neg_res: torch.Tensor, inv_g_ratio: float,
                     res_gain: float = 10.0) -> torch.Tensor:
    """x (M, K) float32, cells (K, N) float32, inv_g_ratio a host float
    (used as float32) -> (M, N) float32."""
    return x @ effective_weight(g_pos, g_neg, g_pos_res, g_neg_res,
                                inv_g_ratio, res_gain)

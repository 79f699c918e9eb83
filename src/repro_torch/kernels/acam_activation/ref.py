"""Plain PyTorch version of the ACAM activation kernel (port of
``repro.kernels.acam_activation.ref``): the interval match, OR over rows,
Gray decode and dequantization of ``core.acam.eval_table``, on float32
inputs."""
from __future__ import annotations

import torch

from ...core.acam import eval_table


def acam_activation_ref(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                        out_lo: float = 0.0,
                        out_step: float = 1.0) -> torch.Tensor:
    """x any shape (upcast to float32), lo/hi (bits, rows) float32 ->
    float32 in x's shape."""
    return eval_table(lo, hi, x.to(torch.float32), out_lo, out_step)

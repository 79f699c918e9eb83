"""Plain PyTorch version of the log-domain int8 DMMul kernel (port of
``repro.kernels.nldpe_qmatmul.ref``): dequantize the codes, then one
float32 matmul.

``(code + 128) * step + log_lo`` is rounded once, as XLA contracts the
reference kernel's multiply-add into an FMA under ``jit``: the product of
a code (8 bits) and a float32 step is exact in float64, and so is the sum
with ``log_lo``, so one rounding of the float64 value to float32 is the
FMA's result.
"""
from __future__ import annotations

import numpy as np
import torch


def dequant_ref(code: torch.Tensor, sign: torch.Tensor, step: float,
                log_lo: float) -> torch.Tensor:
    """Centered int8 codes and int8 signs -> float32 values."""
    c = code.to(torch.float64) + 128.0
    arg = (c * float(np.float32(step))
           + float(np.float32(log_lo))).to(torch.float32)
    return sign.to(torch.float32) * torch.exp(arg)


def nldpe_qmatmul_ref(a_code, a_sign, b_code, b_sign, step: float,
                      log_lo: float) -> torch.Tensor:
    """a_*: (M, K) int8, b_*: (K, N) int8 -> (M, N) float32."""
    a = dequant_ref(a_code, a_sign, step, log_lo)
    b = dequant_ref(b_code, b_sign, step, log_lo)
    return torch.matmul(a, b)

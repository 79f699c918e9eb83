"""Log-domain int8 DMMul wrapper (port of
``repro.kernels.nldpe_qmatmul.ops``): float operands -> the analog
engine's wire format (centered int8 codes, int8 signs) -> C = A @ B, the
CUDA kernel ``csrc/nldpe_qmatmul.cu`` for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.  The kernel masks ragged M/N/K edges where
the reference pads to 128 with sign 0."""
from __future__ import annotations

import ctypes

import torch

from ...core.logdomain import DEFAULT_CFG, LogDomainConfig, encode_live
from .. import build
from .ref import nldpe_qmatmul_ref


def _lib():
    lib = build.load("nldpe_qmatmul")
    if not getattr(lib, "_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nldpe_qmatmul_launch.argtypes = [vp] * 5 + [i, i, i, f, f, vp]
        lib.nldpe_qmatmul_launch.restype = i
        lib.nldpe_qmatmul_variant.argtypes = [i, i]
        lib.nldpe_qmatmul_variant.restype = i
        lib._typed = True
    return lib


def encode_int8(x: torch.Tensor, cfg: LogDomainConfig = DEFAULT_CFG
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float -> (centered int8 code, int8 sign); values below the grid
    floor (zeros among them) get sign 0."""
    code, sign = encode_live(x, cfg)
    return (code - 128).to(torch.int8), sign.to(torch.int8)


def nldpe_qmatmul(a_code: torch.Tensor, a_sign: torch.Tensor,
                  b_code: torch.Tensor, b_sign: torch.Tensor, step: float,
                  log_lo: float) -> torch.Tensor:
    """a_*: (M, K) int8, b_*: (K, N) int8 -> (M, N) float32.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise —
    there is no fallback)."""
    if a_code.device.type == "cpu":
        return nldpe_qmatmul_ref(a_code, a_sign, b_code, b_sign, step,
                                 log_lo)
    operands = (a_code, a_sign, b_code, b_sign)
    m, k = a_code.shape
    k2, n = b_code.shape
    if any(t.dtype != torch.int8 for t in operands):
        raise TypeError("nldpe_qmatmul: codes and signs must be int8")
    if any(t.device != a_code.device for t in operands):
        raise ValueError("nldpe_qmatmul: all operands on one device")
    if a_sign.shape != (m, k) or b_sign.shape != (k2, n) or k2 != k \
            or min(m, n, k) < 1:
        raise ValueError(f"nldpe_qmatmul: shapes A {tuple(a_code.shape)}, "
                         f"B {tuple(b_code.shape)}")
    operands = tuple(t.contiguous() for t in operands)
    out = torch.empty((m, n), dtype=torch.float32, device=a_code.device)
    err = _lib().nldpe_qmatmul_launch(
        *(t.data_ptr() for t in operands), out.data_ptr(), m, n, k, step,
        log_lo, torch.cuda.current_stream(a_code.device).cuda_stream)
    build.check(err, "nldpe_qmatmul")
    nldpe_qmatmul.launches += 1
    return out


nldpe_qmatmul.launches = 0


def tile_variant(m: int, n: int) -> str:
    """The tile (``xbar::choose``) kernel G launches at (M, N)."""
    return build.TILE_VARIANTS[_lib().nldpe_qmatmul_variant(m, n)]


def nldpe_matmul_int8(a: torch.Tensor, b: torch.Tensor,
                      cfg: LogDomainConfig = DEFAULT_CFG) -> torch.Tensor:
    """C = A @ B through the NL-DPE log-quantized path: a (M, K), b (K, N)
    -> (M, N) float32 (``nldpe_matmul(a, b, mode="fused")`` computed from
    the int8 wire format)."""
    spec = cfg.mag_spec
    ac, as_ = encode_int8(a, cfg)
    bc, bs = encode_int8(b, cfg)
    return nldpe_qmatmul(ac, as_, bc, bs, spec.step, spec.log_lo)

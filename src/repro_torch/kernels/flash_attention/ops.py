"""Causal GQA flash attention wrapper: the CUDA kernel
``csrc/flash_attention.cu`` for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

Port of ``repro.kernels.flash_attention.ops.flash_attention``: inputs are
upcast to float32 and the output is cast back to ``q``'s dtype.  The
kernel masks ragged edges itself, so the reference wrapper's shrinking of
its blocks to divisors of the lengths (a TPU tiling rule) has no
counterpart here.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...core.quantization import recip
from .. import build
from .ref import flash_attention_ref


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [vp, vp, vp, vp] + [i] * 7 + [
            f, vp]
        lib.flash_attention_launch.restype = i
        lib._typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, Hkv, Lk, D) with H % Hkv == 0 ->
    (B, H, Lq, D) in q's dtype.  Query ``i`` sits at position
    ``i + Lk - Lq``; a row with no visible key gives 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise — there is no fallback)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal).to(q.dtype)
    b, hq, lq, d = q.shape
    b2, hkv, lk, d2 = k.shape
    if b2 != b or d2 != d or v.shape != k.shape or hq % hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in (16, 32, 64, 128):
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"(16, 32, 64, 128)")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: all operands on one device")
    if min(b, hq, lq, lk) < 1:
        raise ValueError("flash_attention: empty operand")
    qf, kf, vf = (t.to(torch.float32).contiguous() for t in (q, k, v))
    out = torch.empty((b, hq, lq, d), dtype=torch.float32, device=q.device)
    err = _lib().flash_attention_launch(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
        b, hq, hkv, lq, lk, d, int(causal), recip(math.sqrt(d)),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out.to(q.dtype)


flash_attention.launches = 0

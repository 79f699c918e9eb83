"""Causal GQA flash attention wrapper: the CUDA kernel
``csrc/flash_attention.cu`` for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

Port of ``repro.kernels.flash_attention.ops.flash_attention``.  Unlike
``repro``'s wrapper it converts nothing where the operands are all float32
or all bfloat16: the kernel reads them as they are (strided over batch,
head and position, the head dim contiguous) and writes the output in q's
dtype.  Other floating dtypes, or a mix, are upcast to float32 on the card
first and the output cast to q's dtype, as ``repro`` does.  It masks ragged
edges itself, so the reference wrapper's shrinking of its blocks to
divisors of the lengths (a TPU tiling rule) has no counterpart here.

``plan`` (host only, so the CPU tests reach it) gives the kernel's
instance for an operand dtype and head dim: its rows per block, keys per
K/V tile, ring depth and shared memory, as ``csrc/flash_attention.cu``
lays them out.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ...core.quantization import recip
from .. import build
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
STAGES = 2           # K/V ring depth
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of kernel F: the instance (its operand dtype), query rows
    per block, keys per K/V tile, ring depth and dynamic shared memory."""
    instance: str
    rows: int
    keys: int
    stages: int
    smem: int


def plan(dtype: torch.dtype, d: int) -> Plan:
    """The kernel's layout for operands of ``dtype`` and head dim ``d``
    (``Layout`` of the CUDA source, byte for byte): 128 query rows a block
    (eight warps of 16), 64 at d = 256 (four warps: 128 rows would need
    265 KB of shared memory); the ring's stages of a K tile (rows of d + 4
    floats; bf16 d + 32 halves above d = 32) and a V tile (d + 4 floats;
    d + 8 halves), then the block's scaled q rows of d + 2 floats."""
    if dtype not in _ELEM or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no instance for {dtype}, "
                         f"head_dim {d}")
    elem = _ELEM[dtype]
    rows = 64 if d > 128 else 128
    keys = 32 if elem == 4 else 64
    pk = d + 4 if elem == 4 else (d if d <= 32 else d + 32)
    pv = d + 4 if elem == 4 else d + 8
    smem = STAGES * keys * (pk + pv) * elem + rows * (d + 2) * 4
    return Plan(str(dtype).split(".")[-1], rows, keys, STAGES, smem)


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 8 + [
            f, ctypes.POINTER(ctypes.c_longlong), vp]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its last axis is contiguous and every row it steps to
    starts 16-byte aligned (what the kernels' vector loads and cp.async
    copies need), else a contiguous copy in the same dtype."""
    esz = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(n == 1 or (s * esz) % 16 == 0
                  for n, s in zip(t.shape[:-1], t.stride()[:-1])))
    if ok:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format
                            ).copy_(t)


def strides(*ts: torch.Tensor):
    """The (batch, head, position) strides of each operand, in elements,
    as the C array the launches take."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, Hkv, Lk, D) with H % Hkv == 0 ->
    (B, H, Lq, D) in q's dtype.  Query ``i`` sits at position
    ``i + Lk - Lq``; a row with no visible key gives 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise — there is no fallback): its instance for q, k and v all float32
    or all bfloat16, else its float32 instance on upcast copies."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal).to(q.dtype)
    b, hq, lq, d = q.shape
    b2, hkv, lk, d2 = k.shape
    if b2 != b or d2 != d or v.shape != k.shape or hq % hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if any(not t.is_floating_point() for t in (q, k, v)):
        raise TypeError("flash_attention: operands must be floating point")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: all operands on one device")
    if min(b, hq, lq, lk) < 1:
        raise ValueError("flash_attention: empty operand")
    out_dtype = q.dtype
    if q.dtype not in _ELEM or k.dtype != q.dtype or v.dtype != q.dtype:
        q, k, v = (t.to(torch.float32) for t in (q, k, v))
    q, k, v = (rows_aligned(t) for t in (q, k, v))
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hq, hkv, lq, lk, d, int(causal),
        recip(math.sqrt(d)), strides(q, k, v),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out.to(out_dtype)


flash_attention.launches = 0

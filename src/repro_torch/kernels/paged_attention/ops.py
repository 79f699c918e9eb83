"""Paged attention wrapper: the CUDA kernel ``csrc/paged_attention.cu`` for
CUDA tensors, the plain version (``ref.py``) for CPU tensors.

Port of ``repro.kernels.paged_attention.ops.paged_attention`` for fp pools.
Unlike ``repro``'s wrapper it never upcasts the pool: the kernel reads
pages in the pool's dtype (float32 or bfloat16) and accumulates in f32.
Block tables pass through raw — entries outside ``[0, num_pages)`` are the
unmapped sentinel, which the kernel never dereferences.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import paged_attention_ref

_BLOCKS_PER_SM = 4  # 128-thread blocks: 16 warps per SM to hide latency
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [vp, vp, vp, i, vp, vp, vp, vp,
                                               vp, i, i, i, i, i, i, i, i, i,
                                               vp]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_smem_bytes.argtypes = [i, i]
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_rows_per_block.restype = i
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(b: int, hkv: int, n_rows: int, nb: int, rows: int,
               sms: int) -> int:
    """Page-axis splits: enough (sequence, head, row tile) blocks to give
    each of the card's ``sms`` SMs ``_BLOCKS_PER_SM``, never more splits
    than pages."""
    blocks = b * hkv * (-(-n_rows // rows))
    target = _BLOCKS_PER_SM * sms
    if blocks >= target:
        return 1
    return max(1, min(nb, -(-target // blocks)))


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, Q, D); k_pages/v_pages (P, Hkv, ps, D) float32 or
    bfloat16; block_tables (B, NB) int32; lengths (B,) int32 with
    ``lengths >= 1`` — query row ``j`` of sequence ``b`` attends to logical
    positions ``[0, lengths[b] + j)``.  Returns (B, Hq, Q, D) float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise — there is no fallback)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    b, hq, q_len, d = q.shape
    num_pages, hkv, ps, d2 = k_pages.shape
    nb = block_tables.shape[1]
    if d2 != d or v_pages.shape != k_pages.shape or hq % hkv:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    if k_pages.dtype not in _POOL_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention: pools must be float32 or bfloat16,"
                        f" got {k_pages.dtype}/{v_pages.dtype}")
    if d not in (16, 32, 64, 128):
        raise ValueError(f"paged_attention: head_dim {d} not in "
                         f"(16, 32, 64, 128)")
    if (block_tables.dtype != torch.int32 or lengths.dtype != torch.int32
            or block_tables.shape[0] != b or lengths.shape != (b,)):
        raise TypeError("paged_attention: block_tables (B, NB) and lengths "
                        "(B,) must be int32")
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all operands on one device")
    lib = _lib()
    smem = lib.paged_attention_smem_bytes(d, ps)
    if smem > 227 * 1024:
        raise ValueError(f"paged_attention: page_size {ps} needs {smem} B "
                         f"of shared memory per block (> 227 KB)")
    q = q.float().contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    block_tables, lengths = block_tables.contiguous(), lengths.contiguous()
    g = hq // hkv
    rows = lib.paged_attention_rows_per_block()
    splits = num_splits(b, hkv, g * q_len, nb, rows,
                        _sm_count(q.device.index))
    out = torch.empty((b, hq, q_len, d), dtype=torch.float32, device=q.device)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b * hkv, splits, g * q_len, d),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b * hkv, splits, g * q_len, 2),
                              dtype=torch.float32, device=q.device)
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        _POOL_DTYPES[k_pages.dtype], block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        b, hq, hkv, q_len, d, num_pages, ps, nb, splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

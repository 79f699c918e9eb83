"""Paged attention wrapper: the CUDA kernel ``csrc/paged_attention.cu`` for
CUDA tensors, the plain version (``ref.py``) for CPU tensors.

Port of ``repro.kernels.paged_attention.ops.paged_attention``.  Unlike
``repro``'s wrapper it never upcasts an fp pool: the kernel reads pages in
the pool's dtype (float32 or bfloat16) and accumulates in f32.  Quantized
pools (``kv_quant`` "int8"/"log8": int8 codes with (P, Hkv, ps) float32
scales) stay int8 into the kernel, which decodes each page as it stages
it, through the 256-entry table ``core.quantization.kv_table`` — so the
kernel and the plain version decode to the same values.  Block tables
pass through raw — entries outside ``[0, num_pages)`` are the unmapped
sentinel, which the kernel never dereferences (nor its scale row).

``paged_attention.launches`` counts every launch, and
``paged_attention.pool_launches`` counts them by pool kind ("float32",
"bfloat16", "int8", "log8").
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ...core.quantization import KV_QUANT_MODES, kv_table
from .ref import paged_attention_ref

_BLOCKS_PER_SM = 4  # 128-thread blocks: 16 warps per SM to hide latency
_POOL_KINDS = {"float32": 0, "bfloat16": 1, "int8": 2, "log8": 2}


def _lib():
    lib = build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [vp, vp, vp, i, vp, vp, vp,
                                               vp, vp, vp, vp, vp, i, i, i, i,
                                               i, i, i, i, i, vp]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_smem_bytes.argtypes = [i, i, i]
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
                    lengths: torch.Tensor,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    kv_quant: str | None = None) -> torch.Tensor:
    """q (B, Hq, Q, D); k_pages/v_pages (P, Hkv, ps, D) float32 or
    bfloat16 — or int8 codes on the ``kv_quant`` grid ("int8"/"log8") with
    k_scale/v_scale (P, Hkv, ps) float32 (scales without a mode mean
    "int8", as in ``repro``); block_tables (B, NB) int32; lengths (B,)
    int32 with ``lengths >= 1`` — query row ``j`` of sequence ``b`` attends
    to logical positions ``[0, lengths[b] + j)``.  Returns (B, Hq, Q, D)
    float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise — there is no fallback)."""
    if kv_quant is None and k_scale is not None:
        kv_quant = "int8"
    if kv_quant is not None and (kv_quant not in KV_QUANT_MODES
                                 or k_scale is None or v_scale is None):
        raise ValueError(f"paged_attention: kv_quant={kv_quant!r} needs "
                         f"k_scale and v_scale and a mode in "
                         f"{KV_QUANT_MODES}")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   k_scale, v_scale, kv_quant)
    b, hq, q_len, d = q.shape
    num_pages, hkv, ps, d2 = k_pages.shape
    nb = block_tables.shape[1]
    if d2 != d or v_pages.shape != k_pages.shape or hq % hkv:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    kind = kv_quant or str(k_pages.dtype).split(".")[-1]
    want = torch.int8 if kv_quant else k_pages.dtype
    if kind not in _POOL_KINDS or k_pages.dtype != want \
            or v_pages.dtype != want:
        raise TypeError(f"paged_attention: pools must be float32, bfloat16, "
                        f"or int8 codes with kv_quant, got "
                        f"{k_pages.dtype}/{v_pages.dtype} (kv_quant="
                        f"{kv_quant!r})")
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    if kv_quant is not None:
        if (k_scale.shape != k_pages.shape[:3] or v_scale.shape !=
                k_scale.shape or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32):
            raise TypeError(f"paged_attention: scales must be float32 of "
                            f"shape {tuple(k_pages.shape[:3])}")
        tensors += [k_scale, v_scale]
    if d not in (16, 32, 64, 128):
        raise ValueError(f"paged_attention: head_dim {d} not in "
                         f"(16, 32, 64, 128)")
    if (block_tables.dtype != torch.int32 or lengths.dtype != torch.int32
            or block_tables.shape[0] != b or lengths.shape != (b,)):
        raise TypeError("paged_attention: block_tables (B, NB) and lengths "
                        "(B,) must be int32")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all operands on one device")
    lib = _lib()
    smem = lib.paged_attention_smem_bytes(d, ps, _POOL_KINDS[kind])
    if smem > 227 * 1024:
        raise ValueError(f"paged_attention: page_size {ps} needs {smem} B "
                         f"of shared memory per block (> 227 KB)")
    q = q.float().contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    block_tables, lengths = block_tables.contiguous(), lengths.contiguous()
    table = None
    if kv_quant is not None:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        table = kv_table(kv_quant, q.device)
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

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        _POOL_KINDS[kind], ptr(k_scale), ptr(v_scale), ptr(table),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ptr(part_acc), ptr(part_ml), b, hq, hkv, q_len, d, num_pages, ps, nb,
        splits, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.pool_launches[kind] += 1
    return out


paged_attention.launches = 0
paged_attention.pool_launches = dict.fromkeys(_POOL_KINDS, 0)

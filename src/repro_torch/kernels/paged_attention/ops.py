"""Paged attention wrapper: the CUDA kernel ``csrc/paged_attention.cu`` for
CUDA tensors, the plain version (``ref.py``) for CPU tensors.

Port of ``repro.kernels.paged_attention.ops.paged_attention``.  Unlike
``repro``'s wrapper it never upcasts an fp pool: the kernel reads pages in
the pool's dtype (float32 or bfloat16) and accumulates in f32.  Quantized
pools (``kv_quant`` "int8"/"log8": int8 codes with (P, Hkv, ps) float32
scales) stay int8 into the kernel, which decodes the codes it has staged
through the 256-entry table ``core.quantization.kv_table`` — so the
kernel and the plain version decode to the same values.  Block tables
pass through raw — entries outside ``[0, num_pages)`` are the unmapped
sentinel, which the kernel never dereferences (nor its scale row).

``plan`` (host only, so the CPU tests reach it) picks the kernel's
instance from G*Q — decode for up to 16 rows (8 at head dim 256), chunk
above — with its row tile, ring depth, splits of the position axis and
shared memory.

``paged_attention.launches`` counts every launch, and
``paged_attention.pool_launches`` counts them by pool kind ("float32",
"bfloat16", "int8", "log8").
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import build
from ...core.quantization import KV_QUANT_MODES, kv_table
from .ref import paged_attention_ref

_POOL_KINDS = {"float32": 0, "bfloat16": 1, "int8": 2, "log8": 2}
_ELEM_BYTES = {0: 4, 1: 2, 2: 1}
SMEM_LIMIT = 227 * 1024

# The tile constants of csrc/paged_attention.cu.
HEAD_DIMS = (16, 32, 64, 128, 256)
DEC_THREADS, DEC_SW = 128, 8     # decode: 4 warps, 8 positions a warp step
CH_STAGES = 2                    # chunk: 2 stages
TABLE_BYTES = 256 * 4            # int8 decode table


def ch_positions(d: int) -> int:
    """Chunk positions a stage: 64, or 32 at head dim 256 (a 64-position
    f32 stage of K and V is 128 KB there)."""
    return 32 if d > 128 else 64


def decode_max_rows(d: int) -> int:
    """G*Q above this takes the chunk instance: 16, or 8 at head dim 256
    (the decode instance's q and accumulators take 2R float4s a lane
    there).  At d = 256 the chunk instance has only 64-row tiles."""
    return 8 if d > 128 else 16

# Splits of the position axis.  Decode cuts the table's width into splits
# of _DEC_STEPS block steps (4 warps x 8 positions).  Chunk cuts each
# sequence's positions at absolute boundaries of CH_SPLIT_POSITIONS[rows]
# positions (``ch_split_stages`` stages of ``ch_positions(d)``), doubled
# until at most CH_MAX_SPLITS splits cover it (``CH_MAX_SPLITS`` of the
# CUDA source): nothing of the other sequences, the chunk's start or a
# row's place in it enters a row's sum order.
DEC_STEP = DEC_SW * DEC_THREADS // 32
_DEC_STEPS = 2
CH_SPLIT_POSITIONS = {64: 128, 128: 192}
CH_MAX_SPLITS = 16


def ch_split_stages(rows: int, d: int) -> int:
    """Stages a chunk split starts with (``ch_split_stages`` of the CUDA
    source)."""
    return CH_SPLIT_POSITIONS[rows] // ch_positions(d)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of kernel A: the instance ("decode" or "chunk"), its
    query rows per block, the depth of its cp.async ring, the row tiles
    and the grid's splits of the position axis per (sequence, KV head),
    and the shared memory a block needs."""
    instance: str
    rows: int
    stages: int
    tiles: int
    splits: int
    smem: int


def decode_stages(kind: int) -> int:
    """The decode instance's per-warp ring depth for pool kind ``kind``
    (0 f32, 1 bf16, 2 int8 codes): 2, 3 and 4 stages."""
    return {4: 2, 2: 3, 1: 4}[_ELEM_BYTES[kind]]


def smem_bytes(rows: int, d: int, kind: int) -> int:
    """Dynamic shared memory of one block (``DecodeLayout`` /
    ``ChunkLayout`` of the CUDA source, byte for byte)."""
    row_b = d * _ELEM_BYTES[kind]
    codes = kind == 2
    s = ch_positions(d)
    if rows <= 16:
        slot = 2 * DEC_SW * row_b + (2 * DEC_SW * 4 if codes else 0) \
            + DEC_SW * 4
        warp = decode_stages(kind) * slot + DEC_SW * rows * 4 + rows * 4
        ring = (TABLE_BYTES if codes else 0) + (DEC_THREADS // 32) * warp
        merge = (DEC_THREADS // 32) * rows * (d + 2) * 4
        return max(ring, merge)
    slot = 2 * s * row_b + (2 * s * 4 if codes else 0) + s * 4
    compute = 0 if kind == 0 else 2 * s * d * 4
    return (rows * d * 4 + CH_STAGES * slot + compute + s * (rows + 4) * 4
            + (TABLE_BYTES if codes else 0))


def num_splits(units: int, steps: int) -> int:
    """Splits of a block table of ``units`` steps into splits of at most
    ``steps``."""
    return max(1, -(-units // steps))


def plan(b: int, hkv: int, n_rows: int, nb: int, ps: int, d: int,
         kind: int) -> Plan:
    """Kernel A's launch for ``b`` sequences, ``hkv`` KV heads, ``n_rows``
    = G*Q query rows per (sequence, KV head), a block table of ``nb``
    pages of ``ps`` positions, head dim ``d`` and pool kind ``kind``.
    G*Q <= ``decode_max_rows(d)`` takes the decode instance (rows rounded
    up to 8), more the chunk instance (64 rows up to G*Q = 64, else 128;
    always 64 at d = 256).  The host sees only the table's width, not the
    lengths, so the grid's splits are sized from ``nb * ps``: for chunk,
    the busy splits of the longest sequence the table holds (its last
    query row reaches fewer than ``nb * ps + n_rows`` positions), of which
    the kernel takes per sequence what its own length needs."""
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    span = nb * ps
    if n_rows <= decode_max_rows(d):
        rows = 8 if n_rows <= 8 else 16
        return Plan("decode", rows, decode_stages(kind), 1,
                    num_splits(-(-span // DEC_STEP), _DEC_STEPS),
                    smem_bytes(rows, d, kind))
    rows = 64 if n_rows <= 64 or d > 128 else 128
    stages = -(-(span + n_rows - 1) // ch_positions(d))
    return Plan("chunk", rows, CH_STAGES, -(-n_rows // rows),
                min(CH_MAX_SPLITS,
                    num_splits(stages, ch_split_stages(rows, d))),
                smem_bytes(rows, d, kind))


def _lib():
    lib = build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [vp, vp, vp, i, vp, vp, vp,
                                               vp, vp, vp, vp, vp, vp, i, i,
                                               i, i, i, i, i, i, i, i, vp]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_smem_bytes.argtypes = [i, i, i]
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _launch(lib, q, k_pages, v_pages, block_tables, lengths, k_scale,
            v_scale, kv_quant, kind_id: int, stream) -> torch.Tensor:
    """Plan and launch kernel A through ``lib`` on checked operands."""
    b, hq, q_len, d = q.shape
    num_pages, hkv, ps, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = hq // hkv
    pl = plan(b, hkv, g * q_len, nb, ps, d, kind_id)
    if pl.smem > SMEM_LIMIT:
        raise ValueError(f"paged_attention: {pl} needs {pl.smem} B of "
                         f"shared memory per block (> 227 KB)")
    q = q.float().contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned")
    if num_pages * hkv * ps >= 2 ** 31:
        raise ValueError("paged_attention: the kernel indexes pool rows "
                         "with 32-bit ints (P * Hkv * ps < 2^31)")
    block_tables, lengths = block_tables.contiguous(), lengths.contiguous()
    table = None
    if kv_quant is not None:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        table = kv_table(kv_quant, q.device)
    out = torch.empty((b, hq, q_len, d), dtype=torch.float32, device=q.device)
    part_acc = part_ml = busy = None
    if pl.splits > 1:
        part_acc = torch.empty((b * hkv, pl.splits, g * q_len, d),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b * hkv, pl.splits, g * q_len, 2),
                              dtype=torch.float32, device=q.device)
        busy = torch.empty(b, dtype=torch.int32, device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), kind_id,
        ptr(k_scale), ptr(v_scale), ptr(table), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ptr(part_acc), ptr(part_ml),
        ptr(busy), b, hq, hkv, q_len, d, num_pages, ps, nb, pl.rows,
        pl.splits, stream)
    build.check(err, "paged_attention")
    return out


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
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if (block_tables.dtype != torch.int32 or lengths.dtype != torch.int32
            or block_tables.shape[0] != b or lengths.shape != (b,)):
        raise TypeError("paged_attention: block_tables (B, NB) and lengths "
                        "(B,) must be int32")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all operands on one device")
    out = _launch(_lib(), q, k_pages, v_pages, block_tables, lengths,
                  k_scale, v_scale, kv_quant, _POOL_KINDS[kind],
                  torch.cuda.current_stream(q.device).cuda_stream)
    paged_attention.launches += 1
    paged_attention.pool_launches[kind] += 1
    return out


paged_attention.launches = 0
paged_attention.pool_launches = dict.fromkeys(_POOL_KINDS, 0)


def _divides(mesh, axis, *dims) -> bool:
    """True when ``axis`` exists on ``mesh`` and divides every dim."""
    if axis is None:
        return False
    flat = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    if any(a not in mesh.shape for a in flat):
        return False
    size = 1
    for a in flat:
        size *= mesh.shape[a]
    return all(d % size == 0 for d in dims)


def shard_specs(b: int, hq: int, hkv: int, mesh, rules) -> dict:
    """The placements of kernel A's operands in its per-shard launch
    (``repro``'s ``paged_attention_sharded`` in_specs): query and kv heads
    over the rules' "kv_heads" axis when it divides both head counts (the
    GQA group stays shard-local), sequences over "slots" when it divides
    them, the pools' pages replicated, the block table and lengths
    replicated across "model"; an axis that does not divide replicates."""
    from ...parallel.sharding import Spec
    model_ax = rules.lookup("kv_heads")
    if not _divides(mesh, model_ax, hq, hkv):
        model_ax = None
    data_ax = rules.lookup("slots")
    if not _divides(mesh, data_ax, b):
        data_ax = None
    return {"q": Spec((data_ax, model_ax)), "pool": Spec((None, model_ax)),
            "table": Spec((data_ax,))}


def paged_attention_sharded(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            lengths: torch.Tensor, mesh, rules, *,
                            n_heads: int, n_kv_heads: int,
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None,
                            kv_quant: str | None = None) -> torch.Tensor:
    """Kernel A once on this rank's shard (``repro``'s ``shard_map``
    dispatch, one shard's view).  The operands are this rank's local
    shards, as the serve engines hold them, at the placement
    ``shard_specs`` gives the global head counts ``n_heads`` and
    ``n_kv_heads``: its query and kv heads, its sequences with their
    block-table rows and lengths, every page, a quantized pool's scales
    on the pool's head axis.  The gather indices carry no float math and
    ``plan`` depends on neither the batch nor the kv head count, so the
    output is exactly this shard's slice of the unsharded call.  Raises
    where the query or the pools hold another head slice."""
    from ...parallel.sharding import axis_size
    heads = shard_specs(q.shape[0], n_heads, n_kv_heads, mesh,
                        rules)["pool"].axes_of(1)
    split = axis_size(mesh, heads) if heads else 1
    if (q.shape[1] * split, k_pages.shape[1] * split) != (n_heads,
                                                          n_kv_heads):
        raise ValueError(
            f"paged_attention_sharded: {q.shape[1]} query and "
            f"{k_pages.shape[1]} kv heads on this shard, the placement "
            f"gives {n_heads // split} and {n_kv_heads // split}")
    return paged_attention(q, k_pages, v_pages, block_tables, lengths,
                           k_scale=k_scale, v_scale=v_scale,
                           kv_quant=kv_quant)

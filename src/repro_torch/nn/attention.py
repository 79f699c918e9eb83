"""GQA attention against dense and paged KV caches, with sliding windows
(port of the serving parts of ``repro.nn.attention``).

Cache layouts of one stack of layers (the model cache stacks K/V on a
leading layer axis and keeps ONE position track per stack, ``models/lm.py``):

* **lockstep** ``{"k", "v", "pos"}``: K/V (B, Hkv, L, D), ``pos`` (L,) —
  the ring a fixed batch prefills and decodes in step (``init_cache``);
* **slotted** ``{"k", "v", "pos"}``: the same K/V, ``pos`` (B, L) — every
  row an independent serve slot at its own offset (``slotted=True``);
* **paged** ``{"k", "v", "pos", "bt"}``: K/V page pools (P, Hkv, ps, D),
  ``pos`` (B, max_len) and a block table (B, NB) mapping a slot's logical
  block ``j`` onto a physical page (``num_pages`` = unmapped sentinel).

A windowed layer (``AttnSpec.window``, Gemma3's "local" layers) keeps a
dense ring of ``min(max_len, window + ring_slack)`` lines instead of
``max_len``: position ``p`` lives at line ``p % L`` and the window mask
keeps every query inside its window.  Engines that write C positions a
call pass ``ring_slack = C - 1`` (``init_cache``).  Paged caches hold no
windowed layer, as in ``repro``.

Quantized caches (``AttnSpec.kv_quant`` "int8" or "log8", DESIGN.md §11)
hold int8 codes in ``k``/``v`` and one float32 scale per (row, head,
position) in ``k_scale``/``v_scale`` — (B, Hkv, L) dense, (P, Hkv, ps)
paged.  New K/V are quantized when written (``_quantize_kv``) and decoded
with ``core.quantization.kv_decode`` where they are read; kernel A decodes
the code pages itself, so the paged OFF path never materializes an fp
pool.

``pos`` holds the position stored at each line (-1 = never written); it
is the only validity information attention reads.  Writes follow
``repro``'s ``update_cache``: line ``p % L`` in dense caches (a ring),
page ``bt[slot, p // ps]`` at offset ``p % ps`` in paged ones; masked,
out-of-range and sentinel-mapped writes are dropped.  ``repro`` scatters
with ``mode="drop"``; PyTorch raises on the CPU and asserts on the device
instead, so the port computes the kept writes once per forward and stack
(``write_plan``) and scatters only those.  Caches update in place (the
JAX package donates its buffers instead).

Attention paths of ``attn_apply``:

* ``mode="prefill"`` (whole prompt, positions (S,)): attention over the
  new K/V alone, then a ring-consistent fill of a dense cache.  Under
  ``OFF``: a windowed layer longer than its window takes
  ``banded_attention``; a softcapped layer, or a prompt behind an image
  prefix (``prefix_len``: the first ``prefix_len`` positions attend to
  each other both ways, PaliGemma's prefix-LM mask), the masked
  ``blockwise_attention`` (both ``repro``'s lax routes); every other
  layer kernel F (``kernels.flash_attention``, causal only).  Under
  ``ON``/``FUSED``: a plain causal layer ``NLDPEConfig.attention`` without
  a mask (kernel C under ``FUSED``), a windowed one or a prefix the
  materialized masked NL-DPE attention.
* ``"decode"`` and ``"chunk"``: the new K/V are written first, then the
  queries attend to the whole cache under validity masking (written,
  causal, in the window; a prefix needs no term there, since every cached
  position precedes the query).  ``OFF`` over a paged cache runs
  ``kernels.paged_attention`` (kernel A; a softcapped layer, which no
  config has, the gathered dense view, as ``repro``'s kernel opt-in
  does); over a dense cache, ``cached_attention`` (plain, as ``repro``
  computes it in lax).  NL-DPE modes run ``_nldpe_cached`` over the
  (gathered) dense view.
* ``"train"`` (whole sequence, no cache, differentiable): the prefill's
  routes with the band or ``blockwise_attention`` in place of kernel F
  (F has no backward); nothing trains under ``FUSED``
  (``models.lm.forward`` refuses it).

Under a sharding context (``parallel.context``) the weights, caches and
rows are this rank's shards: q, k, v hold its heads ("heads",
"kv_heads"; where the kv heads do not divide "model", every rank gathers
all query heads so each GQA group stays whole), kernel A launches on
those shards, the output heads gather before the output projection
("o_heads", the exact tables' contraction boundary), and a paged pool —
every page on every rank of a row split — takes every rank's writes
(``paged_write_plan`` and ``update_cache_paged`` gather them).
``cache_specs`` gives a stack's placements.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.engine import NLDPEConfig, OFF
from ..core.quantization import (KV_LOG_SPEC, KV_QUANT_MODES, kv_decode,
                                 scalar_div)
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_attention.ops import (paged_attention,
                                           paged_attention_sharded,
                                           shard_specs)
from ..parallel.context import (current, enter, gather_rows, reduce_partial,
                                shard)
from .basic import apply_rope, rmsnorm_apply

NEG_INF = float(torch.finfo(torch.float32).min)


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int | None = None          # sliding-window size (None = global)
    qk_norm: bool = False              # Gemma3-style per-head RMS on q/k
    softcap: float | None = None       # tanh cap of the attention scores
    kv_quant: str | None = None        # KV cache storage grid: "int8"/"log8"

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads


def _project_qkv(p: dict, s: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, S, d) -> q (B, Hq, S, Dh), k/v (B, Hkv, S, Dh): the per-head
    RMS norm of q and k where the layer has one (``q_norm``/``k_norm``),
    then rope."""
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    if "q_norm" in p:
        # a replicated scale over split heads: each rank's gradient is its
        # heads' part (``enter`` sums them in the backward pass)
        q = rmsnorm_apply({"scale": enter(p["q_norm"]["scale"], "heads",
                                          s.n_heads, q.shape[1])}, q)
        k = rmsnorm_apply({"scale": enter(p["k_norm"]["scale"], "kv_heads",
                                          s.n_kv_heads, k.shape[1])}, k)
    return (apply_rope(q, positions, s.rope_theta),
            apply_rope(k, positions, s.rope_theta), v)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def cache_length(s: AttnSpec, max_len: int, ring_slack: int = 0) -> int:
    """Lines of a dense cache: ``max_len``, or for a windowed layer a ring
    of ``min(max_len, window + ring_slack)``.  A chunk of C positions is
    written before its queries attend, so its first query still needs the
    ``window`` keys behind it: engines writing C positions a call pass
    ``ring_slack = C - 1``.  The window mask is the same either way, so
    attention gives what the tight ring gives."""
    return min(max_len, s.window + ring_slack) if s.window else max_len


def init_cache(s: AttnSpec, batch: int, max_len: int, *, layers: int,
               dtype=torch.float32, slotted: bool = False,
               ring_slack: int = 0, device=None) -> dict:
    """Dense K/V of ``layers`` layers, (layers, B, Hkv, L, D) with ``L =
    cache_length(s, max_len, ring_slack)``, and one position track: (L,)
    lockstep, or (B, L) with ``slotted=True`` so slots sit at different
    offsets.  With ``s.kv_quant`` set, K/V are int8 codes beside (layers,
    B, Hkv, L) float32 scales (``dtype`` is then unused)."""
    length = cache_length(s, max_len, ring_slack)
    kv = (layers, batch, s.n_kv_heads, length, s.head_dim)
    pos = (batch, length) if slotted else (length,)
    cache = kv_leaves(kv, dtype, s.kv_quant, device)
    cache["pos"] = torch.full(pos, -1, dtype=torch.int32, device=device)
    return cache


def kv_leaves(kv_shape: tuple, dtype, kv_quant: str | None,
              device) -> dict:
    """Zeroed K/V leaves of ``kv_shape``: ``dtype`` values, or int8 codes
    plus float32 scales over every axis but the last when ``kv_quant`` is
    set."""
    if kv_quant is None:
        return {"k": torch.zeros(kv_shape, dtype=dtype, device=device),
                "v": torch.zeros(kv_shape, dtype=dtype, device=device)}
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"unknown kv quant mode {kv_quant!r}")
    return {"k": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "v": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(kv_shape[:-1], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(kv_shape[:-1], dtype=torch.float32,
                                   device=device)}


def cache_specs(s: AttnSpec, batch: int, max_len: int, mesh, rules, *,
                slotted: bool = False, ring_slack: int = 0,
                paged: tuple[int, int] | None = None) -> dict:
    """The placement (``parallel.sharding.Spec``) of every leaf of one
    attention stack, mirroring ``init_cache`` / the paged stack of
    ``models.lm.init_model_cache`` (``repro``'s ``cache_specs`` and the
    dense branch of its ``lm.cache_pspecs``): K/V and scales lead with
    the stack's layer axis (never split).  Paged pools split their head
    axis over the rules' "kv_heads" and their pages over "pages"
    (replicated under the serve tables: any slot may gather any page);
    the position track and block table split their slots over "slots".
    Dense K/V prefer kv-head splitting and fall back to the sequence
    ("kv_seq") where the kv heads do not divide "model"."""
    from ..parallel.sharding import Spec, resolve

    def stacked(sp):
        return Spec((None, *sp))

    if paged is not None:
        num_pages, page_size = paged
        n_blocks = -(-max_len // page_size)
        kv_shape = (num_pages, s.n_kv_heads, page_size, s.head_dim)
        kv = stacked(resolve(rules, ("pages", "kv_heads", None, None),
                             kv_shape, mesh))
        tree = {"k": kv, "v": kv,
                "pos": resolve(rules, ("slots", None), (batch, max_len),
                               mesh),
                "bt": resolve(rules, ("slots", None), (batch, n_blocks),
                              mesh)}
        if s.kv_quant is not None:
            sc = stacked(resolve(rules, ("pages", "kv_heads", None),
                                 kv_shape[:3], mesh))
            tree.update(k_scale=sc, v_scale=sc)
        return tree
    length = cache_length(s, max_len, ring_slack)
    kv_shape = (batch, s.n_kv_heads, length, s.head_dim)
    model = mesh.shape.get("model", 1) if mesh is not None else 1
    kv_axes = (("batch", "kv_heads", None, None)
               if s.n_kv_heads % model == 0 else
               ("batch", None, "kv_seq", None))
    kv = stacked(resolve(rules, kv_axes, kv_shape, mesh))
    tree = {"k": kv, "v": kv,
            "pos": (resolve(rules, ("slots", None), (batch, length), mesh)
                    if slotted else Spec())}
    if s.kv_quant is not None:
        sc = stacked(resolve(rules, kv_axes[:3], kv_shape[:3], mesh))
        tree.update(k_scale=sc, v_scale=sc)
    return tree


def _quantize_kv(x: torch.Tensor, mode: str = "int8"):
    """(..., D) -> int8 codes (..., D) + float32 scales (...,), one per
    row of D.

    ``"int8"``: uniform grid — scale carries absmax / 127 (divided as
    ``jit`` divides by a constant, through ``scalar_div``), code =
    round(x / scale).  ``"log8"``: ``KV_LOG_SPEC``'s sign-magnitude log grid
    renormalized per row — scale carries the absmax, |code| indexes the
    7-bit log grid of |x| / absmax, the code's sign is the sign (0 = flushed
    zero).  ``core.quantization.kv_decode`` is the inverse.
    """
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    if mode == "log8":
        scale = torch.clamp(absmax, min=1e-8)
        code, sign = KV_LOG_SPEC.encode(xf / scale[..., None])
        q = (sign * code.to(torch.float32)).to(torch.int8)
    elif mode == "int8":
        scale = torch.clamp(scalar_div(absmax, 127.0), min=1e-8)
        q = torch.clamp(torch.round(xf / scale[..., None]),
                        -127, 127).to(torch.int8)
    else:
        raise ValueError(f"unknown kv quant mode {mode!r}")
    return q, scale


def _dequantize_kv(cache: dict, name: str,
                   kv_quant: str | None = None) -> torch.Tensor:
    """Leaf ``name`` ("k"/"v") of a cache or dense view as float32 values."""
    if f"{name}_scale" in cache:
        return kv_decode(cache[name], cache[f"{name}_scale"],
                         kv_quant or "int8")
    return cache[name].to(torch.float32)


def write_plan(cache: dict, positions: torch.Tensor, write_mask=None):
    """Where a forward's new K/V steps land, and the position-track update.

    ``positions`` is what the forward writes: () one shared step (lockstep
    decode), (S,) a whole prompt (prefill) or (B, C) per-slot steps
    (slotted or paged decode and chunk).  A dense cache keeps position
    ``p`` at line ``p % L``; a prefill keeps the last ``min(S, L)``
    positions, as ``repro``'s ring-consistent fill does.  ``write_mask``
    (B,) freezes masked slots of slotted and paged caches.  The position
    track is shared by every layer, so it is updated here, once, in place.
    Returns ``(slot, step, line)`` index tensors of the kept writes (for a
    paged cache, ``line`` is ``(page, offset)``).
    """
    if "bt" in cache:
        return paged_write_plan(cache, positions, write_mask)
    length = cache["k"].shape[-2]
    batch = cache["k"].shape[-4]
    dev = cache["pos"].device
    pos = positions.to(torch.int32)
    if pos.ndim <= 1:                       # lockstep decode or prefill
        seq = pos.numel()
        take = min(seq, length)
        steps = torch.arange(seq - take, seq, device=dev)
        kept = pos.reshape(-1)[steps]
        line = torch.remainder(kept, length).long()
        if cache["pos"].ndim == 1:
            cache["pos"][line] = kept
        else:
            cache["pos"][:, line] = kept
        bi = torch.arange(batch, device=dev).repeat_interleave(take)
        return bi, steps.repeat(batch), line.repeat(batch)
    if cache["pos"].ndim != 2:
        raise ValueError("per-slot positions need a slotted cache "
                         "(init_cache(..., slotted=True))")
    ok = torch.ones_like(pos, dtype=torch.bool)
    if write_mask is not None:
        ok = ok & write_mask[:, None]
    bi, ci = torch.nonzero(ok, as_tuple=True)
    kept = pos[bi, ci]
    line = torch.remainder(kept, length).long()
    cache["pos"][bi, line] = kept
    return bi, ci, line


def _stored(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
            kv_quant: str | None) -> dict:
    """New K/V (B, H, C, D) as the cache stores them: cast to the pool's
    dtype, or int8 codes plus (B, H, C) scales for a quantized cache."""
    if "k_scale" not in cache:
        return {"k": k_new.to(cache["k"].dtype),
                "v": v_new.to(cache["v"].dtype)}
    kq, ks = _quantize_kv(k_new, kv_quant or "int8")
    vq, vs = _quantize_kv(v_new, kv_quant or "int8")
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def update_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 plan, kv_quant: str | None = None) -> None:
    """Write one layer's new K/V (B, H, C, D) at the lines ``write_plan``
    chose, in place (dense or paged; quantized on the ``kv_quant`` grid
    when the cache holds codes)."""
    if "bt" in cache:
        update_cache_paged(cache, k_new, v_new, plan, kv_quant)
        return
    bi, ci, line = plan
    for name, new in _stored(cache, k_new, v_new, kv_quant).items():
        cache[name][bi, :, line] = new[bi, :, ci]


def paged_write_plan(cache: dict, pos: torch.Tensor, write_mask=None):
    """``write_plan`` of a paged cache: ``pos`` (B, C).  Position ``p``
    lands in page ``bt[slot, p // page_size]`` at offset
    ``p % page_size``; out-of-range and sentinel-mapped writes are dropped
    too.  The engine guarantees written pages are private to their slot,
    so no two kept writes hit the same line."""
    num_pages, _, page_size, _ = cache["k"].shape[-4:]
    length = cache["pos"].shape[1]
    pos = pos.to(torch.int32)
    n_blocks = cache["bt"].shape[1]
    block = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"),
                        0, n_blocks - 1).long()
    page = torch.gather(cache["bt"], 1, block)                  # (B, C)
    ok = (pos >= 0) & (pos < length) & (page >= 0) & (page < num_pages)
    if write_mask is not None:
        ok = ok & write_mask[:, None]
    bi, ci = torch.nonzero(ok, as_tuple=True)
    kept = pos[bi, ci]
    cache["pos"][bi, kept.long()] = kept
    if _rows_split():
        # the pools hold every page on every rank of the row split (any
        # slot may share any page): every rank writes every row's K/V
        pos, page, ok = (gather_rows(t) for t in (pos, page, ok))
        bi, ci = torch.nonzero(ok, as_tuple=True)
        kept = pos[bi, ci]
    return (bi, ci, page[bi, ci].long(),
            torch.remainder(kept, page_size).long())


def _rows_split() -> bool:
    """Whether the forward's rows are split over ranks (the sharding
    context's batch axes)."""
    ctx = current()
    return ctx is not None and bool(ctx.batch_axes())


def update_cache_paged(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                       plan, kv_quant: str | None = None) -> None:
    """Write one layer's new K/V (B, H, C, D) into its pools (and scale
    pools), in place, at the lines ``paged_write_plan`` chose."""
    bi, ci, pg, off = plan
    stored = _stored(cache, k_new, v_new, kv_quant)
    if _rows_split():
        stored = {n: gather_rows(t) for n, t in stored.items()}
    for name, new in stored.items():
        cache[name][pg, :, off] = new[bi, :, ci]


_POOL_LEAVES = ("k", "v", "k_scale", "v_scale")


def gather_page_rows(cache: dict, page: int) -> list:
    """One physical page of a model paged cache across every pool leaf:
    ``leaf[:, page]`` — the (L, Hkv, page_size, D) K/V rows of all layers,
    and for an int8/log8 pool the codes plus the (L, Hkv, page_size) scale
    rows — in ``("k", "v", "k_scale", "v_scale")`` order, as views.
    ``scatter_page_rows`` takes the same list back.  The layers are
    stacked, so a page is 2 rows (4 with scales), not one per layer as in
    ``repro``'s per-layer pytree."""
    return [cache[n][:, page] for n in _POOL_LEAVES if n in cache]


def scatter_page_rows(cache: dict, rows, page: int) -> None:
    """Inverse of ``gather_page_rows``: write ``rows`` (host or device) as
    physical page ``page`` of every pool leaf, in place."""
    names = [n for n in _POOL_LEAVES if n in cache]
    rows = list(rows)
    if len(rows) != len(names):
        raise ValueError("scatter_page_rows: rows do not match this cache")
    for n, row in zip(names, rows):
        dst = cache[n][:, page]
        if row.shape != dst.shape or row.dtype != dst.dtype:
            raise ValueError(f"scatter_page_rows: {n} row is {row.dtype} "
                             f"{tuple(row.shape)}, the pool's "
                             f"{dst.dtype} {tuple(dst.shape)}")
        dst.copy_(row)


def paged_dense_view(cache: dict) -> dict:
    """Gather a paged cache into the dense slotted layout (B, H, L, D):
    position ``p`` lands at row ``p`` (sentinel entries gather a clamped
    page, which the position track masks)."""
    b, length = cache["pos"].shape
    num_pages = cache["k"].shape[0]
    bt = cache["bt"].long().clamp(0, num_pages - 1)

    def gather(name):
        x = cache[name][bt]                     # (B, NB, H, ps[, D])
        x = x.transpose(1, 2)                   # (B, H, NB, ps[, D])
        flat = x.reshape(x.shape[0], x.shape[1], -1, *x.shape[4:])
        return flat[:, :, :length]

    view = {"pos": cache["pos"]}
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in cache:
            view[name] = gather(name)
    return view


def cache_valid_mask(kp: torch.Tensor, q_pos: torch.Tensor,
                     window: int | None = None) -> torch.Tensor:
    """Which cache lines each query may attend to: kp (L,) lockstep or
    (B, L) per-slot line positions; q_pos () scalar, (Q,) shared or (B, Q)
    per-slot query positions -> bool (B|1, Q, L): written, causal and,
    with a ``window``, less than ``window`` positions behind the query."""
    if kp.ndim == 1:
        kp = kp[None]
    q_pos = q_pos.to(torch.int32)
    if q_pos.ndim == 0:
        q_pos = q_pos.reshape(1, 1)
    elif q_pos.ndim == 1:
        q_pos = q_pos[None, :]
    kpe = kp[:, None, :]
    qpe = q_pos[:, :, None]
    valid = (kpe >= 0) & (kpe <= qpe)
    if window:
        valid = valid & (qpe - kpe < window)
    return valid


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int | None,
          prefix_len: int | None = None) -> torch.Tensor:
    """q_pos (..., Q), k_pos (..., K) -> bool (..., Q, K): causal and
    in-window pairs, and every pair whose key lies in the first
    ``prefix_len`` positions (the prefix-LM's bidirectional prefix)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = (qp >= kp) if causal else torch.ones(
        torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
        device=qp.device)
    if window is not None:
        m = m & (qp - kp < window)
    if prefix_len is not None:
        m = m | (kp < prefix_len)
    return m


def _capped(scores: torch.Tensor, softcap: float | None) -> torch.Tensor:
    """``tanh(scores / softcap) * softcap`` (the division as ``jit``
    divides by a constant), or the scores as they are."""
    if not softcap:
        return scores
    return torch.tanh(scalar_div(scores, softcap)) * softcap


def cached_attention(q: torch.Tensor, cache: dict, q_pos: torch.Tensor,
                     s: AttnSpec) -> torch.Tensor:
    """q (B, Hq, Q, D) against a dense cache under validity masking (the
    layer's window too) and its softcap, float numerics (``repro``
    computes it in lax, outside any kernel).  Masked scores take the
    finite f32 minimum, as in ``repro``."""
    b, hq, nq, d = q.shape
    g = s.group
    qg = q.reshape(b, s.n_kv_heads, g, nq, d).to(torch.float32)
    k = _dequantize_kv(cache, "k", s.kv_quant)
    v = _dequantize_kv(cache, "v", s.kv_quant)
    scores = _capped(scalar_div(torch.einsum("bkgqd,bkld->bkgql", qg, k),
                                math.sqrt(d)), s.softcap)
    valid = cache_valid_mask(cache["pos"], q_pos, s.window)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", p, v)
    return out.reshape(b, hq, nq, d).to(q.dtype)


def _nldpe_cached(nldpe: NLDPEConfig, q: torch.Tensor, att: dict,
                  valid: torch.Tensor, s: AttnSpec) -> torch.Tensor:
    """NL-DPE attention over a dense cache view, GQA folded into query
    rows (query head ``kv_head * g + g_idx`` is row ``g_idx * Q + j`` of its
    KV head's block), so K/V are never repeated."""
    b, hq, nq, d = q.shape
    g = s.group
    k = _dequantize_kv(att, "k", s.kv_quant).to(q.dtype)
    v = _dequantize_kv(att, "v", s.kv_quant).to(q.dtype)
    qf = q.reshape(b, s.n_kv_heads, g * nq, d)
    msk = valid.repeat(1, g, 1)            # row g_idx*Q + j uses valid[:, j]
    o = nldpe.attention(qf, k, v, causal=False, mask=msk[:, None])
    return o.reshape(b, hq, nq, d)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        prefix_len: int | None = None,
                        softcap: float | None = None, q_block: int = 512,
                        k_block: int = 1024) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype:
    ``repro``'s online-softmax attention over query blocks of ``q_block``
    and key blocks of ``k_block`` rows, causal and in-``window`` pairs
    (and every key of the first ``prefix_len`` positions, ``_mask``),
    scores under the optional ``softcap``, in float32 with the reference's
    masking constant and order of operations, in plain differentiable ops.
    The last block of each axis is ragged; ``repro`` halves its blocks
    until they divide S instead (down to 1 row at an odd S), so the blocks
    are the same wherever they divide it.  The reference recomputes each
    query block in the backward pass; ``models.lm`` recomputes whole layers
    instead (``cfg.scan_remat``)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    qb, kb = min(q_block, sq), min(k_block, sk)
    qg = scalar_div(q.reshape(b, hkv, g, sq, d).to(torch.float32),
                    math.sqrt(d))
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    dev = q.device
    outs = []
    for q0 in range(0, sq, qb):
        q_i = qg[:, :, :, q0:q0 + qb]                       # (B,Hkv,G,qb,D)
        n = q_i.shape[3]
        q_pos = torch.arange(q0, q0 + n, device=dev)
        m_run = torch.full((b, hkv, g, n), NEG_INF, device=dev)
        l_run = torch.zeros((b, hkv, g, n), device=dev)
        acc = torch.zeros((b, hkv, g, n, d), device=dev)
        for k0 in range(0, sk, kb):
            s_ = _capped(torch.einsum("bkgqd,bkld->bkgql", q_i,
                                      kf[:, :, k0:k0 + kb]), softcap)
            k_pos = torch.arange(k0, k0 + s_.shape[-1], device=dev)
            if causal or window is not None:
                s_ = torch.where(_mask(q_pos, k_pos, causal=causal,
                                       window=window, prefix_len=prefix_len),
                                 s_, NEG_INF)
            m_new = torch.maximum(m_run, torch.amax(s_, dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            pj = torch.exp(s_ - m_safe[..., None])
            corr = torch.where(torch.isfinite(m_run),
                               torch.exp(m_run - m_safe), 0.0)
            l_run = l_run * corr + torch.sum(pj, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgql,bkld->bkgqd", pj, vf[:, :, k0:k0 + kb])
            m_run = m_new
        l_run = torch.where(l_run == 0.0, 1.0, l_run)
        outs.append(acc / l_run[..., None])
    out = torch.cat(outs, dim=3)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, q_block: int = 512,
                     softcap: float | None = None) -> torch.Tensor:
    """Sliding-window causal attention in O(S * window): q (B, Hq, S, D),
    k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype.

    What ``repro``'s ``banded_attention`` computes — each query's masked
    softmax over the keys at most ``window - 1`` positions behind it, in
    float32, scores under the optional ``softcap`` — blocked the port's
    way: query blocks of ``q_block`` rows (the last one ragged; ``repro``
    halves its block until it divides S, down to 1 row for an odd S),
    each against its band of keys ``[start - window + 1, end)``.  The
    masked columns of a band add exact zeros, so a row's softmax is the
    same whatever band it shares."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = scalar_div(q.reshape(b, hkv, g, sq, d).to(torch.float32),
                    math.sqrt(d))
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    dev = q.device
    outs = []
    for s0 in range(0, sq, q_block):
        s1 = min(s0 + q_block, sq)
        k0 = max(0, s0 - window + 1)
        sc = _capped(torch.einsum("bkgqd,bkld->bkgql", qg[:, :, :, s0:s1],
                                  kf[:, :, k0:s1]), softcap)
        msk = _mask(torch.arange(s0, s1, device=dev),
                    torch.arange(k0, s1, device=dev), causal=True,
                    window=window)
        p = torch.softmax(torch.where(msk, sc, NEG_INF), dim=-1)
        outs.append(torch.einsum("bkgql,bkld->bkgqd", p, vf[:, :, k0:s1]))
    out = torch.cat(outs, dim=3)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       s: AttnSpec, positions: torch.Tensor, mode: str,
                       nldpe: NLDPEConfig,
                       prefix_len: int | None = None) -> torch.Tensor:
    """Whole-sequence attention over the new K/V alone ("prefill" and
    "train"), routed as ``repro`` routes it (the module docstring)."""
    seq = q.shape[2]
    if nldpe.enabled:
        if s.window is None and prefix_len is None:
            # plain causal with no mask: FUSED streams it through the
            # log-domain flash kernel (GQA-aware, K/V stay grouped)
            return nldpe.attention(q, k, v, causal=True, mask=None)
        msk = _mask(positions, positions, causal=True, window=s.window,
                    prefix_len=prefix_len)
        return nldpe.attention(q, k, v, causal=False, mask=msk)
    if s.window is not None and seq > s.window:
        return banded_attention(q, k, v, window=s.window, softcap=s.softcap)
    # kernel F for every other prefill: exact for a windowed layer with
    # seq <= window too, since qp - kp < window holds for every causal
    # pair there.  F is causal only, with no softcap and no backward;
    # those layers take the masked blockwise attention, as repro does for
    # every prefill
    if mode == "prefill" and s.softcap is None and prefix_len is None:
        return flash_attention(q, k, v, causal=True)
    return blockwise_attention(q, k, v, causal=True, window=s.window,
                               prefix_len=prefix_len, softcap=s.softcap)


def attn_apply(p: dict, s: AttnSpec, x: torch.Tensor, *,
               positions: torch.Tensor, mode: str, cache: dict | None = None,
               plan=None, nldpe: NLDPEConfig = OFF,
               dense_rows: torch.Tensor | None = None,
               prefix_len: int | None = None) -> torch.Tensor:
    """x (B, S, d) -> y (B, S, d); the layer's cache is updated in place.

    ``mode="prefill"``: the whole prompt at positions (S,), over the new
    K/V, then (with a dense ``cache``) the fill at ``plan``.  ``"train"``:
    the same attention without a cache, differentiable; ``prefix_len``:
    the first positions form a bidirectional prefix (``_mask``).
    ``"decode"`` (S == 1) and ``"chunk"``: the new K/V are written at
    ``plan`` (the forward's ``write_plan`` of this layer's stack;
    positions () shared or (B, S) per slot), then the queries attend to
    the cache.

    Kernel A's staircase (query j of slot b attends to ``[0, positions[b,
    0] + j]``) is the cache's validity mask on every slot the forward
    writes.  A slot it does not write keeps a stale or empty position
    track, whose mask (``repro``'s masked dense route) may be no prefix at
    all: an empty one spreads the softmax over every gathered line.  The
    caller that needs such slots' outputs as ``repro``'s names them in
    ``dense_rows`` (int64 slot indices): their rows alone are recomputed
    on that route and replace kernel A's.
    """
    ctx, heads = current(), (s.n_heads, s.n_kv_heads)
    x = enter(x, "heads", s.n_heads, p["wq"].shape[1])
    q, k, v = _project_qkv(p, s, x, positions)
    if ctx is not None:
        # this rank's heads on every route, at kernel A's placement: where
        # it replicates the heads (the kv heads do not divide "model")
        # but the query heads arrive split, every rank attends with all of
        # them (the GQA group stays whole)
        if (q.shape[1] < s.n_heads and not shard_specs(
                x.shape[0], *heads, ctx.mesh, ctx.rules)["q"].axes_of(1)):
            if mode == "train":
                raise NotImplementedError(
                    f"training with {s.n_kv_heads} kv heads split over "
                    f"fewer ranks than the {s.n_heads} query heads: the "
                    f"query heads would gather, and the replicated K/V "
                    f"take partial gradients (ROADMAP.md A.2 queue, item "
                    f"5: training with replicated kv heads)")
            q = shard(q, "batch", None, None, None,
                      src=("batch", "heads", None, None),
                      full=(None, s.n_heads, None, None))
        s = dataclasses.replace(s, n_heads=q.shape[1],
                                n_kv_heads=k.shape[1])
    if mode in ("train", "prefill"):
        if positions.ndim != 1:
            raise ValueError(f"{mode} takes shared positions (S,)")
        o = _prefill_attention(q, k, v, s, positions, mode, nldpe,
                               prefix_len)
        if mode == "prefill" and cache is not None:
            if "bt" in cache:
                raise ValueError("paged caches are filled in 'chunk' or "
                                 "'decode' mode, not by whole-prompt prefill")
            update_cache(cache, k, v, plan, s.kv_quant)
    elif mode in ("decode", "chunk"):
        update_cache(cache, k, v, plan, s.kv_quant)
        qpos = positions if positions.ndim == 2 else positions.reshape(-1)
        if "bt" in cache and not nldpe.enabled and s.softcap is None:
            # the queries sit at consecutive per-slot offsets, so query j
            # of slot b attends to [0, positions[b, 0] + j]: the kernel's
            # ragged staircase with base lengths positions[:, 0] + 1.
            # Under a mesh q, the pools and the table are this rank's
            # shards: kernel A launches once per shard
            lengths = torch.clamp(positions[:, 0] + 1, 1,
                                  cache["pos"].shape[1]).to(torch.int32)
            kw = dict(k_scale=cache.get("k_scale"),
                      v_scale=cache.get("v_scale"), kv_quant=s.kv_quant)
            args = (q, cache["k"], cache["v"], cache["bt"], lengths)
            o = (paged_attention(*args, **kw) if ctx is None else
                 paged_attention_sharded(*args, ctx.mesh, ctx.rules,
                                         n_heads=heads[0],
                                         n_kv_heads=heads[1], **kw)
                 ).to(q.dtype)
            if dense_rows is not None:
                sub = {**cache, "pos": cache["pos"][dense_rows],
                       "bt": cache["bt"][dense_rows]}
                o = o.index_copy(0, dense_rows, cached_attention(
                    q[dense_rows], paged_dense_view(sub), qpos[dense_rows],
                    s))
        else:
            att = paged_dense_view(cache) if "bt" in cache else cache
            if nldpe.enabled:
                o = _nldpe_cached(nldpe, q, att, cache_valid_mask(
                    att["pos"], qpos, s.window), s)
            else:
                o = cached_attention(q, att, qpos, s)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    # contraction boundary: under the exact tables "o_heads" replicates,
    # so the head shards all-gather (concatenation, bit-exact) before the
    # output projection; under train and serve each rank projects its own
    # heads and the partial sums are all-reduced
    o = shard(o, "batch", "o_heads", None, None,
              src=("batch", "heads", None, None),
              full=(None, heads[0], None, None))
    y = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(o.dtype))
    return reduce_partial(y, "o_heads", heads[0], p["wo"].shape[0])

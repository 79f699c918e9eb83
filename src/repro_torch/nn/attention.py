"""GQA attention against a paged KV cache (port of the paged-serving parts
of ``repro.nn.attention``).

The cache of one layer is ``{"k", "v", "pos", "bt"}``: K/V page pools
(P, Hkv, page_size, D), the per-slot position track (B, max_len; -1 =
never written) and the block table (B, NB) mapping a slot's logical block
``j`` onto a physical page (``num_pages`` = unmapped sentinel).

Where ``repro`` scatters with ``mode="drop"`` and relies on clamped
gathers, PyTorch raises on the CPU and asserts on the device, so this port
masks writes and clamps gathers explicitly.  Caches update in place (the
JAX package donates its buffers instead).

Attention paths:

* ``OFF``: ``kernels.paged_attention`` — the hand-written CUDA kernel on
  the card, its plain version (gathered dense view + masked softmax) on
  the CPU.  There is no switch back to the dense view on the card.
* NL-DPE (``ON``/``FUSED``): the gathered dense view through
  ``_nldpe_cached`` (log-domain DMMuls + ACAM softmax), as in ``repro``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.engine import NLDPEConfig, OFF
from ..kernels.paged_attention.ops import paged_attention
from .basic import apply_rope

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads


def _project_qkv(p: dict, s: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, S, d) -> q (B, Hq, S, Dh), k/v (B, Hkv, S, Dh), rope applied."""
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    return (apply_rope(q, positions, s.rope_theta),
            apply_rope(k, positions, s.rope_theta), v)


def paged_write_plan(cache: dict, pos: torch.Tensor, write_mask=None):
    """Where a call's new K/V steps land, and the position-track update.

    ``pos`` is (B, C) — C steps per slot (C = 1 in decode).  Position
    ``p`` lands in page ``bt[slot, p // page_size]`` at offset
    ``p % page_size``.  Masked, out-of-range and sentinel-mapped writes are
    dropped (``repro`` routes them out of bounds with ``mode="drop"``);
    the engine guarantees written pages are private to their slot, so no
    two kept writes hit the same line.  The position track and block table
    are shared by every layer, so the plan is computed once per forward
    and the track is updated here, in place.  Returns
    ``(slot, step, page, offset)`` index tensors of the kept writes.
    """
    num_pages, _, page_size, _ = cache["k"].shape
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
    return (bi, ci, page[bi, ci].long(),
            torch.remainder(kept, page_size).long())


def update_cache_paged(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                       plan) -> None:
    """Write one layer's new K/V (B, H, C, D) into its pools, in place,
    at the lines ``paged_write_plan`` chose."""
    bi, ci, pg, off = plan
    cache["k"][pg, :, off] = k_new[bi, :, ci].to(cache["k"].dtype)
    cache["v"][pg, :, off] = v_new[bi, :, ci].to(cache["v"].dtype)


def paged_dense_view(cache: dict) -> dict:
    """Gather a paged cache into the dense slotted layout (B, H, L, D):
    position ``p`` lands at row ``p`` (sentinel entries gather a clamped
    page, which the position track masks)."""
    b, length = cache["pos"].shape
    num_pages = cache["k"].shape[0]
    bt = cache["bt"].long().clamp(0, num_pages - 1)

    def gather(name):
        x = cache[name][bt]                     # (B, NB, H, ps, D)
        x = x.transpose(1, 2)                   # (B, H, NB, ps, D)
        return x.reshape(x.shape[0], x.shape[1], -1, x.shape[4])[:, :, :length]

    return {"pos": cache["pos"], "k": gather("k"), "v": gather("v")}


def cache_valid_mask(kp: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
    """kp (B, L) cache positions, q_pos (B, Q) query positions ->
    bool (B, Q, L): written and causal."""
    kpe = kp[:, None, :]
    qpe = q_pos[:, :, None]
    return (kpe >= 0) & (kpe <= qpe)


def _nldpe_cached(nldpe: NLDPEConfig, q: torch.Tensor, att: dict,
                  valid: torch.Tensor, s: AttnSpec) -> torch.Tensor:
    """NL-DPE attention over a dense cache view, GQA folded into query
    rows (query head ``kv_head * g + g_idx`` is row ``g_idx * Q + j`` of its
    KV head's block), so K/V are never repeated."""
    b, hq, nq, d = q.shape
    g = s.group
    k = att["k"].to(torch.float32).to(q.dtype)
    v = att["v"].to(torch.float32).to(q.dtype)
    qf = q.reshape(b, s.n_kv_heads, g * nq, d)
    msk = valid.repeat(1, g, 1)            # row g_idx*Q + j uses valid[:, j]
    o = nldpe.attention(qf, k, v, mask=msk[:, None])
    return o.reshape(b, hq, nq, d)


def attn_apply(p: dict, s: AttnSpec, x: torch.Tensor, *,
               positions: torch.Tensor, cache: dict, plan,
               nldpe: NLDPEConfig = OFF) -> torch.Tensor:
    """x (B, S, d) -> y (B, S, d); the layer's pools are updated in place.

    ``repro``'s "decode" (S == 1) and "chunk" (S == prefill chunk) modes
    are one path here: the S new K/V steps are written at the per-slot
    offsets ``positions`` (B, S), then the queries attend to the cache.
    ``plan`` is the forward's ``paged_write_plan`` (the write mask of
    frozen slots is folded into it).
    """
    b, seq, _ = x.shape
    if positions.shape != (b, seq):
        raise ValueError(f"positions must be (B, S) per-slot offsets, got "
                         f"{tuple(positions.shape)}")
    q, k, v = _project_qkv(p, s, x, positions)
    update_cache_paged(cache, k, v, plan)
    if nldpe.enabled:
        att = paged_dense_view(cache)
        valid = cache_valid_mask(att["pos"], positions)        # (B, S, L)
        o = _nldpe_cached(nldpe, q, att, valid, s)
    else:
        # the chunk's queries sit at consecutive per-slot offsets, so query
        # j of slot b attends to [0, positions[b, 0] + j]: the kernel's
        # ragged staircase with base lengths positions[:, 0] + 1
        lengths = torch.clamp(positions[:, 0] + 1, 1,
                              cache["pos"].shape[1]).to(torch.int32)
        o = paged_attention(q, cache["k"], cache["v"], cache["bt"],
                            lengths).to(q.dtype)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(o.dtype))

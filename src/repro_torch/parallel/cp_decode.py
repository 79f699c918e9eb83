"""Context-parallel decode attention: flash-decoding over a sequence-sharded
KV cache (port of ``repro.parallel.cp_decode``; the "long" rules' cache).

Each rank holds a contiguous slice of the cache's positions.  Per rank:
local scores -> local max ``m_i``, sum ``l_i`` and weighted values
``v_i``; combine with one max reduction and two sums over the sequence
axes:

    m = max_i m_i;  l = sum_i l_i * exp(m_i - m);
    out = sum_i v_i * exp(m_i - m) / l

— (B, H, D)-sized partials, whatever the sequence length.
"""
from __future__ import annotations

import math

import torch

from ..core.quantization import scalar_div

NEG_INF = float(torch.finfo(torch.float32).min)


def cp_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, kv_pos: torch.Tensor, pos,
                        mesh, seq_axes=("model",),
                        window: int | None = None) -> torch.Tensor:
    """q (B, Hq, 1, D), the same on every rank; k/v_cache (B, Hkv, L_i, D)
    and kv_pos (L_i,): this rank's slice of the positions, split over
    ``seq_axes`` of ``mesh`` (``parallel.context.Mesh``); pos: the query
    position.  Returns (B, Hq, 1, D), the same on every rank."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    s = scalar_div(torch.einsum("bkgd,bkld->bkgl", qg,
                                k_cache.to(torch.float32)), math.sqrt(d))
    pos = torch.as_tensor(pos, dtype=kv_pos.dtype, device=kv_pos.device)
    valid = (kv_pos >= 0) & (kv_pos <= pos)
    if window is not None:
        valid = valid & (pos - kv_pos < window)
    s = torch.where(valid, s, NEG_INF)

    m = mesh.all_reduce(torch.amax(s, dim=-1), seq_axes, op="max")
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
    l_i = torch.sum(p, dim=-1)                             # (b, hkv, g)
    v_i = torch.einsum("bkgl,bkld->bkgd", p, v_cache.to(torch.float32))
    l_sum = mesh.all_reduce(l_i, seq_axes)
    v_sum = mesh.all_reduce(v_i, seq_axes)
    out = v_sum / torch.clamp(l_sum, min=1e-20)[..., None]
    return out.reshape(b, hq, 1, d).to(q.dtype)

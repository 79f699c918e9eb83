"""Embedding, RMSNorm, rotary embedding (port of ``repro.nn.basic``).

Parameters are float32 masters; compute runs in the caller's activation
dtype, casting weights at use exactly as ``repro`` does
(``x @ w.astype(x.dtype)``).  The serve engine stores a copy of each
matmul weight already cast to the activation dtype, which gives the same
values without a cast per call (``models.lm.serving_params``).

Under a sharding context whose rules split "vocab" (``train``,
``serve``), the table holds this rank's rows (a vocab-parallel
embedding): a lookup reads the rank's own rows, zero elsewhere, and sums
over the vocab axes — exact, since one rank holds each row; the readout
gives this rank's vocab columns of the logits.
"""
from __future__ import annotations

import torch

from ..parallel.context import act_axes, current, enter, reduce_partial


def embedding_apply(p: dict, tokens: torch.Tensor,
                    dtype=torch.bfloat16, vocab: int | None = None
                    ) -> torch.Tensor:
    """``table[tokens]`` in ``dtype``; ``vocab``: the table's global row
    count (a table holding fewer is a vocab shard)."""
    table = p["table"]
    n = table.shape[0]
    if current() is None or vocab is None or n == vocab:
        return table[tokens.long()].to(dtype)
    lo = current().mesh.position(act_axes("vocab", vocab)) * n
    t = tokens.long() - lo
    mine = (t >= 0) & (t < n)
    x = table[torch.clamp(t, 0, n - 1)] * mine[..., None].to(table.dtype)
    return reduce_partial(x, "vocab", vocab, n).to(dtype)


def unembed_apply(p: dict, x: torch.Tensor,
                  vocab: int | None = None) -> torch.Tensor:
    """Tied readout: logits = x @ E^T in float32 (this rank's vocab
    columns of a vocab shard)."""
    table = p["table"]
    if vocab is not None:
        x = enter(x, "vocab", vocab, table.shape[0])
    return x.to(torch.float32) @ table.to(torch.float32).T


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * p["scale"].to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     -ar / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (B, H, S, D) with D even; positions (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, device=x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

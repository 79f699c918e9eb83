"""Plain PyTorch causal GQA attention with an online softmax over KV
blocks: a port of ``repro.nn.attention.blockwise_attention`` (the lax twin
of ``repro``'s flash kernel, and what its OFF prefill runs).

The blocking follows ``blockwise_attention`` (Q blocks of 512 and KV
blocks of 1024, halved until they divide the lengths) and so does the
arithmetic: queries scaled by 1/sqrt(d) first (``x / c`` rounded as
``jit`` rounds it), grouped GQA scores, running max / sum / accumulator.
Queries sit at the end of the KV axis (query ``i`` at position
``i + lk - lq``), as in the flash kernel; masked scores are ``-inf``, so
a row with no key left of it gives 0.
"""
from __future__ import annotations

import math

import torch

from ...core.quantization import scalar_div


Q_BLOCK, K_BLOCK = 512, 1024        # blockwise_attention's defaults


def _block(n: int, cap: int) -> int:
    b = min(cap, n)
    while n % b:
        b //= 2
    return b


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, Hkv, Lk, D) -> (B, H, Lq, D) float32."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    g = hq // hkv
    qb, kb = _block(lq, Q_BLOCK), _block(lk, K_BLOCK)
    qg = scalar_div(q.reshape(b, hkv, g, lq, d).to(torch.float32),
                    math.sqrt(d))
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty((b, hkv, g, lq, d), dtype=torch.float32,
                      device=q.device)
    for i0 in range(0, lq, qb):
        q_i = qg[:, :, :, i0:i0 + qb]
        q_pos = torch.arange(i0, i0 + qb, device=q.device) + (lk - lq)
        m_run = torch.full((b, hkv, g, qb), -torch.inf, device=q.device)
        l_run = torch.zeros((b, hkv, g, qb), device=q.device)
        acc = torch.zeros((b, hkv, g, qb, d), device=q.device)
        for j0 in range(0, lk, kb):
            s = torch.einsum("bkgqd,bkld->bkgql", q_i, kf[:, :, j0:j0 + kb])
            if causal:
                k_pos = torch.arange(j0, j0 + kb, device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                                -torch.inf)
            m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.where(torch.isfinite(m_run),
                               torch.exp(m_run - m_safe), 0.0)
            l_run = l_run * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgql,bkld->bkgqd", p, vf[:, :, j0:j0 + kb])
            m_run = m_new
        l_run = torch.where(l_run == 0.0, 1.0, l_run)
        out[:, :, :, i0:i0 + qb] = acc / l_run[..., None]
    return out.reshape(b, hq, lq, d)

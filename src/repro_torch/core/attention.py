"""NL-DPE attention, Fig 6c (port of ``repro.core.attention``).

Q/K/V leave their crossbars through log ACAMs (sign-magnitude 8-bit log
codes); DMMul_1 forms the scores, the softmax stops at step 4 in the log
domain, and DMMul_2 contracts exp(log-softmax) against log-quantized V.
1/sqrt(d_k) is fused into Q before encoding.  ``reference_attention`` is
the float oracle with the same masking semantics.
"""
from __future__ import annotations

import torch

from .logdomain import (DEFAULT_CFG, LogDomainConfig, inv_sqrt, log_quantize,
                        nldpe_log_softmax, nldpe_matmul_loga)


def causal_mask(lq: int, lk: int, device=None) -> torch.Tensor:
    """(Lq, Lk) bool: query ``i`` sits at position ``i + lk - lq`` (the end
    of the KV axis) and attends to keys at or before it."""
    return torch.tril(torch.ones((lq, lk), dtype=torch.bool, device=device),
                      diagonal=lk - lq)


def nldpe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: LogDomainConfig = DEFAULT_CFG,
                    causal: bool = True,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D)^2 -> (B, H, Lq, D); K/V carry as many
    heads as Q (callers fold or repeat GQA groups first)."""
    # repro scales by an f32 array, which promotes bf16 queries to f32
    q = q.to(torch.promote_types(q.dtype, torch.float32))
    q_l = log_quantize(q * inv_sqrt(q.shape[-1]), cfg)
    k_l = log_quantize(k, cfg)
    scores = torch.matmul(q_l, k_l.transpose(-1, -2))
    full_mask = None
    if causal:
        full_mask = causal_mask(q.shape[-2], k.shape[-2], q.device)[None, None]
    if mask is not None:
        full_mask = mask if full_mask is None else (full_mask & mask)
    logp = nldpe_log_softmax(scores, cfg, mask=full_mask)
    return nldpe_matmul_loga(logp, v, cfg, mask=full_mask)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Float oracle with the same masking semantics: (B, H, Lq, D) x
    (B, H, Lk, D)^2 -> (B, H, Lq, D).  Scores are divided by an f32
    sqrt(d), which promotes bf16 inputs to f32 as in ``repro``."""
    d = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2))
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
    scores = scores / torch.sqrt(torch.tensor(float(d), device=q.device))
    if causal:
        scores = torch.where(causal_mask(q.shape[-2], k.shape[-2], q.device),
                             scores, -torch.inf)
    if mask is not None:
        scores = torch.where(mask, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p, v.to(p.dtype))

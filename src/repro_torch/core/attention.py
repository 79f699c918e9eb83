"""NL-DPE attention, Fig 6c (port of ``repro.core.attention``).

Q/K/V leave their crossbars through log ACAMs (sign-magnitude 8-bit log
codes); DMMul_1 forms the scores, the softmax stops at step 4 in the log
domain, and DMMul_2 contracts exp(log-softmax) against log-quantized V.
1/sqrt(d_k) is fused into Q before encoding.
"""
from __future__ import annotations

import torch

from .logdomain import (DEFAULT_CFG, LogDomainConfig, inv_sqrt, log_quantize,
                        nldpe_log_softmax, nldpe_matmul_loga)


def nldpe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: LogDomainConfig = DEFAULT_CFG,
                    causal: bool = True,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D)^2 -> (B, H, Lq, D); K/V carry as many
    heads as Q (callers fold or repeat GQA groups first)."""
    q_l = log_quantize(q * inv_sqrt(q.shape[-1]), cfg)
    k_l = log_quantize(k, cfg)
    scores = torch.matmul(q_l, k_l.transpose(-1, -2))
    full_mask = None
    if causal:
        lq, lk = q.shape[-2], k.shape[-2]
        full_mask = torch.tril(torch.ones((lq, lk), dtype=torch.bool,
                                          device=q.device),
                               diagonal=lk - lq)[None, None]
    if mask is not None:
        full_mask = mask if full_mask is None else (full_mask & mask)
    logp = nldpe_log_softmax(scores, cfg, mask=full_mask)
    return nldpe_matmul_loga(logp, v, cfg, mask=full_mask)

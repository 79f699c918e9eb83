"""Plain PyTorch paged attention: gather the pages to a dense view, then
one masked softmax (port of ``repro.kernels.paged_attention.ref``).

Query row ``j`` of sequence ``b`` attends to logical positions
``[0, lengths[b] + j)``; positions mapped through block-table entries
outside ``[0, num_pages)`` (the unmapped sentinel) are dropped, and the
gather clamps those entries so it never indexes out of range.  A row
with no valid position gives 0 (as the kernel does), not the uniform
average the reference's finite mask value would give.

Quantized pools (``kv_quant`` "int8"/"log8") hold int8 codes with
(P, Hkv, ps) float32 scales; code and scale pages are gathered, then
decoded with ``core.quantization.kv_decode``, the formula the kernel's
decode table is built from.
"""
from __future__ import annotations

import torch

from ...core.logdomain import inv_sqrt
from ...core.quantization import kv_decode

NEG_INF = float(torch.finfo(torch.float32).min)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None,
                        kv_quant: str | None = None) -> torch.Tensor:
    """q (B, Hq, Q, D); pools (P, Hkv, ps, D), fp values or int8 codes with
    (P, Hkv, ps) scales when ``kv_quant`` is set; block_tables (B, NB) int;
    lengths (B,) int -> (B, Hq, Q, D) f32."""
    b, hq, q_len, d = q.shape
    num_pages, hkv, ps, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = hq // hkv
    bt = block_tables.long()
    btc = bt.clamp(0, num_pages - 1)            # safe gather index only

    def gather(pages, scales):
        x = pages[btc]                          # (B, NB, Hkv, ps, D)
        x = x.transpose(1, 2).reshape(b, hkv, nb * ps, d)
        if kv_quant is None:
            return x.float()
        sc = scales[btc].transpose(1, 2).reshape(b, hkv, nb * ps)
        return kv_decode(x, sc, kv_quant)

    k, v = gather(k_pages, k_scale), gather(v_pages, v_scale)
    qg = q.reshape(b, hkv, g, q_len, d).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k) * inv_sqrt(d)
    ar = torch.arange(nb * ps, device=q.device)
    allowed = lengths.long()[:, None] + torch.arange(q_len, device=q.device)
    valid = ar[None, None] < allowed[..., None]                 # (B, Q, L)
    blk_ok = (bt >= 0) & (bt < num_pages)                       # (B, NB)
    valid = valid & blk_ok.repeat_interleave(ps, dim=1)[:, None]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1) * valid.any(-1)[:, None, None, :, None]
    o = torch.einsum("bkgql,bkld->bkgqd", p, v)
    return o.reshape(b, hq, q_len, d)

"""Expert-parallel MoE through two all-to-alls (port of
``repro.nn.moe_ep``).

``nn/moe.py`` splits the expert weights on their FFN columns
("expert-TP"), so training under FSDP gathers every expert's weights each
layer.  Here the experts stay *resident*: the expert axis is split over
``model_axis`` and only token buffers move:

  1. each rank routes its tokens, buckets the assignments by the owner
     rank of the chosen expert (capacity-padded) and ``all_to_all`` sends
     the buckets over ``model_axis``;
  2. the owner runs its local experts' FFN on what it received (a
     bucket's padding slots name the sentinel expert ``e_local``, which
     no expert matches);
  3. the reverse ``all_to_all`` returns the results, which are
     gate-combined.

Static shapes throughout (capacity-padded buckets; an overflow drops, as
``moe.py``'s capacity path does).  Every routing integer follows
``repro``'s lines (``nn.moe.top_k``: ``jax.lax.top_k``'s tie order;
stable argsorts).  As in ``repro``, the rows are split over
``data_axes`` and the same on every rank of ``model_axis``, which each
route them all; the expert FFN is a gated SiLU whatever ``act``, as
``repro``'s body computes it.
"""
from __future__ import annotations

import math

import torch

from .moe import MoESpec, top_k


def moe_apply_ep(p: dict, x: torch.Tensor, s: MoESpec, mesh, *,
                 data_axes: tuple = ("data",), model_axis: str = "model",
                 act: str = "silu") -> torch.Tensor:
    """x: (B, S, d), this rank's rows (split over ``data_axes``); ``p``:
    the router whole, ``gate``/``up``/``down`` this rank's experts (the
    (E, ...) stacks split over ``model_axis``).  Returns this rank's rows
    of the MoE output."""
    ep = mesh.shape[model_axis]
    if s.n_experts % ep:
        raise ValueError(f"{s.n_experts} experts do not split over "
                         f"{ep} ranks of {model_axis!r}")
    e_local = s.n_experts // ep
    b, seq, d = x.shape
    t = b * seq
    dev = x.device
    xt = x.reshape(t, d)
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, s.top_k)                     # (t, k)
    if s.router_norm_topk:
        gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True),
                                    min=1e-9)

    a = t * s.top_k
    fe = eidx.reshape(a)                                    # global expert
    owner = torch.div(fe, e_local, rounding_mode="floor")   # its rank
    tok = torch.div(torch.arange(a, device=dev), s.top_k,
                    rounding_mode="floor")

    # bucket the assignments by owner, with a per-destination capacity
    cap = (max(8, math.ceil(a / ep * max(s.capacity_factor, 1.0)))
           if s.capacity_factor > 0 else a)
    order = torch.argsort(owner, stable=True)
    owner_s = owner[order]
    counts = torch.bincount(owner_s, minlength=ep)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(a, device=dev) - starts[owner_s]    # in the bucket
    keep_s = rank < cap
    ar_c = torch.arange(cap, device=dev)
    pos = starts[:, None] + ar_c[None, :]                   # (ep, cap)
    valid = ar_c[None, :] < torch.clamp(counts, max=cap)[:, None]
    src_assign = order[torch.clamp(pos, 0, a - 1).reshape(-1)]
    send_x = xt[tok[src_assign]].reshape(ep, cap, d) \
        * valid[..., None].to(xt.dtype)
    send_e = torch.remainder(fe[src_assign].reshape(ep, cap), e_local)
    send_e = torch.where(valid, send_e, e_local)            # sentinel

    # all-to-all 1: the tokens travel to their experts' owners
    rx = mesh.all_to_all(send_x, model_axis).reshape(ep * cap, d)
    re = mesh.all_to_all(send_e, model_axis).reshape(ep * cap)

    y = torch.zeros((ep * cap, d), dtype=torch.float32, device=dev)
    for le in range(e_local):
        m = (re == le)[:, None].to(torch.float32)
        h = torch.nn.functional.silu(rx @ p["gate"][le]) * (rx @ p["up"][le])
        y = y + (h @ p["down"][le]) * m

    # all-to-all 2: the results return to their tokens' ranks
    back = mesh.all_to_all(y.reshape(ep, cap, d),
                           model_axis).reshape(ep * cap, d)

    # combine: each kept assignment reads its bucket slot
    inv = torch.argsort(order, stable=True)
    slot = owner * cap + torch.clamp(rank[inv], 0, cap - 1)
    kept = keep_s[inv]
    vals = back[slot] * kept[:, None].to(back.dtype)
    vals = vals.reshape(t, s.top_k, d) * gates[..., None]
    return torch.sum(vals, dim=1).reshape(b, seq, d).to(x.dtype)

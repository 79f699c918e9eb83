"""Mixture-of-Experts FFN (port of ``repro.nn.moe``): group-local routing,
gather-based dispatch and combine, capacity-limited experts.

Tokens are reshaped into ``groups`` (GShard-style group-limited routing:
each group routes its own tokens); dispatch and combine are gathers.
Buffer slot (e, c) of a group holds "the c-th assignment routed to expert
e" in the stable sort of the flat assignments by expert; an assignment
whose rank within its expert reaches the capacity C is dropped (its
output term is zero).  ``capacity_factor <= 0`` makes C every assignment
of the group: dropless.

Routing integers are ``repro``'s bit for bit, ties included:
``jax.lax.top_k`` returns the lower index first among equal
probabilities (equal probabilities are common under the ``ON`` log-grid
softmax), which the first ``top_k`` of a stable descending sort
reproduces (``torch.topk`` promises no order); the assignment sort is a
stable argsort, the per-group counts a bincount, and every clipped gather
follows ``repro``'s lines.  Router logits are float32; the dispatch
buffers, the expert products and the gate values are in the activation
dtype, as in ``repro``.

With a capacity below "all assignments", a token's output depends on the
other tokens of its forward (they compete for the same expert slots):
padding rows of a serve chunk count, and so does whether a prefix hit
skipped a chunk.  That is ``repro``'s own semantics; ``moe_apply`` can
count the dropped assignments into a device counter (``drops``), those of
live tokens apart from those of padding rows (``live``).

The expert FFN is three batched matmuls over the (expert, slot) buffer:
the plain PyTorch the reference runs as ``jnp.einsum`` outside any Pallas
kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.engine import NLDPEConfig, OFF
from ..core.noise import clip
from ..parallel.context import (current, enter, gather_rows, reduce_partial,
                                shard)
from ..parallel.sharding import Spec


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert_ff: int
    capacity_factor: float = 1.25
    min_capacity: int = 8
    router_norm_topk: bool = True     # qwen3: renormalize top-k gates


def _capacity(tokens_per_group: int, s: MoESpec) -> int:
    """Expert slots per group: all assignments when dropless, else
    ``ceil(tokens * top_k / E * capacity_factor)`` clipped to [min_capacity,
    tokens * top_k] (the lower clip wins, as in ``repro``)."""
    if s.capacity_factor <= 0:
        return tokens_per_group * s.top_k
    c = math.ceil(tokens_per_group * s.top_k / s.n_experts * s.capacity_factor)
    return max(min(c, tokens_per_group * s.top_k), s.min_capacity)


def group_tokens(tokens: int, groups: int) -> int:
    """Tokens per routing group: ``groups`` groups where they divide
    ``tokens``, else one."""
    return tokens // (groups if tokens % groups == 0 else 1)


def may_drop(tokens: int, s: MoESpec) -> bool:
    """Whether a one-group forward of ``tokens`` tokens can drop an
    assignment: an expert takes at most one assignment per token (the
    top-k experts are distinct), so not when the capacity holds them all."""
    return _capacity(tokens, s) < tokens


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs: torch.Tensor, s: MoESpec, cap: int) -> dict:
    """The routing of ``moe_apply`` from router probabilities (g, tg, E):
    ``gate_vals`` and ``expert_idx`` (g, tg, k); over the flat assignments
    (g, a = tg * k): the stable sort ``order``, ``rank`` within the
    expert, ``kept`` (rank < cap) and ``slot_of_assign`` (the buffer slot
    each reads back); over the buffer (g, E * cap): ``tok_for_slot`` (the
    token each slot gathers) and ``slot_valid`` (g, E, cap)."""
    g, tg, n_e = probs.shape
    a = tg * s.top_k
    dev = probs.device
    gate_vals, expert_idx = top_k(probs, s.top_k)
    if s.router_norm_topk:
        gate_vals = gate_vals / clip(
            torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)

    fe = expert_idx.reshape(g, a)
    order = torch.argsort(fe, dim=-1, stable=True)
    fe_sorted = torch.gather(fe, 1, order)
    counts = torch.zeros((g, n_e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, fe_sorted, torch.ones_like(fe_sorted))
    starts = torch.cumsum(counts, dim=-1) - counts
    ar_a = torch.arange(a, device=dev)
    rank_sorted = ar_a[None, :] - torch.gather(starts, 1, fe_sorted)

    ar_c = torch.arange(cap, device=dev)
    pos = starts[:, :, None] + ar_c[None, None, :]
    slot_valid = ar_c[None, None, :] < torch.clamp(counts, max=cap)[:, :, None]
    pos_c = torch.clamp(pos, 0, a - 1).reshape(g, n_e * cap)
    tok_sorted = order // s.top_k
    tok_for_slot = torch.gather(tok_sorted, 1, pos_c)

    # the inverse permutation of order (repro's argsort of it)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, ar_a[None, :].expand(g, a))
    rank = torch.gather(rank_sorted, 1, inv)
    kept = rank < cap
    slot_of_assign = fe * cap + torch.clamp(rank, 0, cap - 1)
    return {"gate_vals": gate_vals, "expert_idx": expert_idx,
            "order": order, "rank": rank, "kept": kept,
            "slot_of_assign": slot_of_assign, "tok_for_slot": tok_for_slot,
            "slot_valid": slot_valid}


def router_logits(p: dict, xt: torch.Tensor) -> torch.Tensor:
    """Router logits in float32: (g, tg, d) -> (g, tg, E)."""
    return xt.to(torch.float32) @ p["router"].to(torch.float32)


def expert_ffn(p: dict, xb: torch.Tensor, act: str = "silu",
               nldpe: NLDPEConfig = OFF, ff: int | None = None
               ) -> torch.Tensor:
    """The experts' gated FFN over their buffer slots: xb (E, slots, d) ->
    (E, slots, d), one batched matmul per projection (``repro``'s
    ``jnp.einsum``s), in xb's dtype.  Under a sharding context the gate
    and up hold this rank's columns of the ``ff`` (global; default the
    down projection's rows) expert-FFN columns ("mlp"); at the
    contraction boundary ("mlp_in") the exact tables gather them before
    the down projection, ``train`` and ``serve`` all-reduce the partial
    products of this rank's rows of ``down``."""
    ff = ff or p["down"].shape[1]
    xb = enter(xb, "mlp", ff, p["gate"].shape[-1])
    hg = torch.bmm(xb, p["gate"].to(xb.dtype))
    hu = torch.bmm(xb, p["up"].to(xb.dtype))
    h = nldpe.elementwise_mul(nldpe.activation(hg, act), hu).to(xb.dtype)
    h = shard(h, "experts", None, "mlp_in", src=("experts", None, "mlp"),
              full=(None, None, ff))
    y = torch.bmm(h, p["down"].to(xb.dtype))
    return reduce_partial(y, "mlp_in", ff, p["down"].shape[1])


def moe_apply(p: dict, x: torch.Tensor, s: MoESpec, act: str = "silu",
              groups: int = 1, nldpe: NLDPEConfig = OFF,
              drops: torch.Tensor | None = None,
              live: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  ``groups`` splits the B * S tokens into
    routing groups (one group when it does not divide them).  ``drops``
    ((2,) int64 on x's device) gains the assignments dropped for capacity:
    those of the tokens ``live`` marks ((B, S) bool; default every token)
    at 0, the others' (padding rows, whose outputs are discarded) at 1.

    Under a sharding context whose rows are split (``"expert_group"``
    follows the batch), each rank routes its own groups when the group
    count splits with the rows; otherwise the groups span ranks, and every
    rank gathers the rows, routes them all and keeps its own.  ``drops``
    counts this rank's rows only (the engines sum the ranks)."""
    b, seq, d = x.shape
    ctx = current()
    shards = 1 if ctx is None else ctx.batch_shards()
    t = b * seq * shards
    g = groups if t % groups == 0 else 1
    if shards > 1 and g % shards:
        out, lost = _moe(p, gather_rows(x), s, act, g, nldpe)
        rows = Spec((ctx.batch_axes(),))
        out, lost = rows.local(out, ctx.mesh), rows.local(lost, ctx.mesh)
    else:
        out, lost = _moe(p, x, s, act, g // shards, nldpe)
    if drops is not None:
        n_live = torch.sum(lost if live is None else lost * live)
        drops.add_(torch.stack([n_live, torch.sum(lost) - n_live]))
    return out


def _moe(p: dict, x: torch.Tensor, s: MoESpec, act: str, g: int,
         nldpe: NLDPEConfig):
    """``moe_apply`` over ``g`` groups of x's rows: (out (B, S, d), the
    dropped assignments of each token (B, S))."""
    b, seq, d = x.shape
    tg = b * seq // g
    cap = _capacity(tg, s)
    n_e = s.n_experts
    xt = x.reshape(g, tg, d)

    # routing: the router softmax runs on the ACAM softmax when enabled
    probs = nldpe.softmax(router_logits(p, xt), axis=-1)
    r = route(probs, s, cap)
    lost = torch.sum(~r["kept"].reshape(b, seq, s.top_k), dim=-1)

    # dispatch: buffer slot (e, c) <- sorted position starts[e] + c
    rows = torch.arange(g, device=x.device)[:, None]
    buf = xt[rows, r["tok_for_slot"]].reshape(g, n_e, cap, d) \
        * r["slot_valid"][..., None].to(x.dtype)

    y = expert_ffn(p, buf.transpose(0, 1).reshape(n_e, g * cap, d), act,
                   nldpe, s.d_expert_ff)
    y = y.reshape(n_e, g, cap, d).transpose(0, 1).reshape(g, n_e * cap, d)

    # combine: each assignment gathers its slot; dropped ones give zero
    vals = y[rows, r["slot_of_assign"]]
    vals = vals * r["kept"][..., None].to(x.dtype)
    vals = vals.reshape(g, tg, s.top_k, d) \
        * r["gate_vals"][..., None].to(x.dtype)
    return torch.sum(vals, dim=2).reshape(b, seq, d), lost


def load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e (fraction of tokens whose
    first choice is e) * (mean router probability of e)."""
    probs = torch.softmax(logits, dim=-1)
    lead = tuple(range(expert_idx.dim() - 1))
    first = torch.nn.functional.one_hot(expert_idx[..., 0].long(),
                                        n_experts).to(torch.float32)
    frac = torch.mean(first, dim=lead)
    imp = torch.mean(probs, dim=tuple(range(probs.dim() - 1)))
    return n_experts * torch.sum(frac * imp)

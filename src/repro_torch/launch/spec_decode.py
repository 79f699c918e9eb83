"""Analog-draft speculative decoding for the paged serve engine (port of
``repro.launch.spec_decode``; DESIGN.md §8).

NL-DPE's trade is a cheap, noisy analog path against an exact digital
one, and speculative decoding is that trade inside one decode tick:

* **Draft** — ``spec_k`` sequential decode steps through the NL-DPE
  low-precision path: the drafter's weights are the model's own float32
  parameters put through the 8-bit log grid (``quantize_draft_params``,
  the conductances the crossbars would hold), optionally with the analog
  numerics on activations too.  Draft K/V land provisionally in the
  slot's own pages at ``[pos, pos + k)``; the engine budgets ``spec_k``
  positions of page slack per request for them.
* **Verify** — one exact ``mode="chunk"`` forward over ``[tok, d_1..d_k]``
  at positions ``pos + [0..k]``: the chunk first overwrites those
  positions with exact K/V, then query ``j`` attends to ``[0, pos + j]``
  (on the paged ``OFF`` path kernel A's ragged staircase at q_len k + 1).
* **Accept / rollback** — rejection sampling (``speculative_accept``):
  greedy requests accept a draft iff it equals the verify argmax; sampled
  ones accept ``d ~ q`` with probability ``min(1, p[d]/q[d])`` and draw a
  rejection's replacement from ``residual_probs(p, q)``.  Every draw folds
  the verified token position (``sampling.spec_fold``).  After acceptance
  the position track past the new tip is clipped to never-valid
  (``clip_positions``), and the engine publishes only committed positions
  to the radix index (``kvpool.publish_committed``).

Where ``repro`` jits the draft as a ``lax.scan`` and the verify as one
function, the draft here is a Python loop of ``lm.decode_step`` calls and
the verify a plain function; both update the cache in place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.engine import NLDPEConfig, OFF
from ..core.logdomain import LogDomainConfig, log_quantize
from ..models import lm
from .sampling import (ACCEPT_STREAM, CORRECT_STREAM, DRAFT_STREAM,
                       residual_probs, sample_from_probs, spec_fold,
                       target_probs)
from . import prng


def clip_positions(cache: dict, mask: torch.Tensor,
                   bound) -> dict:
    """On masked slots, make every position-track entry ``>= bound``
    never-valid (-1), in place, in every attention stack of the cache
    (full-length and windowed rings); ``bound`` () or (S,).  The admission
    reset of the serve engines and the speculative rollback: entries past
    the new tip are unverified draft state."""
    for pos in lm.position_tracks(cache):
        bound = torch.as_tensor(bound, dtype=torch.int32, device=pos.device)
        b = bound[:, None] if bound.ndim else bound
        pos.masked_fill_(mask[:, None] & (pos >= b), -1)
    return cache


def emits_tick_major(emits: torch.Tensor) -> np.ndarray:
    """A verify step's per-slot emissions (S, k + 1) as the tick-major
    (T, S) host array the engine's harvest reads."""
    return emits.cpu().numpy().T


def quantize_draft_params(params: dict,
                          logdomain: LogDomainConfig | None = None) -> dict:
    """Every parameter of a float32 tree put through the 8-bit
    sign-magnitude log grid (``log_quantize``): the values the crossbar
    cells hold once programmed.  Quantize the float32 master, before any
    cast to the activation dtype, as ``repro`` quantizes its parameters."""
    if logdomain is None:
        logdomain = LogDomainConfig()

    def q(x):
        if isinstance(x, dict):
            return {k: q(v) for k, v in x.items()}
        return log_quantize(x.to(torch.float32), logdomain)

    return q(params)


def speculative_accept(drafts, q_probs, vlogits, temperature, top_k, keys,
                       pos):
    """Accept/reject and correction over one spec step.

    drafts (S, k) int32; q_probs (S, k, V) the draft distributions;
    vlogits (S, k + 1, V) the verify logits (index j scored with context
    through position pos + j); temperature/top_k (S,); keys (S, 2); pos
    (S,).  Returns (accepted (S,) in [0, k], correction (S,) int32): the
    token at index ``accepted`` — the residual draw at a rejection, or the
    bonus draw from the last verify distribution when every draft was
    accepted.  Greedy slots have one-hot p and q: acceptance is
    ``draft == argmax`` and the correction the verify argmax."""
    s, k, v = q_probs.shape
    p_all = target_probs(vlogits.reshape(s * (k + 1), v),
                         temperature.repeat_interleave(k + 1),
                         top_k.repeat_interleave(k + 1)).reshape(s, k + 1, v)
    # accept d with probability min(1, p[d] / q[d]); u * q < p, no divide
    idx = drafts.long()[..., None]
    p_d = torch.gather(p_all[:, :k], -1, idx)[..., 0]
    q_d = torch.gather(q_probs, -1, idx)[..., 0]
    ar = torch.arange(k + 1, dtype=torch.int32, device=pos.device)
    u = prng.uniform(spec_fold(keys, pos[:, None] + 1 + ar[:k],
                               ACCEPT_STREAM), ())
    accept = u * q_d < p_d
    accepted = torch.sum(torch.cumprod(accept.to(torch.int32), dim=1), dim=1)

    # a correction candidate at every index, gathered at the reject point:
    # the residual for j < k, the target itself (bonus) at j == k
    res = residual_probs(p_all[:, :k].reshape(s * k, v),
                         q_probs.reshape(s * k, v)).reshape(s, k, v)
    cand = torch.cat([res, p_all[:, k:]], dim=1)
    ckeys = spec_fold(keys, pos[:, None] + 1 + ar, CORRECT_STREAM)
    corr = sample_from_probs(ckeys.reshape(s * (k + 1), 2),
                             cand.reshape(s * (k + 1), v)).reshape(s, k + 1)
    correction = torch.gather(corr, 1, accepted.long()[:, None])[:, 0]
    return accepted.to(torch.int32), correction


def build_draft_scan_fn(cfg, *, spec_k: int, nldpe: NLDPEConfig,
                        batch_groups: int = 1):
    """The draft phase: ``spec_k`` sequential low-precision decode steps
    against the paged cache (``batch_groups``: each MoE layer's routing
    groups).

    draft(draft_params, cache, tok, pos, active, temp, topk, keys) ->
    (drafts (S, k) int32, q_probs (S, k, V)); the cache updates in
    place."""

    def draft(draft_params, cache, tok, pos, active, temp, topk, keys):
        drafts, q_probs = [], []
        for _ in range(spec_k):
            logits = lm.decode_step(draft_params, cfg, tok, pos, cache,
                                    nldpe=nldpe, write_mask=active,
                                    batch_groups=batch_groups)
            q = target_probs(logits, temp, topk)
            tok = sample_from_probs(spec_fold(keys, pos + 1, DRAFT_STREAM), q)
            pos = pos + 1
            drafts.append(tok)
            q_probs.append(q)
        return torch.stack(drafts, dim=1), torch.stack(q_probs, dim=1)

    return draft


def build_verify_fn(cfg, params, *, spec_k: int, nldpe: NLDPEConfig = OFF,
                    eos_id: int = -1, batch_groups: int = 1):
    """The digital half of one spec step: the exact verify chunk, the
    rejection sampling, then the state update (eos and generation-budget
    truncation, position advance, rollback clip).

    verify(cache, tok, pos, active, gen_left, temp, topk, keys, drafts,
    q_probs) -> (tok, pos, active, gen_left, emits, accepted), ``emits``
    (S, k + 1) int32 padded with -1 past each slot's emitted count and
    ``accepted`` (S,) the acceptance count before truncation (0 for a slot
    that emitted nothing); the cache updates in place."""
    k = spec_k

    def verify(cache, tok, pos, active, gen_left, temp, topk, keys, drafts,
               q_probs):
        s = tok.shape[0]
        x = torch.cat([tok[:, None], drafts], dim=1)
        ar = torch.arange(k + 1, dtype=torch.int32, device=tok.device)
        vlogits = lm.forward(params, x, cfg, mode="chunk", cache=cache,
                             positions=pos[:, None] + ar, nldpe=nldpe,
                             write_mask=active, batch_groups=batch_groups)
        accepted, correction = speculative_accept(
            drafts, q_probs, vlogits, temp, topk, keys, pos)

        # drafts below the reject point, the correction at it, then the
        # truncation by generation budget and eos
        idx = ar[None]
        d_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        emit = torch.where(idx < accepted[:, None], d_pad, -1)
        emit = torch.where(idx == accepted[:, None], correction[:, None],
                           emit)
        emit = torch.where(idx < gen_left[:, None], emit, -1)
        if eos_id >= 0:
            is_eos = (emit == eos_id).to(torch.int32)
            emit = torch.where(torch.cumsum(is_eos, dim=1) - is_eos > 0, -1,
                               emit)
        emit = torch.where(active[:, None], emit, -1).to(torch.int32)
        n_emit = torch.sum(emit >= 0, dim=1, dtype=torch.int32)

        # rollback: everything at or past the new tip is unverified
        clip_positions(cache, active, pos + n_emit)

        last = torch.gather(emit, 1,
                            torch.clamp(n_emit - 1, min=0).long()[:, None])
        tok = torch.where(active & (n_emit > 0), last[:, 0], tok)
        pos = pos + n_emit
        gen_left = gen_left - n_emit
        done = gen_left <= 0
        if eos_id >= 0:
            done = done | torch.any(emit == eos_id, dim=1)
        active = active & ~done
        accepted = torch.where(n_emit > 0, accepted, 0)
        return tok, pos, active, gen_left, emit, accepted

    return verify

"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; port
of ``repro.nn.rglru``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The sigmoid gates go through ``NLDPEConfig.activation`` (ACAM sigmoids
under NL-DPE numerics) and the data-dependent products through
``NLDPEConfig.elementwise_mul`` (log-domain DMMul), as in ``repro``.

``rglru_scan`` evaluates the linear recurrence over a whole sequence with
the log-depth odd/even prefix scan of ``jax.lax.associative_scan``
(``_associative_scan``: the same pairing of elements, so the same float32
operations in the same order); ``rglru_step`` is the single decode step.
The two agree within float32 rounding (``tests/test_torch_recurrent.py``
states the tolerances).

Block layout (Griffin recurrent block): a gate branch with GeLU, and a
recurrent branch through a width-4 causal depthwise conv and the RG-LRU,
merged multiplicatively and projected out.  Its state is ``{"h": (B,
d_rnn) float32, "conv": (B, W - 1, d_rnn)}``.
"""
from __future__ import annotations

import torch

from ..core.engine import NLDPEConfig, OFF
from ..core.noise import clip

_C = 8.0  # Griffin's fixed decay temperature


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)).  The max is ``core.noise.clip``'s, so that the
    derivative at x == 0 is ``jax``'s 0.5 (``torch.clamp`` sends all of
    the gradient through there, which makes it 1); the values are
    ``torch.clamp``'s (``torch.logaddexp`` rounds differently)."""
    return clip(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _gates(p: dict, x: torch.Tensor, nldpe: NLDPEConfig):
    r = nldpe.activation(x @ p["w_a"].to(x.dtype) + p["b_a"].to(x.dtype),
                         "sigmoid")
    i = nldpe.activation(x @ p["w_x"].to(x.dtype) + p["b_x"].to(x.dtype),
                         "sigmoid")
    log_a = -_C * softplus(p["lam"].to(torch.float32)) * r.to(torch.float32)
    a = torch.exp(log_a)
    beta = torch.sqrt(clip(1.0 - torch.exp(2.0 * log_a), 1e-9))
    return a, beta, i


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], ... (``even`` as long as
    ``odd`` or one longer)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, u: torch.Tensor):
    """Inclusive scan over axis 1 of the pairs (a_t, u_t) under
    ``combine((al, ul), (ar, ur)) = (al * ar, ur + ar * ul)``, by
    ``jax.lax.associative_scan``'s recursion: scan the combined adjacent
    pairs, then fill in the even elements."""
    n = a.shape[1]
    if n < 2:
        return a, u

    def combine(left, right):
        al, ul = left
        ar, ur = right
        return al * ar, ur + ar * ul

    ra, ru = combine((a[:, 0:n - 1:2], u[:, 0:n - 1:2]),
                     (a[:, 1::2], u[:, 1::2]))
    oa, ou = _associative_scan(ra, ru)
    if n % 2 == 0:
        ea, eu = combine((oa[:, :-1], ou[:, :-1]), (a[:, 2::2], u[:, 2::2]))
    else:
        ea, eu = combine((oa, ou), (a[:, 2::2], u[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eu = torch.cat([u[:, :1], eu], dim=1)
    return _interleave(ea, oa), _interleave(eu, ou)


def rglru_scan(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None,
               nldpe: NLDPEConfig = OFF):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, h_last (B, d) float32).
    A carried state ``h0`` enters as a virtual step 0, as in ``repro``."""
    a, beta, i = _gates(p, x, nldpe)
    u = beta * nldpe.elementwise_mul(i, x).to(torch.float32)
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        u = torch.cat([h0[:, None].to(torch.float32), u], dim=1)
    _, h = _associative_scan(a, u)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1]


def rglru_step(p: dict, x_t: torch.Tensor, h: torch.Tensor,
               nldpe: NLDPEConfig = OFF):
    """x_t (B, 1, d), h (B, d) -> (y_t (B, 1, d), h_new (B, d) float32)."""
    a, beta, i = _gates(p, x_t, nldpe)
    u = beta * nldpe.elementwise_mul(i, x_t).to(torch.float32)
    h_new = a[:, 0] * h.to(torch.float32) + u[:, 0]
    return h_new[:, None].to(x_t.dtype), h_new


def _causal_conv(w: torch.Tensor, x: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv of width W = len(w): x (B, S, d), state (B,
    W - 1, d) or None (zeros) -> (out (B, S, d), the new state: the last W
    - 1 rows of state and x)."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    seq = x.shape[1]
    out = xp[:, 0:seq] * w[0].to(x.dtype)
    for i in range(1, width):
        out = out + xp[:, i:i + seq] * w[i].to(x.dtype)
    return out, xp[:, -(width - 1):]


def recurrent_block_apply(p: dict, x: torch.Tensor, state: dict | None = None,
                          mode: str = "train", nldpe: NLDPEConfig = OFF):
    """x (B, S, d_model) -> (out (B, S, d_model), new state).  ``mode``
    "decode" takes one step from ``state`` (required); "train" and
    "prefill" scan the sequence from ``state`` (None: zeros)."""
    gate = nldpe.activation(x @ p["in_gate"].to(x.dtype), "gelu")
    u = x @ p["in_x"].to(x.dtype)
    u, conv_state = _causal_conv(p["conv"], u,
                                 None if state is None else state["conv"])
    if mode == "decode":
        y, h = rglru_step(p["rglru"], u, state["h"], nldpe)
    else:
        y, h = rglru_scan(p["rglru"], u,
                          None if state is None else state["h"], nldpe)
    y = nldpe.elementwise_mul(gate, y).to(x.dtype)
    return y @ p["out"].to(x.dtype), {"h": h, "conv": conv_state}


def recurrent_state_init(batch: int, d_rnn: int, conv_width: int = 4, *,
                         layers: int | None = None, device=None) -> dict:
    """Zero state ``{"h": (B, d_rnn), "conv": (B, W - 1, d_rnn)}`` in
    float32, with a leading axis of ``layers`` when given (a stack).
    ``repro`` keeps the conv state in the activation dtype after the first
    call; float32 holds those values exactly."""
    lead = () if layers is None else (layers,)
    return {"h": torch.zeros((*lead, batch, d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((*lead, batch, conv_width - 1, d_rnn),
                                dtype=torch.float32, device=device)}

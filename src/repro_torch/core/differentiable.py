"""Differentiable ACAM surrogate — paper Algorithm 1 (port of
``repro.core.differentiable``).

The comparisons of a DT / the ML pull-downs of an ACAM are
non-differentiable; Algorithm 1 replaces them so that per-DT threshold
fine-tuning (NAF step 4) can backpropagate into the stored thresholds:

  line 2-3 : thresholds -> conductances (clip to [g_min, g_max])
  line 4-5 : inject cell noise (Eq 6)
  line 6-7 : noisy conductances -> noisy thresholds
  line 8   : ReLU(x - w_lo) * ReLU(w_hi - x)  — differentiable window match
  line 9   : Sum over rows                    — differentiable OR
  line 10  : m / (m + eps)                    — squash to ~{0, 1}
  line 13-17: Gray->binary via b_i = (m_i - b_{i+1})^2  — differentiable XOR
  line 18  : y = sum b_i 2^i

The threshold <-> conductance map goes through the measured ACAM transfer
function TH(G) = exp(a log G + b) + c (Eq 7), so the noise a threshold
sees is biased and position-dependent: the systematic error NAF learns to
pre-compensate.

Shapes: x (...,), w_lo/w_hi (bits, rows) -> y (...,).  Every function
takes threefry keys (``launch/prng.py``): the same key draws the
reference's normals.  The map's clips send half the gradient through at
a tie, as ``jnp.clip`` does (``noise.clip``; a threshold at a domain end
sits on the tie).  ``hard_acam_forward`` evaluates the
exact interval match through kernel D on CUDA tensors
(``kernels.acam_activation.acam_apply_grid``) and its plain version on
CPU tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..launch import prng
from .noise import IDEAL, NoiseModel, clip, true_div


@dataclasses.dataclass(frozen=True)
class DiffACAMConfig:
    bits: int = 8
    eps: float = 1e-6
    th_lo: float = -8.0            # function-input domain mapped onto TH range
    th_hi: float = 8.0
    relu_scale: float = 1.0


class _Div(torch.autograd.Function):
    """``a / b`` with the derivative JAX takes: ``g / b`` for ``a`` and
    ``(-g * a) * (1 / (b * b))`` for ``b``.  Algorithm 1's squash
    ``m / (m + eps)`` meets rows whose upper threshold is a 1e30 wildcard,
    where ``m`` is ~1e30 and ``b * b`` overflows float32: the second term
    is then 0 and the first is not, so the threshold gets a gradient the
    exact derivative (~0) would not give it.  NAF trains on that
    gradient, so the port takes it too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a / b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g / b, (-g * a) * (1.0 / (b * b))


def _keys(rng):
    if rng is None:
        return None, None
    k1, k2 = prng.split(rng)
    return k1, k2


def _thresholds_through_cells(rng: torch.Tensor | None, w: torch.Tensor,
                              cfg: DiffACAMConfig,
                              model: NoiseModel) -> torch.Tensor:
    """Algorithm 1 lines 2-6 + Eq 7 for one threshold tensor.

    domain x -> TH volts (affine) -> G (Eq 7 inverse, clipped) -> Eq 6
    noise -> TH volts (Eq 7) -> domain x.  Padding rows (|th| >= 1e29)
    pass through."""
    dev = w.device
    pad = torch.abs(w) >= 1e29
    th_min = model.threshold_of_g(torch.tensor(np.float32(model.g_min),
                                               device=dev))
    th_max = model.threshold_of_g(torch.tensor(np.float32(model.g_max),
                                               device=dev))
    span = cfg.th_hi - cfg.th_lo
    u = true_div(torch.where(pad, cfg.th_lo, w) - cfg.th_lo, span)
    v = th_min + clip(u, 0.0, 1.0) * (th_max - th_min)
    g = clip(model.g_of_threshold(v), model.g_min, model.g_max)
    if rng is not None and model.scale > 0.0:
        g = model.readout(rng.to(dev), g)
    v2 = model.threshold_of_g(g)
    w2 = cfg.th_lo + torch.div(v2 - th_min, th_max - th_min) * span
    return torch.where(pad, w, w2)


def diff_acam_forward(x: torch.Tensor, w_lo: torch.Tensor,
                      w_hi: torch.Tensor, rng: torch.Tensor | None = None,
                      cfg: DiffACAMConfig = DiffACAMConfig(),
                      model: NoiseModel = IDEAL, out_lo: float = 0.0,
                      out_step: float = 1.0) -> torch.Tensor:
    """Differentiable 8-bit ACAM output for inputs x (soft binary code)."""
    bits = w_lo.shape[0]
    k1, k2 = _keys(rng)
    wl = _thresholds_through_cells(k1, w_lo, cfg, model)
    wh = _thresholds_through_cells(k2, w_hi, cfg, model)
    xe = x[..., None, None]                                   # (..., 1, 1)
    m = torch.relu(cfg.relu_scale * (xe - wl)) \
        * torch.relu(cfg.relu_scale * (wh - xe))
    m = torch.sum(m, dim=-1)                        # OR over rows: (..., bits)
    m = _Div.apply(m, m + cfg.eps)                            # ~{0,1}
    # lines 12-19: Gray -> binary, MSB first: b_{n-1} = m_{n-1};
    # b_i = (m_i - b_{i+1})^2
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    b_next = None
    for i in range(bits - 1, -1, -1):
        m_i = m[..., i]
        b_i = m_i if b_next is None else (m_i - b_next) ** 2
        y = y + b_i * (2.0 ** i)
        b_next = b_i
    return y * out_step + out_lo


def soft_gray_bits(x: torch.Tensor, w_lo: torch.Tensor, w_hi: torch.Tensor,
                   rng: torch.Tensor | None = None,
                   cfg: DiffACAMConfig = DiffACAMConfig(),
                   model: NoiseModel = IDEAL,
                   beta: float = 20.0) -> torch.Tensor:
    """Two-sided surrogate for per-bit NAF: each bit-plane as the binary
    classifier it is (sigmoid-window row match, exact soft OR), supervised
    against the known Gray bit targets.  Returns (..., bits) soft bit
    probabilities."""
    k1, k2 = _keys(rng)
    wl = _thresholds_through_cells(k1, w_lo, cfg, model)
    wh = _thresholds_through_cells(k2, w_hi, cfg, model)
    xe = x[..., None, None]
    sr = torch.sigmoid(beta * (xe - wl)) * torch.sigmoid(beta * (wh - xe))
    return 1.0 - torch.prod(1.0 - sr, dim=-1)         # exact soft OR


def hard_acam_forward(x: torch.Tensor, w_lo: torch.Tensor,
                      w_hi: torch.Tensor, rng: torch.Tensor | None = None,
                      cfg: DiffACAMConfig = DiffACAMConfig(),
                      model: NoiseModel = IDEAL, out_lo: float = 0.0,
                      out_step: float = 1.0) -> torch.Tensor:
    """Non-differentiable twin (exact comparisons) for eval — the same
    noise path, then the Gray-coded interval match of the noisy
    thresholds: kernel D for CUDA tensors (which launches or raises), its
    plain version for CPU tensors."""
    from ..kernels.acam_activation.ops import acam_apply_grid
    k1, k2 = _keys(rng)
    with torch.no_grad():
        wl = _thresholds_through_cells(k1, w_lo, cfg, model)
        wh = _thresholds_through_cells(k2, w_hi, cfg, model)
        return acam_apply_grid(x, wl.contiguous(), wh.contiguous(), out_lo,
                               out_step)

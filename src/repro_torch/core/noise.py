"""RRAM device constants and the weight <-> conductance map (port of the
parts of ``repro.core.noise`` the fused crossbar->ACAM path needs).

Programming in the serve path is ideal (``plan_asl(..., prog_rng=None)``),
so only the noise model's conductance range is used; the stochastic Eq 5-7
terms stay in ``repro`` until the fidelity loop is ported.
Conductances are in micro-Siemens.
"""
from __future__ import annotations

import dataclasses

import torch

G_MIN_US = 0.01    # 100 Mohm  (paper §V)
G_MAX_US = 150.0   # 6.7 kohm


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Fitted Eq 5-7 parameters (``repro.core.noise.NoiseModel``'s
    defaults); ``scale`` multiplies both sigmas."""

    a_prog: float = 0.50
    b_prog: float = -3.22
    c_prog: float = 100.0
    a_fluct: float = 0.50
    b_fluct: float = -3.57
    c_fluct: float = 50.0
    a_acam: float = 0.30
    b_acam: float = -1.20
    c_acam: float = 0.05
    scale: float = 1.0
    g_min: float = G_MIN_US
    g_max: float = G_MAX_US


DEFAULT = NoiseModel()


def _g_ratio(w_max: torch.Tensor, model: NoiseModel) -> torch.Tensor:
    """(g_max - g_min) / w_max as a true float32 division (``float /
    tensor`` in PyTorch is ``reciprocal() * float``, which rounds
    differently from the reference)."""
    return torch.div(w_max.new_tensor(model.g_max - model.g_min), w_max)


def weight_to_g(w: torch.Tensor, w_max: torch.Tensor,
                model: NoiseModel = DEFAULT) -> torch.Tensor:
    """Map |w| in [0, w_max] linearly onto [g_min, g_max] (Algorithm 1
    l.2-3).  ``w_max`` is a 0-d tensor on ``w``'s device (never fetched to
    the host)."""
    g_ratio = _g_ratio(w_max, model)
    return torch.clamp(torch.abs(w) * g_ratio + model.g_min,
                       model.g_min, model.g_max)


def g_to_weight(g: torch.Tensor, w_max: torch.Tensor,
                model: NoiseModel = DEFAULT) -> torch.Tensor:
    return (g - model.g_min) / _g_ratio(w_max, model)

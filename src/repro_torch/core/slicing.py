"""Analog slicing (A-SL) weight-to-cell mapping (port of
``repro.core.slicing.plan_asl`` with ideal programming, ``prog_rng=None``).

A signed weight becomes a differential pair of main cells plus a pair of
residual cells that store 10x the pair's programming error; at read time
the residual current is divided by ``RESIDUAL_GAIN`` (paper Fig 9b).
"""
from __future__ import annotations

import dataclasses

import torch

from .noise import DEFAULT, NoiseModel, g_to_weight, weight_to_g

RESIDUAL_GAIN = 10.0  # second cell stores 10*eps (paper Fig 9b)


@dataclasses.dataclass
class SlicedWeights:
    """Conductance plan: (pos|neg) x (main|residual) target conductances."""

    g_pos_main: torch.Tensor
    g_neg_main: torch.Tensor
    g_pos_res: torch.Tensor
    g_neg_res: torch.Tensor
    w_max: torch.Tensor

    @property
    def cells(self) -> list[torch.Tensor]:
        return [self.g_pos_main, self.g_neg_main, self.g_pos_res,
                self.g_neg_res]


def plan_asl(w: torch.Tensor, w_max: torch.Tensor,
             model: NoiseModel = DEFAULT
             ) -> tuple[SlicedWeights, torch.Tensor]:
    """Ideal analog slicing.  Returns (plan, |eps|): the main cells hold
    the target conductances and the residual cells the signed residual of
    the pair's float rounding, times ``RESIDUAL_GAIN``."""
    g_pos = weight_to_g(torch.clamp(w, min=0.0), w_max, model)
    g_neg = weight_to_g(torch.clamp(-w, min=0.0), w_max, model)
    eps_signed = (g_to_weight(g_pos, w_max, model)
                  - g_to_weight(g_neg, w_max, model)) - w

    def program_res(target):
        return weight_to_g(torch.minimum(torch.clamp(target, min=0.0),
                                         w_max), w_max, model)

    plan = SlicedWeights(
        g_pos_main=g_pos, g_neg_main=g_neg,
        g_pos_res=program_res(-eps_signed * RESIDUAL_GAIN),
        g_neg_res=program_res(eps_signed * RESIDUAL_GAIN),
        w_max=w_max)
    return plan, torch.abs(eps_signed)

"""Analog slicing (A-SL) weight-to-cell mapping (port of
``repro.core.slicing``'s ``plan_asl`` and ``effective_weight``, paper
§IV-B / Fig 9).

A signed weight becomes a differential pair of main cells plus a pair of
residual cells that store 10x the pair's programming error; at read time
the residual current is divided by ``RESIDUAL_GAIN`` (Fig 9b).
Programming is ideal with ``prog_rng=None`` and one Eq 6 programming
event per cell otherwise; ``effective_weight`` adds a fresh read (and
optional stuck-at faults) per compute pass.
"""
from __future__ import annotations

import dataclasses

import torch

from ..launch import prng
from .noise import (DEFAULT, NoiseModel, g_to_weight, stuck_at_faults,
                    true_div, weight_to_g)

RESIDUAL_GAIN = 10.0  # second cell stores 10*eps (paper Fig 9b)


@dataclasses.dataclass
class SlicedWeights:
    """Conductance plan: (pos|neg) x (main|residual) target conductances.
    ``w_max`` is a host float or a 0-d tensor (see ``core/noise.py``)."""

    g_pos_main: torch.Tensor
    g_neg_main: torch.Tensor
    g_pos_res: torch.Tensor
    g_neg_res: torch.Tensor
    w_max: float | torch.Tensor

    @property
    def cells(self) -> list[torch.Tensor]:
        return [self.g_pos_main, self.g_neg_main, self.g_pos_res,
                self.g_neg_res]


def plan_asl(w: torch.Tensor, w_max, model: NoiseModel = DEFAULT,
             prog_rng: torch.Tensor | None = None
             ) -> tuple[SlicedWeights, torch.Tensor]:
    """Analog slicing.  Returns (plan, |eps|).

    The main cells carry one program-and-verify realization (ideal with
    ``prog_rng=None``), and the residual cells are programmed (with their
    own error) to -10*eps so that ``main + res/10`` cancels the first-order
    error at read time.  ``prog_rng`` splits four ways, one key per cell
    matrix, as the reference splits it."""
    if prog_rng is not None:
        k1, k2, k3, k4 = prng.split(prog_rng, 4)
    else:
        k1 = k2 = k3 = k4 = None

    def program(key, target):
        g_t = weight_to_g(target, w_max, model)
        return g_t if key is None else model.program(key, g_t)

    def clip_res(target):
        if isinstance(w_max, torch.Tensor):
            return torch.minimum(torch.clamp(target, min=0.0), w_max)
        return torch.clamp(target, 0.0, w_max)

    g_pos = program(k1, torch.clamp(w, min=0.0))
    g_neg = program(k2, torch.clamp(-w, min=0.0))
    # signed residual of the differential pair; a positive error is
    # corrected through the NEGATIVE residual cell (conductances only add)
    eps_signed = (g_to_weight(g_pos, w_max, model)
                  - g_to_weight(g_neg, w_max, model)) - w
    plan = SlicedWeights(
        g_pos_main=g_pos, g_neg_main=g_neg,
        g_pos_res=program(k3, clip_res(-eps_signed * RESIDUAL_GAIN)),
        g_neg_res=program(k4, clip_res(eps_signed * RESIDUAL_GAIN)),
        w_max=w_max)
    return plan, torch.abs(eps_signed)


def effective_weight(plan: SlicedWeights, rng: torch.Tensor | None = None,
                     model: NoiseModel = DEFAULT,
                     saf_rate: float = 0.0) -> torch.Tensor:
    """The signed weight the crossbar computes with, after noise:
    W_eff = (w+ - w-) + (w+_res - w-_res) / 10, each cell read once with
    Eq 6 fluctuation (key ``split(rng, 4)[i]``) and, with ``saf_rate``,
    stuck-at faults keyed ``fold_in(that key, 7)``."""
    cells = plan.cells
    if rng is not None:
        noisy = []
        for k, g in zip(prng.split(rng, len(cells)), cells):
            g_n = model.read(k, g)
            if saf_rate > 0.0:
                g_n, _ = stuck_at_faults(prng.fold_in(k, 7), g_n, saf_rate,
                                         model)
            noisy.append(g_n)
        cells = noisy
    wp, wn, rp, rn = (g_to_weight(g, plan.w_max, model) for g in cells)
    return (wp - wn) + true_div(rp - rn, RESIDUAL_GAIN)

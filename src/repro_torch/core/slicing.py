"""Weight-to-cell mapping: analog slicing (A-SL) and digital slicing (D-SL)
(port of ``repro.core.slicing``, paper §IV-B / Fig 9).

A-SL: a signed weight becomes a differential pair of main cells plus a
pair of residual cells that store 10x the pair's programming error; at
read time the residual current is divided by ``RESIDUAL_GAIN`` (Fig 9b).
Programming is ideal with ``prog_rng=None`` and one Eq 6 programming
event per cell otherwise; ``effective_weight`` adds a fresh read (and
optional stuck-at faults) per compute pass.

D-SL (``plan_dsl``, ``effective_weight_dsl``): the weight quantized to
``bits`` bits, each ``cell_bits``-bit digit in its own cell pair, the
slices recombined by shift-and-add — discrete levels, the Fig 16 baseline.
Divisions by host floats round once in float32 (``true_div``), as the
reference's eager code divides.
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


def plan_dsl(w: torch.Tensor, w_max: float, bits: int = 8,
             cell_bits: int = 2,
             model: NoiseModel = DEFAULT) -> list[SlicedWeights]:
    """Digital slicing: one plan per ``cell_bits``-bit slice (LSB slice
    first).  Slice s stores integer digits in [0, 2^cell_bits - 1] mapped
    linearly to conductance; compute-time recombination is
    sum_s (2^cell_bits)^s * y_s.  ``w_max`` is a host float."""
    levels = (1 << bits) - 1
    scale = levels / w_max
    w_pos_q = torch.round(torch.clamp(w, 0, w_max) * scale).to(torch.int32)
    w_neg_q = torch.round(torch.clamp(-w, 0, w_max) * scale).to(torch.int32)
    n_slices = (bits + cell_bits - 1) // cell_bits
    digit_max = (1 << cell_bits) - 1
    plans = []
    for sl in range(n_slices):
        shift = sl * cell_bits

        def cell(q):
            d = ((q >> shift) & digit_max).to(torch.float32)
            return weight_to_g(true_div(d, digit_max) * w_max, w_max, model)
        plans.append(SlicedWeights(
            g_pos_main=cell(w_pos_q), g_neg_main=cell(w_neg_q),
            g_pos_res=torch.full_like(w, model.g_min),
            g_neg_res=torch.full_like(w, model.g_min), w_max=w_max))
    return plans


def effective_weight_dsl(plans: list[SlicedWeights], cell_bits: int,
                         bits: int, rng: torch.Tensor | None = None,
                         model: NoiseModel = DEFAULT,
                         saf_rate: float = 0.0) -> torch.Tensor:
    """Shift-and-add recombination of D-SL slices (discrete levels -> more
    noise-sensitive; the Fig 16 benchmark).  Slice s reads with key
    ``fold_in(rng, s)``; its readout digit is w_s * digit_max / w_max and
    the weight is (sum_s digit_s * 2^(s*cell_bits)) / (2^bits - 1) *
    w_max."""
    levels = float((1 << bits) - 1)
    digit_max = float((1 << cell_bits) - 1)
    total = None
    for sl, plan in enumerate(plans):
        k = None if rng is None else prng.fold_in(rng, sl)
        w_s = effective_weight(plan, k, model, saf_rate)
        digit = true_div(w_s * digit_max, plan.w_max)
        contrib = digit * float(1 << (sl * cell_bits))
        total = contrib if total is None else total + contrib
    return true_div(total, levels) * plans[0].w_max

"""LR schedules: linear warmup + cosine, and MiniCPM's WSD
(Warmup-Stable-Decay, arXiv:2404.06395) (port of ``repro.optim.schedules``).

Each schedule maps a step (int or tensor) to a 0-d float32 tensor on the
step's device (the CPU for an int), computed in float32 as the reference
computes it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.noise import true_div


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = true_div(peak_lr * step, max(warmup, 1))
        prog = torch.clamp(true_div(step - warmup, max(total - warmup, 1)),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return f


def wsd(peak_lr: float, warmup: int, stable: int, decay: int,
        floor_frac: float = 0.01):
    """Warmup -> flat plateau -> exponential decay to the floor."""
    def f(step):
        step = _f32(step)
        warm = true_div(peak_lr * step, max(warmup, 1))
        in_decay = torch.clamp(
            true_div(step - warmup - stable, max(decay, 1)), 0.0, 1.0)
        log_floor = torch.log(step.new_tensor(np.float32(floor_frac)))
        dec = peak_lr * torch.exp(log_floor * in_decay)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       step.new_tensor(peak_lr), dec))
    return f


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)

"""Carry ``repro``'s parameters across to the port.

``from_jax(tree)`` takes ``repro.models.lm.init_params``'s pytree — nested
dicts in the stacked ``"groups"`` layout, leaves as numpy arrays (or
anything ``np.asarray`` accepts) — and returns the port's parameter tree:
the same keys, float32 torch tensors on ``device``.  The two packages
share the layout, so the conversion is leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def from_jax(tree, device=None) -> dict:
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x, dtype=np.float32)
        return torch.from_numpy(a.copy()).to(device)

    return conv(tree)

"""Carry ``repro``'s state across to the port.

``from_jax(tree)`` takes a pytree of ``repro``'s — nested dicts of
parameters in the stacked ``"groups"`` layout, AdamW state ``{"m", "v",
"step"}``, ACAM tables — with leaves as numpy arrays (or anything
``np.asarray`` accepts) and returns the port's: the same keys, float
leaves as float32 torch tensors on ``device``, integer and boolean leaves
in their own dtype (AdamW's int32 ``step``), and an ACAM table (any
object with ``lo``/``hi`` thresholds and an ``out_spec``) as the port's
``ACAMTable`` with float32 numpy thresholds, as the port keeps them.  The
two packages share the layouts, so the conversion is leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def from_jax(tree, device=None):
    from .core.dt import ACAMTable
    from .core.quantization import QuantSpec
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "out_spec") and hasattr(x, "lo"):
            s = x.out_spec
            return ACAMTable(
                name=x.name, bits=int(x.bits), encoding=x.encoding,
                in_domain=tuple(float(v) for v in x.in_domain),
                out_spec=QuantSpec(lo=float(s.lo), hi=float(s.hi),
                                   bits=int(s.bits)),
                lo=np.array(x.lo, np.float32), hi=np.array(x.hi, np.float32),
                rows_per_bit=tuple(int(r) for r in x.rows_per_bit))
        a = np.asarray(x)
        if not (np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_):
            a = a.astype(np.float32)
        return torch.from_numpy(a.copy()).to(device)

    return conv(tree)

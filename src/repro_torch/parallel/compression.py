"""Gradient compression for cross-pod reduces: int8 + error feedback (port
of ``repro.parallel.compression``).

Per-tensor symmetric int8 with an error-feedback accumulator (Seide et
al. / EF-SGD): the quantization residual is carried into the next step,
which keeps SGD/Adam unbiased in the long run.  ``compress_tree`` and
``ef_compress_step`` model the wire format exactly; ``bytes_scale`` is the
wire-byte ratio a roofline's collective term scales by.  As in ``repro``,
the train step does not call it: the module is the format.

Rounding follows ``repro``'s eager functions bit for bit: the scale is
``max(max|g|, 1e-12) / 127`` and the codes ``round(g / scale)`` as true
IEEE divisions (``core.noise.true_div`` and ``torch.div`` by the scale
tensor; not ``scalar_div``, the reciprocal product ``jit`` would fuse),
``round`` half to even as ``jnp.round``.  Trees are nested dicts of
tensors.
"""
from __future__ import annotations

import torch

from ..core.noise import true_div


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def compress(g: torch.Tensor):
    """g -> (int8 codes, float32 scale): ``scale = max(max|g|, 1e-12) /
    127``, codes ``clip(round(g / scale), -127, 127)``."""
    amax = torch.clamp(torch.amax(torch.abs(g)), min=1e-12)
    scale = true_div(amax, 127.0)
    q = torch.clamp(torch.round(torch.div(g, scale)), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads):
    return _map(compress, grads)


def ef_compress_step(grads, error_state):
    """One error-feedback step: (wire tree of (int8, scale) pairs — what
    crosses the wire —, its decompressed values, the new error state).
    ``error_state`` None starts from zeros."""
    if error_state is None:
        error_state = _map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                           grads)
    corrected = _map(lambda g, e: g.to(torch.float32) + e, grads,
                     error_state)
    wire = _map(compress, corrected)
    recon = _map(lambda c, qs: decompress(*qs), corrected, wire)
    new_error = _map(lambda c, r: c - r, corrected, recon)
    return wire, recon, new_error


def bytes_scale(dtype=torch.float32) -> float:
    """Wire-byte ratio of int8 compression against ``dtype``."""
    return 1.0 / torch.empty((), dtype=dtype).element_size()

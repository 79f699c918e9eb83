"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro.optim.adamw``).

State mirrors the parameter tree (``m``, ``v`` in float32) plus an int32
``step``, as in the reference.  Where the reference returns new trees,
``update`` writes the new parameters and moments into the given tensors
(at full width a second copy of parameters and moments would not fit
beside the first) and walks each leaf in ``core.drift.CHUNK``-element
chunks, so its temporaries stay one chunk wide.  Gradient leaves may be
of any float dtype; each chunk is upcast to float32 first, as the
reference's ``g.astype(float32)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.drift import _chunks, flatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable = 3e-4       # float or schedule(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float | None = 1.0


def init(params) -> dict:
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    dev = flatten(params)[0][1].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.

    On a ``mesh`` the leaves are this rank's shards at ``specs`` (the
    tree's placements): each leaf's local sum counts once per shard — the
    sums of the leaves split over the same mesh axes are added, then
    all-reduced over those axes — and a replicated leaf's once, so every
    rank gets the norm of the whole tree."""
    sums: dict = {}
    spec = dict(flatten(specs)) if specs is not None else {}
    for path, x in flatten(tree):
        flat = x.reshape(-1)
        s = torch.zeros((), dtype=torch.float32, device=x.device)
        for o, m in _chunks(flat.numel()):
            s = s + torch.sum(torch.square(flat[o:o + m].to(torch.float32)))
        axes = () if mesh is None else _split_axes(spec.get(path), mesh)
        sums.setdefault(axes, []).append(s)
    parts = []
    for axes, group in sums.items():
        t = torch.sum(torch.stack(group))
        parts.append(mesh.all_reduce(t, axes) if axes else t)
    return torch.sqrt(torch.sum(torch.stack(parts)))


def _split_axes(spec, mesh) -> tuple:
    """The mesh axes (of size > 1) a leaf's spec splits it over, in mesh
    order."""
    used = {a for d in range(len(spec or ())) for a in spec.axes_of(d)}
    return tuple(a for a in mesh.shape if a in used and mesh.shape[a] > 1)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)) in float32 (a true division)."""
    d = torch.clamp(norm, min=1e-9)
    return torch.minimum(d.new_tensor(1.0), torch.div(d.new_tensor(max_norm),
                                                      d))


def update(cfg: AdamWConfig, grads, state: dict, params, specs=None,
           mesh=None):
    """One AdamW step: clip ``grads`` by their global norm, then update
    ``params`` and ``state`` in place.  Returns (params, state, metrics)
    — the same ``params`` and ``state`` objects.  On a ``mesh`` every
    tree holds this rank's shards at ``specs`` (``global_norm``); the
    update is elementwise, so each rank updates its own shards."""
    metrics = {}
    scale = None
    if cfg.grad_clip_norm:
        gnorm = global_norm(grads, specs, mesh)
        scale = clip_scale(gnorm, cfg.grad_clip_norm)
        metrics["grad_norm"] = gnorm
    step = state["step"] + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    metrics["lr"] = torch.as_tensor(lr, dtype=torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    c1 = 1 - torch.pow(sf.new_tensor(np.float32(b1)), sf)
    c2 = 1 - torch.pow(sf.new_tensor(np.float32(b2)), sf)
    with torch.no_grad():
        gl = dict(flatten(grads))
        ml, vl = dict(flatten(state["m"])), dict(flatten(state["v"]))
        for path, p in flatten(params):
            pf, gf = p.view(-1), gl[path].reshape(-1)
            mf, vf = ml[path].view(-1), vl[path].view(-1)
            for o, n in _chunks(pf.numel()):
                g = gf[o:o + n].to(torch.float32)
                if scale is not None:
                    g = g * scale
                m = mf[o:o + n].mul_(b1).add_(g * (1 - b1))
                v = vf[o:o + n].mul_(b2).add_(g * (1 - b2) * g)
                x = pf[o:o + n]
                delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
                    + cfg.weight_decay * x.to(torch.float32)
                x.copy_(x.to(torch.float32) - lr * delta)
    state["step"] = step
    return params, state, metrics

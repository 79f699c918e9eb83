"""Synthetic image-classification corpus for the CNN substrate (port of
``repro.data.images``).

Class c is a 2-D sinusoidal texture with class-dependent frequency and
orientation plus noise: linearly non-separable in pixel space but easy
for a small CNN.  A pure function of (seed, step), so restarts resume
exactly.  Draws use the port's threefry (``launch/prng.py``): the labels
are ``jax.random.randint``'s bit for bit (uint32 wraparound included);
the noise is ``jax.random.normal``'s within its 4 ulps (``erf_inv``), and
``sin``/``cos`` round apart between the frameworks, so pixels agree with
the reference's within a few float32 ulps of their magnitude.  The
reference's float32 constants (``3.14159``, ``0.5``, ``0.1``) and its
integer meshgrid promoted to float32 are kept.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..launch import prng


@dataclasses.dataclass(frozen=True)
class ImageDataConfig:
    num_classes: int = 10
    img_size: int = 32
    channels: int = 3
    batch: int = 32
    seed: int = 0
    noise: float = 0.4


def _f32(x: float) -> float:
    return float(np.float32(x))


def make_batch_fn(cfg: ImageDataConfig, device=None):
    """Returns ``batch_fn(step) -> {"images": (B, H, W, C) float32,
    "labels": (B,) int32}`` on ``device`` (the GPU unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    size = cfg.img_size
    ar = torch.arange(size, dtype=torch.int32, device=dev)
    yy, xx = (t.to(torch.float32) for t in torch.meshgrid(ar, ar,
                                                          indexing="ij"))
    base_key = prng.prng_key(cfg.seed).to(dev)

    def batch_fn(step) -> dict:
        key = prng.fold_in(base_key, int(step))
        k1, k2 = prng.split(key)
        labels = prng.randint(k1, (cfg.batch,), 0, cfg.num_classes)
        keys = prng.split(k2, cfg.batch)
        lab = labels.to(torch.float32)[:, None, None]         # (B, 1, 1)
        freq = 1.0 + lab * _f32(0.5)
        angle = lab * _f32(3.14159 / cfg.num_classes)
        u = (xx * torch.cos(angle) + yy * torch.sin(angle)) / size
        base = torch.sin(_f32(2 * 3.14159) * freq * u)
        img = torch.stack([base * _f32(1 + 0.1 * c)
                           for c in range(cfg.channels)], dim=-1)
        noise = prng.normal(keys, (size, size, cfg.channels))
        images = img + _f32(cfg.noise) * noise
        return {"images": images.to(torch.float32),
                "labels": labels.to(torch.int32)}

    return batch_fn

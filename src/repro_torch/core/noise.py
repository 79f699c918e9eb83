"""RRAM non-ideality models (port of ``repro.core.noise``: paper §IV-A,
Eq 5-7, Fig 7) and stuck-at faults.

Two stochastic noise sources, both log-linear with saturation in the
conductance:

  sigma_x(G) = exp(a_x * log(G.clip(0, c_x)) + b_x)            (Eq 5)
  G_read = G_target + sigma_prog(G_target)*N(0,1)
                    + sigma_fluct(G)*N(0,1)                    (Eq 6)

and the conductance -> ACAM threshold transfer function

  TH(G) = exp(a_acam * log(G) + b_acam) + c_acam               (Eq 7).

Every draw takes an explicit threefry key (``launch/prng.py``), so the
same key gives the reference's normals and fault masks.  Conductances are
in micro-Siemens.

``w_max`` takes two routes through the weight <-> conductance map, as the
reference's two callers do:

* a host float (``program_linear``, ``crossbar_matmul``): the reference
  computes ``g_ratio = (g_max - g_min) / w_max`` in Python doubles and
  rounds it to float32 only where it meets an array;
* a 0-d tensor (``fused_linear_acam``, where ``repro`` traces ``w_max``):
  ``g_ratio`` is a float32 division on the device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..launch import prng

G_MIN_US = 0.01    # 100 Mohm  (paper §V)
G_MAX_US = 150.0   # 6.7 kohm


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Fitted Eq 5-7 parameters (``repro.core.noise.NoiseModel``'s
    defaults).  ``scale`` multiplies both sigmas (Fig 15)."""

    # sigma_prog(G_target): saturates at ~0.4 uS near G_max
    a_prog: float = 0.50
    b_prog: float = -3.22
    c_prog: float = 100.0
    # sigma_fluct(G): smaller, saturates earlier
    a_fluct: float = 0.50
    b_fluct: float = -3.57
    c_fluct: float = 50.0
    # ACAM threshold transfer TH(G) (volts vs uS)
    a_acam: float = 0.30
    b_acam: float = -1.20
    c_acam: float = 0.05
    scale: float = 1.0
    g_min: float = G_MIN_US
    g_max: float = G_MAX_US

    def __post_init__(self):
        # a NaN/inf/negative scale poisons every sigma silently (the clip
        # in program/read hides it) — rejected at construction
        if not (isinstance(self.scale, (int, float))
                and math.isfinite(self.scale)):
            raise ValueError(
                f"NoiseModel.scale={self.scale!r} must be a finite number")
        if self.scale < 0:
            raise ValueError(
                f"NoiseModel.scale={self.scale} must be >= 0 "
                f"(0 disables noise)")
        if not (0 < self.g_min < self.g_max):
            raise ValueError(
                f"NoiseModel needs 0 < g_min < g_max, got "
                f"g_min={self.g_min}, g_max={self.g_max}")

    # -- Eq 5 ---------------------------------------------------------------
    def sigma_prog(self, g_target: torch.Tensor) -> torch.Tensor:
        g = clip(g_target, 1e-6, self.c_prog)
        return self.scale * torch.exp(self.a_prog * torch.log(g)
                                      + self.b_prog)

    def sigma_fluct(self, g: torch.Tensor) -> torch.Tensor:
        gc = clip(g, 1e-6, self.c_fluct)
        return self.scale * torch.exp(self.a_fluct * torch.log(gc)
                                      + self.b_fluct)

    # -- Eq 6 ---------------------------------------------------------------
    def program(self, rng: torch.Tensor, g_target: torch.Tensor, *,
                offset: int = 0) -> torch.Tensor:
        """One programming event: persistent write error.  ``offset``:
        ``g_target`` is the chunk from that flat index on of a larger
        array (``prng``'s counter offset)."""
        n = prng.normal(rng.to(g_target.device), g_target.shape,
                        offset=offset)
        g = g_target + self.sigma_prog(g_target) * n
        return clip(g, self.g_min, self.g_max)

    def read(self, rng: torch.Tensor, g_programmed: torch.Tensor, *,
             offset: int = 0) -> torch.Tensor:
        """One read event: fresh fluctuation noise per read."""
        n = prng.normal(rng.to(g_programmed.device), g_programmed.shape,
                        offset=offset)
        g = g_programmed + self.sigma_fluct(g_programmed) * n
        return clip(g, 0.0, self.g_max)

    def readout(self, rng: torch.Tensor,
                g_target: torch.Tensor) -> torch.Tensor:
        """Eq 6 composite: program once then read once."""
        k1, k2 = prng.split(rng)
        return self.read(k2, self.program(k1, g_target))

    # -- Eq 7 ---------------------------------------------------------------
    def threshold_of_g(self, g: torch.Tensor) -> torch.Tensor:
        g = clip(g, 1e-6)
        return torch.exp(self.a_acam * torch.log(g) + self.b_acam) \
            + self.c_acam

    def g_of_threshold(self, th: torch.Tensor) -> torch.Tensor:
        """Inverse of Eq 7 (used when programming a desired threshold)."""
        t = clip(th - self.c_acam, 1e-9)
        return torch.exp(true_div(torch.log(t) - self.b_acam, self.a_acam))

    def rescale(self, s: float) -> "NoiseModel":
        return dataclasses.replace(self, scale=s)


IDEAL = NoiseModel(scale=0.0)
DEFAULT = NoiseModel()


def clip(x: torch.Tensor, lo: float, hi: float | None = None
         ) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``.  The values are ``torch.clamp``'s; where
    ``x`` needs a gradient it is ``minimum(maximum(x, lo), hi)``, which
    sends half the gradient through at a tie, as ``jnp.clip`` does (NAF
    differentiates through this map, and a weight at its leaf's ``w_max``
    lands exactly on ``g_max``)."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    x = torch.maximum(x, x.new_tensor(lo))
    return x if hi is None else torch.minimum(x, x.new_tensor(hi))


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as one IEEE float32 division per element, on every
    device, as the reference's eager ``x / python_float`` rounds it
    (``tensor / float`` on CUDA multiplies by a reciprocal instead)."""
    return torch.div(x, torch.tensor(s, dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Weight <-> conductance mapping (shared by the crossbar and ACAM paths)
# ---------------------------------------------------------------------------

def _g_ratio(w_max: torch.Tensor, model: NoiseModel) -> torch.Tensor:
    """(g_max - g_min) / w_max as a true float32 division on the device
    (``float / tensor`` in PyTorch is ``reciprocal() * float``)."""
    return torch.div(w_max.new_tensor(model.g_max - model.g_min), w_max)


def weight_to_g(w: torch.Tensor, w_max, model: NoiseModel = DEFAULT
                ) -> torch.Tensor:
    """Map |w| in [0, w_max] linearly onto [g_min, g_max] (Algorithm 1
    l.2-3).  ``w_max``: a host float (double ``g_ratio``) or a 0-d tensor
    on ``w``'s device (float32 ``g_ratio``, never fetched to the host)."""
    if isinstance(w_max, torch.Tensor):
        g_ratio = _g_ratio(w_max, model)
    else:
        g_ratio = float(np.float32((model.g_max - model.g_min) / w_max))
    return clip(torch.abs(w) * g_ratio + model.g_min, model.g_min,
                model.g_max)


def g_to_weight(g: torch.Tensor, w_max, model: NoiseModel = DEFAULT
                ) -> torch.Tensor:
    if isinstance(w_max, torch.Tensor):
        return (g - model.g_min) / _g_ratio(w_max, model)
    return true_div(g - model.g_min, (model.g_max - model.g_min) / w_max)


def noisy_weight(rng: torch.Tensor, w: torch.Tensor, w_max,
                 model: NoiseModel = DEFAULT) -> torch.Tensor:
    """Round-trip a (non-negative) weight through a noisy cell (Eq 6)."""
    g = model.readout(rng, weight_to_g(w, w_max, model))
    return g_to_weight(g, w_max, model)


def noisy_thresholds(rng: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     th_range: tuple[float, float],
                     model: NoiseModel = DEFAULT
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Round-trip ACAM interval thresholds through noisy cells + Eq 7.

    Threshold values (in function-input units, spanning ``th_range``) are
    normalized to the TH voltage window, inverted through Eq 7 to target
    conductances, perturbed per Eq 6, and mapped back.  Padding rows
    (|th| >= 1e29) pass through untouched so they can never match.  One
    key splits into ``lo``'s and ``hi``'s, as in the reference; every
    division is one IEEE float32 division, as the reference's eager code
    rounds it."""
    t_lo, t_hi = th_range
    dev = lo.device
    th_min = model.threshold_of_g(torch.tensor(np.float32(model.g_min),
                                               device=dev))
    th_max = model.threshold_of_g(torch.tensor(np.float32(model.g_max),
                                               device=dev))

    def roundtrip(key, th):
        pad = torch.abs(th) >= 1e29
        u = true_div(torch.where(pad, t_lo, th) - t_lo, t_hi - t_lo)
        g = model.g_of_threshold(th_min + u * (th_max - th_min))
        g_noisy = model.readout(key, g)
        v = model.threshold_of_g(g_noisy)
        th_noisy = t_lo + torch.div(v - th_min, th_max - th_min) \
            * (t_hi - t_lo)
        return torch.where(pad, th, th_noisy)

    k1, k2 = prng.split(rng.to(dev))
    return roundtrip(k1, lo), roundtrip(k2, hi)


# ---------------------------------------------------------------------------
# Stuck-at faults (paper §VI-G3)
# ---------------------------------------------------------------------------

def stuck_at_faults(rng: torch.Tensor, g: torch.Tensor, rate: float,
                    model: NoiseModel = DEFAULT
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inject SAFs: each cell sticks (p=rate) at g_min or g_max (50/50).
    Returns (faulty_g, fault_mask)."""
    try:
        r = float(rate)
    except (TypeError, RuntimeError):
        r = None                    # not a scalar: cannot validate here
    if r is not None and not (0.0 <= r <= 1.0):
        # bernoulli would clip (or NaN-propagate) a bad probability into a
        # silently wrong fault pattern — reject it with the actual value
        raise ValueError(
            f"stuck_at_faults rate={rate!r} must be a probability in "
            f"[0, 1]")
    k1, k2 = prng.split(rng.to(g.device))
    mask = prng.bernoulli(k1, rate, g.shape)
    high = prng.bernoulli(k2, 0.5, g.shape)
    stuck = torch.where(high, model.g_max, model.g_min).to(g.dtype)
    return torch.where(mask, stuck, g), mask

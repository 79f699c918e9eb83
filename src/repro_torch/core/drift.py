"""Time-evolving device model: conductance drift + stuck-at-fault arrivals
(port of ``repro.core.drift``).

``core.noise.NoiseModel`` captures the chip at a single instant — one
programming event, one read.  This module adds the *time axis* that field
deployments fight: programmed conductances relax toward their low state as
a power law of time-since-programming,

    G(t) = G_prog * ((t - t_prog + t0) / t0) ** (-nu)          (drift)

(the +t0 shift pins the factor to 1 at the programming instant), and
individual cells fail permanently as a per-cell Poisson arrival process:
cell i sticks at g_min or g_max (50/50) at the first arrival time of a
rate-``fault_rate`` process started at device birth — exponentially
distributed, drawn once per cell from the device seed, and *surviving
reprogramming* (a stuck cell cannot be rewritten).

Everything runs on a **virtual clock**: time is an explicit argument, no
wall-clock reads anywhere, so a simulated days-long serve trace is
bit-reproducible from its seed (``launch/fidelity.py`` advances the clock
per engine tick).

The state of :func:`program_params` mirrors a parameter tree: each weight
leaf becomes a cell-state dict marked by its ``"g_prog"`` key — programmed
conductances (float32), the sign channel (int8: -1, 0, 1 are exact, so
every comparison and product is the reference's float32 sign's), the
weight <-> conductance scale ``w_max`` (0-d float32), per-cell fault
arrival times (float32) and stuck polarities (bool): 10 bytes a weight.
Leaves are taken in ``jax.tree.flatten`` order (sorted dict keys at every
level), so each leaf draws the reference's keys.

Full-width trees are large (Qwen2.5-3B's stacked MLP gate leaf alone has
811.6M weights), so every pass walks a leaf in chunks of ``CHUNK`` flat
elements: the threefry draws take a counter offset (``prng``), which keeps
each chunk's draws bit for bit those of the whole-leaf draw, and the
elementwise maps give the same bits in any chunking.  No pass holds more
than a chunk's temporaries.  Two deliberate differences from ``repro``:

* :func:`reprogram_params` rewrites the state in place (the reference
  builds a second state tree), and :func:`read_params` can write the aged
  weights into an existing tree (``out=``, in its leaves' dtypes — the
  drafter's serving copy) instead of returning a new float32 one;
* under a noise model with ``scale == 0`` (IDEAL, the default) programming
  skips its normal draws: ``g_target + 0 * n`` is ``g_target`` for every
  finite ``n``, and the reference's normals are finite (their uniforms
  never reach +-1).  Every leaf's key is split beforehand, so no other
  draw moves.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..launch import prng
from .noise import IDEAL, NoiseModel

#: flat elements per chunk of a leaf in every pass (64 MB of float32)
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class DriftModel:
    """Power-law conductance drift + Poisson SAF arrivals over virtual time.

    ``nu``          drift exponent (0 disables drift).
    ``t0``          reference time of the power law, virtual seconds; the
                    drift factor is 1 at t - t_prog = 0 and
                    ``2 ** -nu`` at t - t_prog = t0.
    ``fault_rate``  per-cell Poisson SAF arrival rate, 1 / virtual second
                    (0 disables faults).
    ``noise``       the instantaneous :class:`NoiseModel` used for
                    program-and-verify (and optional read fluctuation);
                    defaults to IDEAL so drift/SAF effects are isolated.
    ``verify_passes``  programming attempts per cell; the closest-to-target
                    attempt wins.
    """

    nu: float = 0.1
    t0: float = 1.0
    fault_rate: float = 0.0
    noise: NoiseModel = IDEAL
    verify_passes: int = 1

    def __post_init__(self):
        for name in ("nu", "t0", "fault_rate"):
            v = getattr(self, name)
            if not (isinstance(v, (int, float)) and math.isfinite(v)):
                raise ValueError(f"DriftModel.{name}={v!r} must be a finite "
                                 f"number")
        if self.nu < 0:
            raise ValueError(f"DriftModel.nu={self.nu} must be >= 0")
        if self.t0 <= 0:
            raise ValueError(f"DriftModel.t0={self.t0} must be > 0")
        if self.fault_rate < 0:
            raise ValueError(
                f"DriftModel.fault_rate={self.fault_rate} must be >= 0 "
                f"(per-cell arrivals per virtual second)")
        if self.verify_passes < 1:
            raise ValueError(
                f"DriftModel.verify_passes={self.verify_passes} must be >= 1")

    def drift_factor(self, dt) -> float:
        """Conductance retention factor after ``dt`` virtual seconds since
        programming: 1 at dt <= 0, decaying as ((dt + t0)/t0) ** -nu, in
        float32 as the reference's ``jit`` rounds it (the division by the
        constant ``t0`` is a multiply by its float32 reciprocal)."""
        f32 = np.float32
        dt = max(f32(dt), f32(0.0))
        base = (dt + f32(self.t0)) * f32(f32(1.0) / f32(self.t0))
        return float(torch.pow(torch.tensor(base, dtype=torch.float32),
                               torch.tensor(f32(-self.nu))))


def _is_cell_state(x) -> bool:
    return isinstance(x, dict) and "g_prog" in x


def flatten(tree, is_leaf=None) -> list:
    """``(path, leaf)`` pairs in ``jax.tree.flatten`` order: the keys of a
    dict sorted at every level (``path`` is the tuple of keys)."""
    out = []
    _walk(tree, (), out, is_leaf)
    return out


def _walk(x, path: tuple, out: list, is_leaf) -> None:
    # a module-level recursion: a nested one would close over ``out`` in
    # a function <-> cell cycle, which keeps every leaf alive until the
    # cyclic collector runs (gigabytes of masters and moments on the card)
    if isinstance(x, dict) and not (is_leaf and is_leaf(x)):
        for k in sorted(x):
            _walk(x[k], path + (k,), out, is_leaf)
    else:
        out.append((path, x))


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _leaf_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """One independent key per leaf, in flatten order: (n, 2)."""
    return prng.split(key, n)


def _chunks(n: int):
    for o in range(0, n, CHUNK):
        yield o, min(CHUNK, n - o)


def _program_and_verify(key: torch.Tensor, g_target: torch.Tensor,
                        model: DriftModel, offset: int) -> torch.Tensor:
    """``verify_passes`` programming attempts, closest-to-target wins
    (IDEAL noise: ``g_target`` itself, the draws skipped)."""
    if model.noise.scale == 0:
        return g_target
    g = model.noise.program(key, g_target, offset=offset)
    for i in range(1, model.verify_passes):
        cand = model.noise.program(prng.fold_in(key, i), g_target,
                                   offset=offset)
        g = torch.where(torch.abs(cand - g_target) < torch.abs(g - g_target),
                        cand, g)
    return g


class _Targets:
    """One weight leaf mapped onto target conductances chunk by chunk:
    ``target`` turns a chunk of the leaf into the weights to program (the
    identity, or the log-grid quantizer over a float32 master), ``w_max``
    is the largest |weight| over the whole leaf (one pass first)."""

    def __init__(self, w: torch.Tensor, model: DriftModel, target):
        n = model.noise
        self.flat = w.reshape(-1)
        self.target = target
        self.n = n
        amax = torch.zeros((), dtype=torch.float32, device=w.device)
        for o, m in _chunks(self.flat.numel()):
            amax = torch.maximum(amax, torch.abs(self.chunk(o, m)).max())
        self.w_max = torch.clamp(amax, min=1e-6)
        self.ratio = torch.div(
            torch.tensor(np.float32(n.g_max - n.g_min), device=w.device),
            self.w_max)

    def chunk(self, o: int, m: int) -> torch.Tensor:
        x = self.flat[o:o + m].to(torch.float32)
        return x if self.target is None else self.target(x)

    def cells(self, o: int, m: int):
        """(g_target, sign) of flat elements [o, o + m)."""
        w = self.chunk(o, m)
        g = torch.abs(w).mul_(self.ratio).add_(self.n.g_min)
        return g.clamp_(self.n.g_min, self.n.g_max), torch.sign(w)


def program_params(key: torch.Tensor, qparams, model: DriftModel,
                   t: float = 0.0, *, target=None) -> dict:
    """Program every leaf of ``qparams`` (the drafter's weights, or with
    ``target`` a tree that ``target`` maps chunk by chunk onto them) onto
    crossbar conductances at virtual time ``t``.

    Returns the device state ``{"cells": tree, "t_prog": float32 t}``:
    ``qparams``' structure with each leaf replaced by a cell-state dict on
    the leaf's device.  Fault arrival times are drawn here, once, from the
    *birth* of the device — they belong to the cells, not to a programming
    pass, so :func:`reprogram_params` carries them forward unchanged.
    """
    fkey, pkey = prng.split(key)
    leaves = flatten(qparams)
    fkeys = _leaf_keys(fkey, len(leaves))
    pkeys = _leaf_keys(pkey, len(leaves))
    cells: dict = {}
    for (path, w), fk, pk in zip(leaves, fkeys, pkeys):
        tg = _Targets(w, model, target)
        k1, k2 = (k.to(w.device) for k in prng.split(fk))
        n, dev = w.numel(), w.device
        st = {"g_prog": torch.empty(n, dtype=torch.float32, device=dev),
              "sign": torch.empty(n, dtype=torch.int8, device=dev),
              "w_max": tg.w_max,
              "t_fault": torch.empty(n, dtype=torch.float32, device=dev),
              "stuck_hi": torch.empty(n, dtype=torch.bool, device=dev)}
        rate = (torch.tensor(np.float32(model.fault_rate), device=dev)
                if model.fault_rate > 0 else None)
        for o, m in _chunks(n):
            g_target, sign = tg.cells(o, m)
            st["sign"][o:o + m] = sign
            st["g_prog"][o:o + m] = _program_and_verify(pk, g_target, model,
                                                        o)
            if rate is None:
                st["t_fault"][o:o + m] = math.inf
            else:
                st["t_fault"][o:o + m] = torch.div(
                    prng.exponential(k1, (m,), offset=o), rate)
            st["stuck_hi"][o:o + m] = prng.bernoulli(k2, 0.5, (m,), offset=o)
        for name in ("g_prog", "sign", "t_fault", "stuck_hi"):
            st[name] = st[name].view(w.shape)
        _put(cells, path, st)
    return {"cells": cells, "t_prog": float(np.float32(t))}


def reprogram_params(key: torch.Tensor, state: dict, qparams,
                     model: DriftModel, t, *, target=None) -> dict:
    """One field reprogramming pass at virtual time ``t``: every cell is
    rewritten to its target through a fresh program-and-verify draw and the
    drift clock resets (``t_prog = t``) — but the fault record is carried
    over untouched: stuck cells stay stuck, which is why acceptance
    recovers to a slightly lower peak after every pass as SAFs accumulate.
    Rewrites ``state`` in place and returns it.
    """
    leaves = flatten(qparams)
    pkeys = _leaf_keys(key, len(leaves))
    for (path, w), pk in zip(leaves, pkeys):
        st = _at(state["cells"], path)
        tg = _Targets(w, model, target)
        g_prog, sign = st["g_prog"].view(-1), st["sign"].view(-1)
        for o, m in _chunks(w.numel()):
            g_target, s = tg.cells(o, m)
            sign[o:o + m] = s
            g_prog[o:o + m] = _program_and_verify(pk, g_target, model, o)
        st["w_max"] = tg.w_max
    state["t_prog"] = float(np.float32(t))
    return state


def read_params(state: dict, model: DriftModel, t,
                read_key: torch.Tensor | None = None, *, out=None):
    """The drafter's effective weights at virtual time ``t``: drift the
    programmed conductances, overwrite faulted cells with their stuck
    level, optionally add one read-fluctuation draw (``read_key``), and map
    back to weight space.  Returns a new float32 tree, or with ``out`` (a
    tree of the same structure) writes each leaf into it in the leaf's
    dtype and returns ``out``."""
    n = model.noise
    t = float(np.float32(t))
    factor = model.drift_factor(np.float32(t) - np.float32(state["t_prog"]))
    leaves = flatten(state["cells"], is_leaf=_is_cell_state)
    rkeys = (_leaf_keys(read_key, len(leaves)) if read_key is not None
             else None)
    result = {} if out is None else out
    for i, (path, st) in enumerate(leaves):
        shape, dev = st["g_prog"].shape, st["g_prog"].device
        if out is None:
            dst = torch.empty(shape, dtype=torch.float32, device=dev)
            _put(result, path, dst)
        else:
            dst = _at(out, path)
        ratio = torch.div(
            torch.tensor(np.float32(n.g_max - n.g_min), device=dev),
            st["w_max"])
        flat = {k: st[k].view(-1) for k in ("g_prog", "sign", "t_fault",
                                           "stuck_hi")}
        dst_flat = dst.view(-1)
        for o, m in _chunks(dst_flat.numel()):
            g = flat["g_prog"][o:o + m] * factor
            if rkeys is not None:
                g = n.read(rkeys[i], g, offset=o)
            faulty = flat["t_fault"][o:o + m] <= t
            high = faulty & flat["stuck_hi"][o:o + m]
            g.masked_fill_(faulty, n.g_min).masked_fill_(high, n.g_max)
            g.clamp_(n.g_min, n.g_max).sub_(n.g_min)
            w = g.div_(ratio)      # one IEEE division (0-d divisor)
            # a stuck-high cell reads at full magnitude even where the
            # target weight was an exact 0 (sign channel 0): positive
            sign = flat["sign"][o:o + m]
            s = sign.to(torch.float32).masked_fill_(high & (sign == 0), 1.0)
            dst_flat[o:o + m] = w.mul_(s)
    return result


def fault_fraction(state: dict, t) -> float:
    """Fraction of cells faulted by virtual time ``t`` (telemetry), rounded
    as the reference's float32 division of the counts rounds it."""
    t = float(np.float32(t))
    faulted = total = 0
    for _, st in flatten(state["cells"], is_leaf=_is_cell_state):
        faulted += int((st["t_fault"] <= t).sum())
        total += st["t_fault"].numel()
    return float(np.float32(faulted) / np.float32(max(total, 1)))


def state_bytes(state: dict) -> int:
    """Device bytes the cell state holds."""
    return sum(v.numel() * v.element_size()
               for _, st in flatten(state["cells"], is_leaf=_is_cell_state)
               for v in st.values())

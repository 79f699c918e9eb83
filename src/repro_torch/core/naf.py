"""Noise-Aware Fine-tuning (port of ``repro.core.naf``: paper §IV-B, Fig 8).

Four steps, all software-side, pre-deployment:

  (1) crossbar NAF   — a few end-to-end fine-tuning iterations with Eq 6
                       noise injected into Conv/Linear weights, loss Eq 8
                       (MSE + lambda1*||W||_inf + lambda2*||eps||_inf);
                       ``launch/train.py`` runs it with ``naf=True``.
  (2) extraction     — non-VMM ops -> single-variable functions, outputs
                       quantized (``dt.build_table``).
  (3) DT training    — per-bit threshold DTs (``dt.py`` builds them).
  (4) ACAM NAF       — per-DT threshold fine-tuning through the
                       differentiable surrogate (Algorithm 1) with ACAM
                       cell noise injected each iteration
                       (``finetune_table``).

Keys follow the reference's: ``finetune_table`` splits ``k_eval, rng``
from its key, then ``rng, k`` every step and ``noise_draws`` keys from
``k`` inside the loss; ``inject_crossbar_noise`` splits one key per leaf
in ``jax.tree.flatten`` order (sorted dict keys, ``core.drift.flatten``).
Samples, evaluation points and permutations come from
``np.random.default_rng(0)``, ``(1)`` and ``(epoch)``.

Eq 6 draws at full width walk a leaf in ``core.drift.CHUNK``-element
chunks with counter offsets (``prng``), bit for bit the whole-leaf draw;
``w_max`` is the largest |weight| of the whole (stacked) leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..launch import prng
from .differentiable import (DiffACAMConfig, _thresholds_through_cells,
                             diff_acam_forward, hard_acam_forward,
                             soft_gray_bits)
from .drift import _chunks, flatten
from .dt import ACAMTable
from .functions import FUNCTIONS
from .noise import DEFAULT, IDEAL, NoiseModel, g_to_weight, weight_to_g


# ---------------------------------------------------------------------------
# Minimal Adam (the reference's own, not optax's)
# ---------------------------------------------------------------------------

def adam_init(params: dict) -> dict:
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adam_update(grads: dict, state: dict, params: dict, lr: float = 1e-3,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step over flat dicts of tensors -> (params, state), new
    tensors as the reference returns them."""
    step = state["step"] + 1
    sf = step.to(torch.float32)
    c1 = 1 - torch.pow(sf.new_tensor(np.float32(b1)), sf)
    c2 = 1 - torch.pow(sf.new_tensor(np.float32(b2)), sf)
    m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * state["v"][k] + (1 - b2) * g * g for k, g in grads.items()}
    out = {k: p - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
           for k, p in params.items()}
    return out, {"m": m, "v": v, "step": step}


# ---------------------------------------------------------------------------
# Step 4: per-DT ACAM noise-aware fine-tuning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NAFResult:
    table: ACAMTable
    mse_before: float          # noisy eval, pre-NAF thresholds
    mse_after: float           # noisy eval, post-NAF thresholds
    mse_clean: float           # noise-free eval of the original table
    epochs: int
    history: list


def _quantized_target(fn, xs: np.ndarray, spec) -> np.ndarray:
    """Output levels of the quantized digital function at ``xs``."""
    f = np.asarray(fn(xs), np.float64)
    return np.clip(np.round((f - spec.lo) / spec.step), 0,
                   spec.levels - 1).astype(np.int64)


def naf_loss(p: dict, key: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
             gb: torch.Tensor, *, cfg: DiffACAMConfig, model: NoiseModel,
             noise_draws: int, objective: str, beta: float,
             bit_w: torch.Tensor, out_lo: float,
             out_step: float) -> torch.Tensor:
    """``finetune_table``'s training loss over ``noise_draws`` noise
    realizations (the keys split from ``key``): per-bit value-weighted
    Gray-bit errors (``per_bit``) or the value MSE of Algorithm 1
    (``alg1``)."""
    losses = []
    for k in prng.split(key, noise_draws):
        if objective == "per_bit":
            sb = soft_gray_bits(xb, p["lo"], p["hi"], rng=k, cfg=cfg,
                                model=model, beta=beta)
            losses.append(torch.mean(torch.sum(bit_w * (sb - gb) ** 2,
                                               dim=-1)))
        else:
            y = diff_acam_forward(xb, p["lo"], p["hi"], rng=k, cfg=cfg,
                                  model=model, out_lo=out_lo,
                                  out_step=out_step)
            losses.append(torch.mean((y - yb) ** 2))
    return torch.mean(torch.stack(losses))


def finetune_table(table: ACAMTable,
                   target_fn: Callable | None = None,
                   rng: torch.Tensor | None = None,
                   model: NoiseModel = DEFAULT,
                   epochs: int = 10,
                   samples: int = 5000,
                   batch: int = 512,
                   lr: float = 5e-3,
                   noise_draws: int = 4,
                   objective: str = "per_bit",
                   beta: float = 20.0,
                   device=None) -> NAFResult:
    """NAF step 4 for one DT (one function), on ``device`` (the GPU
    unless ``device="cpu"``).

    Trains the (bits, rows) lo/hi threshold tensors so that the *noisy*
    hard ACAM matches the quantized target; evaluation uses the hard
    forward (kernel D on the card) with fresh noise.  Objectives:
    ``per_bit`` (default: each bit-plane a value-weighted binary
    classifier against its Gray bit, ``soft_gray_bits``) and ``alg1`` (the
    paper's Algorithm 1 verbatim, value MSE through
    ``diff_acam_forward``)."""
    if objective not in ("per_bit", "alg1"):
        raise ValueError(f"unknown NAF objective {objective!r}")
    dev = resolve_device(device)
    if rng is None:
        rng = prng.prng_key(0)
    rng = rng.to(dev)
    if target_fn is None:
        target_fn = FUNCTIONS[table.name].fn
    lo_x, hi_x = table.in_domain
    cfg = DiffACAMConfig(bits=table.bits, th_lo=float(lo_x),
                         th_hi=float(hi_x))

    xs = np.random.default_rng(0).uniform(lo_x, hi_x, size=samples).astype(
        np.float32)
    # target = the quantized digital function — independent of the current
    # (possibly corrupted) thresholds, so NAF can repair persistent damage
    spec = table.out_spec
    levels = _quantized_target(target_fn, xs, spec)
    y_ref = (levels * spec.step + spec.lo).astype(np.float32)
    gray = levels ^ (levels >> 1)
    gray_bits = ((gray[:, None] >> np.arange(table.bits)) & 1).astype(
        np.float32)
    xs_t = torch.from_numpy(xs).to(dev)
    y_t = torch.from_numpy(y_ref).to(dev)
    gb_t = torch.from_numpy(gray_bits).to(dev)

    params = {"lo": torch.from_numpy(np.array(table.lo, np.float32)).to(dev),
              "hi": torch.from_numpy(np.array(table.hi, np.float32)).to(dev)}
    out_lo, out_step = float(spec.lo), float(spec.step)
    bit_w = torch.tensor([4.0 ** i for i in range(table.bits)],
                         dtype=torch.float32, device=dev)
    bit_w = bit_w / torch.sum(bit_w)
    loss_kw = dict(cfg=cfg, model=model, noise_draws=noise_draws,
                   objective=objective, beta=beta, bit_w=bit_w,
                   out_lo=out_lo, out_step=out_step)

    def train_step(p, st, key, xb, yb, gb):
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = naf_loss(p, key, xb, yb, gb, **loss_kw)
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        p, st = adam_update(g, st, {k: v.detach() for k, v in p.items()},
                            lr=lr)
        return p, st, loss.detach()

    xe_np = np.random.default_rng(1).uniform(lo_x, hi_x, 2048).astype(
        np.float32)
    ye_np = (_quantized_target(target_fn, xe_np, spec) * spec.step
             + spec.lo).astype(np.float32)
    xe, ye = torch.from_numpy(xe_np).to(dev), torch.from_numpy(ye_np).to(dev)

    def hard_mse(p, key, draws=8):
        vals = [torch.mean((hard_acam_forward(
            xe, p["lo"], p["hi"], rng=k, cfg=cfg, model=model,
            out_lo=out_lo, out_step=out_step) - ye) ** 2)
            for k in prng.split(key, draws)]
        return float(torch.mean(torch.stack(vals)))

    # paired evaluation: before/after/history share one eval key so the
    # comparison is not washed out by draw-to-draw variance
    k_eval, rng = prng.split(rng)
    mse_before = hard_mse(params, k_eval)
    mse_clean = hard_mse(params, k_eval, draws=1) if model.scale == 0 else \
        float(torch.mean((hard_acam_forward(
            xs_t, params["lo"], params["hi"], cfg=cfg, model=IDEAL,
            out_lo=out_lo, out_step=out_step) - y_t) ** 2))

    st = adam_init(params)
    history = []
    steps_per_epoch = max(1, samples // batch)
    for e in range(epochs):
        perm = np.random.default_rng(e).permutation(samples)
        ep_loss = 0.0
        for s in range(steps_per_epoch):
            idx = torch.from_numpy(perm[s * batch:(s + 1) * batch]).to(dev)
            rng, k = prng.split(rng)
            params, st, loss = train_step(params, st, k, xs_t[idx], y_t[idx],
                                          gb_t[idx])
            ep_loss += float(loss)
        history.append({"epoch": e, "train_loss": ep_loss / steps_per_epoch,
                        "hard_mse": hard_mse(params, k_eval)})
    mse_after = hard_mse(params, k_eval)

    new_table = dataclasses.replace(
        table, lo=params["lo"].cpu().numpy(), hi=params["hi"].cpu().numpy())
    return NAFResult(table=new_table, mse_before=mse_before,
                     mse_after=mse_after, mse_clean=mse_clean,
                     epochs=epochs, history=history)


def corrupt_table(table: ACAMTable, rng: torch.Tensor,
                  model: NoiseModel = DEFAULT, device=None) -> ACAMTable:
    """Bake ONE persistent programming realization into the thresholds
    (on ``device``, the GPU unless ``device="cpu"``).

    This is the deployed-device state the paper's Table III row
    "(3) + ACAM noise" measures: a concrete noisy programming pass, fixed
    for the lifetime of the chip (read fluctuation still varies per read).
    NAF step 4 then repairs it in software before (re)programming.
    """
    dev = resolve_device(device)
    cfg = DiffACAMConfig(bits=table.bits, th_lo=float(table.in_domain[0]),
                         th_hi=float(table.in_domain[1]))
    prog_only = dataclasses.replace(model, b_fluct=-30.0)  # fluct sigma ~ 0
    k1, k2 = prng.split(rng.to(dev))
    with torch.no_grad():
        lo = _thresholds_through_cells(
            k1, torch.from_numpy(np.array(table.lo, np.float32)).to(dev),
            cfg, prog_only)
        hi = _thresholds_through_cells(
            k2, torch.from_numpy(np.array(table.hi, np.float32)).to(dev),
            cfg, prog_only)
    return dataclasses.replace(table, lo=lo.cpu().numpy(),
                               hi=hi.cpu().numpy())


# ---------------------------------------------------------------------------
# Step 1: crossbar NAF loss (Eq 8) — pieces used by the training substrate
# ---------------------------------------------------------------------------

def eq8_regularizers(params, eps_tree=None):
    """(||W||_inf, ||eps||_inf) over a parameter tree (the lambdas of
    Eq 8 are applied by ``optim/naf_loss.py``)."""
    def inf(tree):
        leaves = [torch.max(torch.abs(x)) for _, x in flatten(tree)]
        return (torch.max(torch.stack(leaves)) if leaves
                else torch.tensor(0.0))
    w_inf = inf(params)
    if eps_tree is None:
        return w_inf, torch.tensor(0.0, device=w_inf.device)
    return w_inf, inf(eps_tree)


def leaf_keys(rng: torch.Tensor, tree) -> list:
    """Per leaf of ``tree`` in flatten order: its four Eq 6 keys
    ``(program +, read +, program -, read -)``, as ``inject_crossbar_noise``
    splits them (one key per leaf, then one per polarity, then
    ``readout``'s program/read split)."""
    keys = prng.split(prng.split(prng.split(rng, len(flatten(tree)))))
    return [(k[0, 0], k[0, 1], k[1, 0], k[1, 1]) for k in keys]


def leaf_amax(w: torch.Tensor) -> torch.Tensor:
    """``max|w|`` over the whole leaf as a 0-d float32 tensor on its
    device (chunk by chunk); ``w_max`` is this clamped to at least
    1e-6."""
    flat = w.reshape(-1)
    amax = torch.zeros((), dtype=torch.float32, device=w.device)
    for o, m in _chunks(flat.numel()):
        amax = torch.maximum(amax, flat[o:o + m].float().abs().max())
    return amax


def noisy_chunk(keys: tuple, w: torch.Tensor, w_max: torch.Tensor,
                model: NoiseModel, offset: int) -> torch.Tensor:
    """Eq 6 round trip of a chunk ``w`` of a leaf (flat elements from
    ``offset``): both polarities through program-then-read cells, the
    draws at the chunk's counters.  Differentiable in ``w`` and
    ``w_max``."""
    kp1, kr1, kp2, kr2 = keys

    def cell(kp, kr, x):
        g = weight_to_g(x, w_max, model)
        g = model.read(kr, model.program(kp, g, offset=offset),
                       offset=offset)
        return g_to_weight(g, w_max, model)

    zero = w.new_zeros(())
    return cell(kp1, kr1, torch.maximum(w, zero)) \
        - cell(kp2, kr2, torch.maximum(-w, zero))


def inject_crossbar_noise(rng: torch.Tensor, params,
                          model: NoiseModel = DEFAULT,
                          w_max: float | None = None):
    """NAF step-1 weight perturbation through Eq 6 cells: each leaf is
    split into +/- polarities, round-tripped through noisy conductances
    and recombined — how the crossbar stores it.  ``w_max`` (a host
    float) fixes the weight <-> conductance scale; by default each leaf
    takes its own largest |weight|.  Returns a new tree of the leaves'
    dtypes (chunk by chunk, no graph)."""
    out = []
    with torch.no_grad():
        for (_, w), keys in zip(flatten(params), leaf_keys(rng, params)):
            keys = tuple(k.to(w.device) for k in keys)
            wm = (torch.clamp(leaf_amax(w), min=1e-6) if w_max is None
                  else float(w_max))
            flat = w.reshape(-1)
            res = torch.empty_like(flat)
            for o, m in _chunks(flat.numel()):
                res[o:o + m] = noisy_chunk(keys, flat[o:o + m].float(), wm,
                                           model, o).to(w.dtype)
            out.append(res.view(w.shape))
    return unflatten(params, out)


def unflatten(tree, leaves: list):
    """``tree``'s structure with its leaves (flatten order) replaced by
    ``leaves``."""
    return _build(tree, iter(leaves))


def _build(x, it):
    # module-level, as ``drift._walk``: a nested recursion would hold the
    # leaves' iterator in a reference cycle
    if isinstance(x, dict):
        built = {k: _build(x[k], it) for k in sorted(x)}
        return {k: built[k] for k in x}
    return next(it)

"""Noisy crossbar VMM simulation (port of ``repro.core.crossbar``, paper
§II-A, §IV-B).

The analog pipeline per crossbar pass:

  x --DAC(8b)--> word-line voltages --Kirchhoff--> bit-line currents
    = V_read * x . (G+ - G-)  (+ A-SL residual cells / 10)

simulated at the weight level: the cells of a ``SlicedWeights`` plan are
read with Eq 6 noise, converted back to effective weights, and the VMM is
a matmul of the (optionally DAC-quantized) input against the effective
weight.  ``dac_slices > 1`` keeps one analog pass per input bit slice,
each with its own read-noise realization.  The deterministic fused inner
loop is ``kernels/crossbar_vmm`` (kernel E); this module is the
stochastic wrapper around the plain matmul, as in the reference.
"""
from __future__ import annotations

import torch

from ..launch import prng
from .noise import DEFAULT, NoiseModel, true_div
from .quantization import QuantSpec
from .slicing import SlicedWeights, effective_weight, plan_asl


def program_linear(w: torch.Tensor, rng: torch.Tensor | None = None,
                   model: NoiseModel = DEFAULT
                   ) -> tuple[SlicedWeights, torch.Tensor]:
    """Program a weight matrix with analog slicing; returns (plan, eps).
    ``w_max`` is fetched to the host as a float, as the reference takes
    it, so the conductance map follows its double-precision ``g_ratio``."""
    w_max = float(torch.amax(torch.abs(w)))
    if w_max == 0.0:
        w_max = 1.0
    return plan_asl(w, w_max, model, prog_rng=rng)


def _quantize_input(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """The reference's eager ``QuantSpec.quantize``: a true division by
    the step (``QuantSpec`` itself follows ``jit``'s reciprocal)."""
    q = torch.round(true_div(x - spec.lo, spec.step))
    return torch.clamp(q, 0, spec.levels - 1).to(torch.int32)


def _apply_input(x: torch.Tensor, spec: QuantSpec | None) -> torch.Tensor:
    if spec is None:
        return x
    return spec.dequantize(_quantize_input(x, spec))


def crossbar_vmm(x: torch.Tensor, plan: SlicedWeights,
                 rng: torch.Tensor | None = None,
                 model: NoiseModel = DEFAULT,
                 input_spec: QuantSpec | None = None,
                 dac_slices: int = 1,
                 saf_rate: float = 0.0) -> torch.Tensor:
    """y = DAC(x) @ W_eff with per-pass read noise.

    ``dac_slices > 1`` reproduces the hardware's repeated analog passes
    (one per input bit slice, key ``fold_in(rng, s)``), recombined by
    shift-and-add; ``dac_slices = 1`` is the fused fast path."""
    xq = _apply_input(x, input_spec)
    if dac_slices <= 1 or rng is None:
        return xq @ effective_weight(plan, rng, model, saf_rate)

    if input_spec is None:
        raise ValueError("per-slice mode needs an input QuantSpec")
    bits = input_spec.bits
    if bits % dac_slices:
        raise ValueError(f"dac_slices={dac_slices} must divide the "
                         f"input's {bits} bits")
    k = bits // dac_slices
    code = _quantize_input(x, input_spec)
    out = None
    for s in range(dac_slices):
        digit = (code >> (s * k)) & ((1 << k) - 1)
        w_eff = effective_weight(plan, prng.fold_in(rng, s), model, saf_rate)
        y_s = (digit.to(torch.float32) @ w_eff) * float(1 << (s * k))
        out = y_s if out is None else out + y_s
    # undo the code scaling x = code * step + lo (the last pass's W_eff
    # stands in for the offset's weights, as in the reference)
    y = out * input_spec.step
    offset = torch.sum(w_eff, dim=0) * input_spec.lo
    return y + offset


def ideal_vmm(x: torch.Tensor, w: torch.Tensor,
              input_spec: QuantSpec | None = None) -> torch.Tensor:
    """Digital reference at matching input quantization."""
    return _apply_input(x, input_spec) @ w

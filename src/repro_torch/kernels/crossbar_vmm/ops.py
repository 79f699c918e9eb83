"""Crossbar VMM wrapper (port of ``repro.kernels.crossbar_vmm.ops``): a
``SlicedWeights`` plan -> one noisy A-SL crossbar pass, the CUDA kernel
``csrc/crossbar_vmm.cu`` for CUDA tensors, the plain version (``ref.py``)
for CPU tensors.

Read noise is drawn here, outside the kernel, with the reference's keys
(``split(rng, 4)``, one per cell matrix), so the kernel is deterministic.
``inv = 1 / g_ratio`` is the reference's host double from the plan's float
``w_max``, rounded to float32 once where it meets the cells.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.noise import DEFAULT, NoiseModel
from ...core.quantization import recip
from ...core.slicing import RESIDUAL_GAIN, SlicedWeights
from ...launch import prng
from .. import build
from .ref import crossbar_vmm_ref


def _lib():
    lib = build.load("crossbar_vmm")
    if not getattr(lib, "_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.crossbar_vmm_launch.argtypes = [vp] * 6 + [i, i, i, f, f, vp]
        lib.crossbar_vmm_launch.restype = i
        lib.crossbar_vmm_variant.argtypes = [i, i]
        lib.crossbar_vmm_variant.restype = i
        lib._typed = True
    return lib


def inv_g_ratio(plan: SlicedWeights, model: NoiseModel = DEFAULT) -> float:
    """``1 / ((g_max - g_min) / w_max)`` in doubles, as the reference's
    wrapper computes it, rounded to float32."""
    if isinstance(plan.w_max, torch.Tensor):
        raise TypeError("crossbar_matmul needs a plan with a host-float "
                        "w_max (core.crossbar.program_linear's)")
    return float(np.float32(1.0 / ((model.g_max - model.g_min)
                                   / plan.w_max)))


def crossbar_vmm(x: torch.Tensor, g_pos: torch.Tensor, g_neg: torch.Tensor,
                 g_pos_res: torch.Tensor, g_neg_res: torch.Tensor,
                 inv: float, res_gain: float = RESIDUAL_GAIN
                 ) -> torch.Tensor:
    """x @ W_eff: x (M, K) float32, cells (K, N) float32, ``inv`` a host
    float -> (M, N) float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise — there is no fallback)."""
    cells = (g_pos, g_neg, g_pos_res, g_neg_res)
    if x.device.type == "cpu":
        return crossbar_vmm_ref(x, *cells, inv, res_gain)
    m, k = x.shape
    n = g_pos.shape[1]
    if any(t.dtype != torch.float32 for t in (x, *cells)):
        raise TypeError("crossbar_vmm: every operand must be float32")
    if any(t.device != x.device for t in cells):
        raise ValueError("crossbar_vmm: all operands on one device")
    if any(g.shape != (k, n) for g in cells) or min(m, n, k) < 1:
        raise ValueError(f"crossbar_vmm: shapes x {tuple(x.shape)}, cells "
                         f"{[tuple(g.shape) for g in cells]}")
    x = x.contiguous()
    cells = tuple(g.contiguous() for g in cells)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _lib().crossbar_vmm_launch(
        x.data_ptr(), *(g.data_ptr() for g in cells), out.data_ptr(), m, n,
        k, recip(res_gain), inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "crossbar_vmm")
    crossbar_vmm.launches += 1
    return out


crossbar_vmm.launches = 0


def tile_variant(m: int, n: int) -> str:
    """The tile (``xbar::choose``) kernel E launches at (M, N)."""
    return build.TILE_VARIANTS[_lib().crossbar_vmm_variant(m, n)]


def read_cells(plan: SlicedWeights, rng: torch.Tensor | None,
               model: NoiseModel = DEFAULT) -> list[torch.Tensor]:
    """The plan's four cell matrices after one read (Eq 6 fluctuation,
    keys ``split(rng, 4)``); the programmed cells when ``rng`` is None."""
    if rng is None:
        return plan.cells
    return [model.read(k, g) for k, g in zip(prng.split(rng, 4), plan.cells)]


def crossbar_matmul(x: torch.Tensor, plan: SlicedWeights,
                    rng: torch.Tensor | None = None,
                    model: NoiseModel = DEFAULT) -> torch.Tensor:
    """y = x @ W_eff with optional per-call read noise on the plan's cells.
    x (M, K) is upcast to float32; the plan's cells are (K, N)."""
    return crossbar_vmm(x.to(torch.float32), *read_cells(plan, rng, model),
                        inv_g_ratio(plan, model), RESIDUAL_GAIN)

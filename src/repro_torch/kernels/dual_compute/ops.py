"""Fused dual-compute wrappers (port of ``repro.kernels.dual_compute.ops``).

* ``fused_crossbar_acam`` — plan level: four A-SL cell matrices + an ACAM
  table -> one fused pass; the CUDA kernel ``csrc/dual_compute.cu`` for
  CUDA tensors, the plain version (``ref.py``) for CPU tensors.
* ``fused_linear_acam`` — model level: a float32 weight is programmed to
  ideal A-SL conductances on every call (as ``repro`` does inside ``jit``;
  w_max stays a device scalar) and routed through ``fused_crossbar_acam``.
  This is what ``NLDPEConfig.linear_activation`` dispatches to under
  ``FUSED``.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.acam import get_table, table_thresholds
from ...core.noise import DEFAULT
from ...core.slicing import RESIDUAL_GAIN, plan_asl
from ...core.quantization import recip
from .. import build
from .ref import fused_crossbar_acam_ref


def _lib():
    lib = build.load("dual_compute")
    if not getattr(lib, "_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_crossbar_acam_launch.argtypes = [vp] * 9 + [
            i, i, i, f, i, i, f, f, vp]
        lib.fused_crossbar_acam_launch.restype = i
        lib.fused_crossbar_acam_smem_bytes.argtypes = [i, i]
        lib.fused_crossbar_acam_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def fused_crossbar_acam(x: torch.Tensor, g_pos: torch.Tensor,
                        g_neg: torch.Tensor, g_pos_res: torch.Tensor,
                        g_neg_res: torch.Tensor, inv_g_ratio: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor, *,
                        out_lo: float, out_step: float,
                        res_gain: float = RESIDUAL_GAIN) -> torch.Tensor:
    """acam(x @ W_eff): x (M, K) f32; cells (K, N) f32; inv_g_ratio a
    0-d/1-element f32 tensor on the device; lo/hi (bits, rows) f32 ->
    (M, N) f32.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise — there is no fallback)."""
    cells = (g_pos, g_neg, g_pos_res, g_neg_res)
    if x.device.type == "cpu":
        return fused_crossbar_acam_ref(x, *cells, inv_g_ratio, lo, hi,
                                       out_lo=out_lo, out_step=out_step,
                                       res_gain=res_gain)
    m, k = x.shape
    n = g_pos.shape[1]
    bits, rows = lo.shape
    operands = (x, *cells, inv_g_ratio, lo, hi)
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError("fused_crossbar_acam: every operand must be float32")
    if any(t.device != x.device for t in operands):
        raise ValueError("fused_crossbar_acam: all operands on one device")
    if any(g.shape != (k, n) for g in cells) or hi.shape != lo.shape \
            or inv_g_ratio.numel() != 1:
        raise ValueError("fused_crossbar_acam: shapes x (M, K), cells "
                         "(K, N), lo/hi (bits, rows), inv_g_ratio scalar")
    lib = _lib()
    if lib.fused_crossbar_acam_smem_bytes(bits, rows) > 227 * 1024:
        raise ValueError(f"fused_crossbar_acam: table {bits}x{rows} does "
                         f"not fit in shared memory")
    x = x.contiguous()
    cells = tuple(g.contiguous() for g in cells)
    inv = inv_g_ratio.reshape(1).contiguous()
    lo, hi = lo.contiguous(), hi.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = lib.fused_crossbar_acam_launch(
        x.data_ptr(), *(g.data_ptr() for g in cells), inv.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), out.data_ptr(), m, n, k,
        recip(res_gain), bits, rows, out_lo, out_step,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_crossbar_acam")
    fused_crossbar_acam.launches += 1
    return out


fused_crossbar_acam.launches = 0


def program(w: torch.Tensor):
    """Ideal A-SL programming of a float32 weight: (cells, inv_g_ratio),
    with w_max and inv computed on the weight's device."""
    w = w.to(torch.float32)
    w_max = torch.clamp(torch.amax(torch.abs(w)), min=1e-9)
    plan, _ = plan_asl(w, w_max, DEFAULT)
    inv = w_max * recip(DEFAULT.g_max - DEFAULT.g_min)
    return plan.cells, inv


def fused_linear_acam(x: torch.Tensor, w: torch.Tensor, act: str,
                      bits: int = 8) -> torch.Tensor:
    """act(x @ w) through an ideally programmed A-SL crossbar, fused.
    x (..., K) any leading shape, w (K, N) float32 -> (..., N) float32.
    Programming happens per call: four (K, N) float32 cell matrices are
    transient (caching the plan is later work)."""
    table = get_table(act, bits)
    cells, inv = program(w)
    lo, hi = table_thresholds(table, x.device)
    shape = x.shape
    out = fused_crossbar_acam(
        x.reshape(-1, shape[-1]).to(torch.float32), *cells, inv, lo, hi,
        out_lo=float(table.out_spec.lo), out_step=float(table.out_spec.step))
    return out.reshape(*shape[:-1], w.shape[1])

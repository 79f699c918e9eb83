"""ACAM activation wrapper (port of ``repro.kernels.acam_activation.ops``):
apply an ACAM table to a tensor of any shape — the CUDA kernel
``csrc/acam_activation.cu`` for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

The input is upcast to float32 and flattened; the kernel masks the ragged
tail, so nothing is padded.  The output is float32 in the input's shape.
The kernel searches the table compiled exactly (``core.acam.AcamMap``):
the table's own thresholds' map is cached per device (``table_map``);
caller-given thresholds (noisy ones, say) are compiled on the device per
call — with the table's output grid (``acam_apply``) or any grid
(``acam_apply_grid``, the NAF evaluation's).  ``acam_apply.launches``
counts the kernel's launches through both.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.acam import compile_thresholds, table_map, table_thresholds
from ...core.dt import ACAMTable
from .. import build
from .ref import acam_activation_ref


def _lib():
    lib = build.load("acam_activation")
    if not getattr(lib, "_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.acam_activation_launch.argtypes = [vp, vp, vp, vp,
                                               ctypes.c_longlong, i, f, f,
                                               vp]
        lib.acam_activation_launch.restype = i
        lib.acam_activation_smem_bytes.argtypes = [i]
        lib.acam_activation_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def acam_apply(x: torch.Tensor, table: ACAMTable,
               lo: torch.Tensor | None = None,
               hi: torch.Tensor | None = None) -> torch.Tensor:
    """The Gray-coded ACAM unit of ``table`` on every element of ``x``;
    pass (lo, hi), both or neither, to apply other (say noisy) thresholds
    with the table's output grid.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise — there is no fallback)."""
    if (lo is None) != (hi is None):
        raise ValueError("acam_apply: pass both lo and hi, or neither")
    out_lo = float(table.out_spec.lo)
    out_step = float(table.out_spec.step)
    if lo is not None:
        return acam_apply_grid(x, lo, hi, out_lo, out_step)
    lo, hi = table_thresholds(table, x.device)
    if x.device.type == "cpu":
        return acam_activation_ref(x, lo, hi, out_lo, out_step)
    return _launch(x, table_map(table, x.device), out_lo, out_step)


def acam_apply_grid(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    out_lo: float, out_step: float) -> torch.Tensor:
    """Thresholds (lo, hi) (bits, rows) float32 on ``x``'s device, matched
    Gray-coded on every element of ``x`` and dequantized on the grid
    ``code * out_step + out_lo`` — ``eval_table`` — with the map compiled
    on the device for this call.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return acam_activation_ref(x, lo, hi, out_lo, out_step)
    if (lo.shape != hi.shape or lo.dtype != torch.float32
            or hi.dtype != torch.float32 or lo.device != x.device
            or hi.device != x.device):
        raise ValueError("acam_apply: lo/hi must be float32 (bits, rows) "
                         "on x's device")
    return _launch(x, compile_thresholds(lo, hi), out_lo, out_step)


def _launch(x: torch.Tensor, acam_map, out_lo: float,
            out_step: float) -> torch.Tensor:
    """Kernel D on a CUDA tensor through a compiled map; counts the launch
    in ``acam_apply.launches``."""
    if not (x.is_floating_point() and x.numel() > 0):
        raise ValueError("acam_apply: x must be a non-empty float tensor")
    bp, codes = acam_map.breakpoints, acam_map.codes
    lib = _lib()
    if lib.acam_activation_smem_bytes(bp.shape[0]) > 227 * 1024:
        raise ValueError(f"acam_apply: a {bp.shape[0]}-point ACAM map does "
                         f"not fit in shared memory")
    flat = x.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    err = lib.acam_activation_launch(
        flat.data_ptr(), bp.data_ptr(), codes.data_ptr(), out.data_ptr(),
        flat.numel(), bp.shape[0], out_lo, out_step,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "acam_apply")
    acam_apply.launches += 1
    return out


acam_apply.launches = 0

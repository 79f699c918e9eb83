"""Fused dual-compute wrappers (port of ``repro.kernels.dual_compute.ops``).

* ``fused_crossbar_acam`` — plan level: four A-SL cell matrices + an ACAM
  table -> one fused pass; the CUDA kernel ``csrc/dual_compute.cu`` for
  CUDA tensors, the plain version (``ref.py``) for CPU tensors.  The
  kernel takes the table compiled exactly (``core.acam.AcamMap``): given,
  or compiled from (lo, hi) on the device per call.
* ``fused_linear_acam`` — model level: a float32 weight is programmed to
  ideal A-SL conductances on every call (as ``repro`` does inside ``jit``;
  w_max stays a device scalar) and routed through ``fused_crossbar_acam``.
  This is what ``NLDPEConfig.linear_activation`` dispatches to under
  ``FUSED``.
* ``logdomain_flash_attention`` — NL-DPE causal attention streamed in KV
  tiles: q scaled by 1/sqrt(d), q/k/v log-quantized (the crossbars'
  fused log-ACAM outputs), then the CUDA kernel ``csrc/logdomain_flash.cu``
  for CUDA tensors; the materialized plain version for CPU tensors.  This
  is what ``NLDPEConfig.attention`` dispatches maskless attention to
  under ``FUSED``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...core.acam import (AcamMap, compile_thresholds, get_table,
                          table_map, table_thresholds)
from ...core.logdomain import (DEFAULT_CFG, LogDomainConfig, inv_sqrt,
                               log_quantize)
from ...core.noise import DEFAULT
from ...core.quantization import QuantSpec, recip
from ...core.slicing import RESIDUAL_GAIN, plan_asl
from .. import build
from .ref import fused_crossbar_acam_ref, logdomain_flash_ref


def _lib():
    lib = build.load("dual_compute")
    if not getattr(lib, "_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_crossbar_acam_launch.argtypes = [vp] * 9 + [
            i, i, i, f, i, f, f, vp]
        lib.fused_crossbar_acam_launch.restype = i
        lib.fused_crossbar_acam_smem_bytes.argtypes = [i, i, i]
        lib.fused_crossbar_acam_smem_bytes.restype = ctypes.c_size_t
        lib.fused_crossbar_acam_variant.argtypes = [i, i]
        lib.fused_crossbar_acam_variant.restype = i
        lib._typed = True
    return lib


def _ld_lib():
    lib = build.load("logdomain_flash")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.logdomain_flash_launch.argtypes = [vp] * 4 + [i] * 7 + [vp, vp]
        lib.logdomain_flash_launch.restype = i
        lib._typed = True
    return lib


def fused_crossbar_acam(x: torch.Tensor, g_pos: torch.Tensor,
                        g_neg: torch.Tensor, g_pos_res: torch.Tensor,
                        g_neg_res: torch.Tensor, inv_g_ratio: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor, *,
                        out_lo: float, out_step: float,
                        res_gain: float = RESIDUAL_GAIN,
                        acam_map: AcamMap | None = None) -> torch.Tensor:
    """acam(x @ W_eff): x (M, K) f32; cells (K, N) f32; inv_g_ratio a
    0-d/1-element f32 tensor on the device; lo/hi (bits, rows) f32 ->
    (M, N) f32.  ``acam_map``, when given, is (lo, hi) compiled already
    (``table_map``); otherwise the kernel's map is compiled from them on
    the device, per call.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise — there is no fallback)."""
    cells = (g_pos, g_neg, g_pos_res, g_neg_res)
    if x.device.type == "cpu":
        return fused_crossbar_acam_ref(x, *cells, inv_g_ratio, lo, hi,
                                       out_lo=out_lo, out_step=out_step,
                                       res_gain=res_gain)
    m, k = x.shape
    n = g_pos.shape[1]
    operands = (x, *cells, inv_g_ratio, lo, hi)
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError("fused_crossbar_acam: every operand must be float32")
    if any(t.device != x.device for t in operands):
        raise ValueError("fused_crossbar_acam: all operands on one device")
    if any(g.shape != (k, n) for g in cells) or hi.shape != lo.shape \
            or inv_g_ratio.numel() != 1 or min(m, n, k) < 1:
        raise ValueError("fused_crossbar_acam: shapes x (M, K), cells "
                         "(K, N), lo/hi (bits, rows), inv_g_ratio scalar")
    if acam_map is None:
        acam_map = compile_thresholds(lo, hi)
    bp, codes = acam_map.breakpoints, acam_map.codes
    if bp.device != x.device or bp.dtype != torch.float32 \
            or codes.dtype != torch.int32 \
            or codes.shape != (2 * bp.shape[0] + 1,):
        raise ValueError("fused_crossbar_acam: acam_map must be an AcamMap "
                         "on x's device")
    lib = _lib()
    if lib.fused_crossbar_acam_smem_bytes(m, n, bp.shape[0]) > 227 * 1024:
        raise ValueError(f"fused_crossbar_acam: a {bp.shape[0]}-point ACAM "
                         f"map does not fit in shared memory")
    x = x.contiguous()
    cells = tuple(g.contiguous() for g in cells)
    inv = inv_g_ratio.reshape(1).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = lib.fused_crossbar_acam_launch(
        x.data_ptr(), *(g.data_ptr() for g in cells), inv.data_ptr(),
        bp.data_ptr(), codes.data_ptr(), out.data_ptr(), m, n, k,
        recip(res_gain), bp.shape[0], out_lo, out_step,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_crossbar_acam")
    fused_crossbar_acam.launches += 1
    return out


fused_crossbar_acam.launches = 0


def tile_variant(m: int, n: int) -> str:
    """The tile (``xbar::choose``) kernel B launches at (M, N)."""
    return build.TILE_VARIANTS[_lib().fused_crossbar_acam_variant(m, n)]


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
    transient (caching the plan is later work).  The table's compiled map
    is cached per device (``table_map``), not compiled per call."""
    table = get_table(act, bits)
    cells, inv = program(w)
    lo, hi = table_thresholds(table, x.device)
    shape = x.shape
    out = fused_crossbar_acam(
        x.reshape(-1, shape[-1]).to(torch.float32), *cells, inv, lo, hi,
        out_lo=float(table.out_spec.lo), out_step=float(table.out_spec.step),
        acam_map=table_map(table, x.device))
    return out.reshape(*shape[:-1], w.shape[1])


def logdomain_grids(cfg: LogDomainConfig, lk: int) -> list[float]:
    """(lo, step, 1/step) of the four 8-bit grids the kernel crosses — the
    max-shifted scores, the exp ACAM's output, log of the row sum (its top
    is log(lk + 1)) and the log-softmax — rounded as ``QuantSpec`` rounds
    them."""
    r = cfg.score_range
    specs = (QuantSpec(lo=-r, hi=0.0, bits=cfg.bits),
             QuantSpec(lo=0.0, hi=1.0, bits=cfg.bits),
             QuantSpec(lo=-r, hi=float(math.log(lk + 1)), bits=cfg.bits),
             QuantSpec(lo=-2 * r, hi=0.0, bits=cfg.bits))
    return [x for sp in specs for x in (sp.lo, sp.step, recip(sp.step))]


def logdomain_flash_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              cfg: LogDomainConfig = DEFAULT_CFG,
                              causal: bool = True) -> torch.Tensor:
    """(B, H, Lq, D) x (B, Hkv, Lk, D)^2 -> (B, H, Lq, D) in q's dtype,
    GQA-aware (K/V are never repeated on the card).  The same grids as
    ``nldpe_attention`` at every ACAM crossing, the scores streamed in KV
    tiles.

    CPU tensors take the plain (materialized) version; CUDA tensors launch
    the kernel (or raise — there is no fallback)."""
    if q.device.type == "cpu":
        return logdomain_flash_ref(q, k, v, cfg, causal).to(q.dtype)
    b, hq, lq, d = q.shape
    b2, hkv, lk, d2 = k.shape
    if b2 != b or d2 != d or v.shape != k.shape or hq % hkv:
        raise ValueError(f"logdomain_flash_attention: shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in (16, 32, 64, 128) or cfg.bits != 8:
        raise ValueError(f"logdomain_flash_attention: head_dim {d} not in "
                         f"(16, 32, 64, 128) or {cfg.bits}-bit grids")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("logdomain_flash_attention: all operands on one "
                         "device")
    if min(b, hq, lq, lk) < 1:
        raise ValueError("logdomain_flash_attention: empty operand")
    q_l = log_quantize(q.to(torch.float32) * inv_sqrt(d), cfg).contiguous()
    k_l = log_quantize(k.to(torch.float32), cfg).contiguous()
    v_l = log_quantize(v.to(torch.float32), cfg).contiguous()
    grids = (ctypes.c_float * 12)(*logdomain_grids(cfg, lk))
    out = torch.empty((b, hq, lq, d), dtype=torch.float32, device=q.device)
    err = _ld_lib().logdomain_flash_launch(
        q_l.data_ptr(), k_l.data_ptr(), v_l.data_ptr(), out.data_ptr(),
        b, hq, hkv, lq, lk, d, int(causal), ctypes.cast(grids,
                                                        ctypes.c_void_p),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "logdomain_flash_attention")
    logdomain_flash_attention.launches += 1
    return out.to(q.dtype)


logdomain_flash_attention.launches = 0

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
  fused log-ACAM outputs; ``log_quantize_qkv``, one launch), then the CUDA
  kernel ``csrc/logdomain_flash.cu`` for CUDA tensors, its instance from
  ``logdomain_plan`` and its exps from ``logdomain_tables``; the
  materialized plain version for CPU tensors.  This is what
  ``NLDPEConfig.attention`` dispatches maskless attention to under
  ``FUSED``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ...core.acam import (AcamMap, compile_thresholds, get_table,
                          table_map, table_thresholds)
from ...core.logdomain import (DEFAULT_CFG, LogDomainConfig, inv_sqrt,
                               log_quantize)
from ...core.noise import DEFAULT
from ...core.quantization import QuantSpec, recip
from ...core.slicing import RESIDUAL_GAIN, plan_asl
from .. import build
from ..flash_attention.ops import HEAD_DIMS, rows_aligned, strides
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
        fp = ctypes.POINTER(ctypes.c_float)
        lib.logdomain_quantize_launch.argtypes = [vp] * 6 + [i] * 9 + [
            ctypes.POINTER(ctypes.c_longlong), fp, vp, i, vp]
        lib.logdomain_quantize_launch.restype = i
        sz = ctypes.c_size_t
        lib.logdomain_flash_launch.argtypes = [vp] * 4 + [i] * 9 + [
            fp, vp, vp, sz, vp]
        lib.logdomain_flash_launch.restype = i
        lib.logdomain_flash_smem_bytes.argtypes = [i] * 3
        lib.logdomain_flash_smem_bytes.restype = sz
        lib.logdomain_flash_scratch_bytes.argtypes = [i] * 5
        lib.logdomain_flash_scratch_bytes.restype = sz
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


def program(w: torch.Tensor, w_max: torch.Tensor | None = None):
    """Ideal A-SL programming of a float32 weight: (cells, inv_g_ratio),
    with w_max (``w``'s largest magnitude unless given: a column shard is
    programmed against its whole weight's) and inv computed on the
    weight's device."""
    w = w.to(torch.float32)
    if w_max is None:
        w_max = torch.amax(torch.abs(w))
    w_max = torch.clamp(w_max, min=1e-9)
    plan, _ = plan_asl(w, w_max, DEFAULT)
    inv = w_max * recip(DEFAULT.g_max - DEFAULT.g_min)
    return plan.cells, inv


def fused_linear_acam(x: torch.Tensor, w: torch.Tensor, act: str,
                      bits: int = 8,
                      in_domain: tuple[float, float] | None = None,
                      w_max: torch.Tensor | None = None) -> torch.Tensor:
    """act(x @ w) through an ideally programmed A-SL crossbar, fused.
    x (..., K) any leading shape, w (K, N) float32 -> (..., N) float32;
    the ACAM table of ``act`` at ``bits`` over ``in_domain`` (default: the
    function's reference domain).  Programming happens per call: four
    (K, N) float32 cell matrices are transient (caching the plan is later
    work).  The table's compiled map is cached per table and device
    (``table_map``), not compiled per call.  ``w_max``: see ``program``."""
    table = get_table(act, bits, "gray", in_domain)
    cells, inv = program(w, w_max)
    lo, hi = table_thresholds(table, x.device)
    shape = x.shape
    out = fused_crossbar_acam(
        x.reshape(-1, shape[-1]).to(torch.float32), *cells, inv, lo, hi,
        out_lo=float(table.out_spec.lo), out_step=float(table.out_spec.step),
        acam_map=table_map(table, x.device))
    return out.reshape(*shape[:-1], w.shape[1])


def logdomain_grids(cfg: LogDomainConfig, lk: int) -> list[float]:
    """(lo, step, 1/step) of the three 8-bit grids kernel C crosses by
    arithmetic — the max-shifted scores, log of the row sum (its top is
    log(lk + 1)) and the log-softmax — rounded as ``QuantSpec`` rounds
    them.  (The exp ACAM's grid is crossed inside ``logdomain_tables``.)"""
    score, _, logsum, logp = _grid_specs(cfg, lk)
    return [x for sp in (score, logsum, logp)
            for x in (sp.lo, sp.step, recip(sp.step))]


def _grid_specs(cfg: LogDomainConfig, lk: int) -> tuple[QuantSpec, ...]:
    """The score, exp-output, log-sum and log-softmax grids for lk keys."""
    r = cfg.score_range
    return (QuantSpec(lo=-r, hi=0.0, bits=cfg.bits),
            QuantSpec(lo=0.0, hi=1.0, bits=cfg.bits),
            QuantSpec(lo=-r, hi=float(math.log(lk + 1)), bits=cfg.bits),
            QuantSpec(lo=-2 * r, hi=0.0, bits=cfg.bits))


def logdomain_tables(cfg: LogDomainConfig, device) -> torch.Tensor:
    """The four 256-entry float32 tables kernel C reads, as rows of a
    (4, 256) tensor on ``device``, built there once per (grid, device) with
    the plain version's own ops and cached:

    0. the score grid's values ``yq`` of each code (``QuantSpec.dequantize``);
    1. the exp ACAM's output of each score code, ``q8(exp(yq))`` on [0, 1];
    2. exp of each log-softmax code's value (``nldpe_matmul_loga``'s
       ``exp(la_spec.apply(.))``);
    3. the DMMul grid's magnitudes ``exp(code * step + log_lo)``
       (``log_quantize``'s decode), for the quantize launch.

    So every exp the kernels use is torch's exp on that device, bit for bit.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (cfg, device)
    if key not in _LD_TABLES:
        score, expo, _, logp = _grid_specs(cfg, 1)
        codes = torch.arange(1 << cfg.bits, dtype=torch.int32, device=device)
        yq = score.dequantize(codes)
        _LD_TABLES[key] = torch.stack([
            yq, expo.apply(torch.exp(yq)), torch.exp(logp.dequantize(codes)),
            cfg.mag_spec.decode(codes, torch.ones_like(yq))])
    return _LD_TABLES[key]


_LD_TABLES: dict[tuple, torch.Tensor] = {}

# The tile constants of csrc/logdomain_flash.cu, and its instances in the
# order of its enum.
LD_ROWS, LD_KEYS, LD_STAGES, LD_TABLE_BYTES = 64, 32, 2, 3 * 256 * 4
LD_INSTANCES = ("two_pass", "resident")
SMEM_LIMIT = 227 * 1024


@dataclasses.dataclass(frozen=True)
class LdPlan:
    """One launch of kernel C: the instance ("resident": one score pass
    with the row tile's f32 scores in shared memory; "two_pass": the row
    max, then the codes as bytes in a device scratch), query rows per
    block, keys per K/V tile, ring depth and dynamic shared memory."""
    instance: str
    rows: int
    keys: int
    stages: int
    smem: int


def _ld_pitch(lk: int) -> int:
    """A row's pitch of scores or codes: the keys rounded up to a tile,
    plus 8."""
    return -(-lk // LD_KEYS) * LD_KEYS + 8


def logdomain_plan(lk: int, d: int, instance: str | None = None) -> LdPlan:
    """Kernel C's instance for ``lk`` keys and head dim ``d``
    (``layout_bytes`` of the CUDA source, byte for byte: the ring, the
    tables, a float per row, the 64 rows of q padded to d + 4 floats, then
    the resident instance's scores): resident where its scores fit, else
    two-pass, which fits any length; or ``instance`` where one is asked
    for (it must fit)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"logdomain_flash_attention: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if instance is not None and instance not in LD_INSTANCES:
        raise ValueError(f"logdomain_flash_attention: no instance "
                         f"{instance!r}")
    sp = _ld_pitch(lk)
    base = (LD_STAGES * LD_KEYS * (d + 4) * 4 + LD_TABLE_BYTES
            + LD_ROWS * 4 + LD_ROWS * (d + 4) * 4)
    smem = {"resident": base + LD_ROWS * sp * 4, "two_pass": base}
    if instance is None:
        instance = ("resident" if smem["resident"] <= SMEM_LIMIT
                    else "two_pass")
    elif smem[instance] > SMEM_LIMIT:
        raise ValueError(f"logdomain_flash_attention: the {instance} "
                         f"instance does not fit {lk} keys")
    return LdPlan(instance, LD_ROWS, LD_KEYS, LD_STAGES, smem[instance])


def logdomain_scratch_bytes(pl: LdPlan, b: int, hq: int, hkv: int, lq: int,
                            lk: int) -> int:
    """Device scratch a launch of ``pl`` needs: for two-pass, one byte per
    (row, key) of every block's row tile (the keys padded to the pitch);
    none for resident."""
    if pl.instance != "two_pass":
        return 0
    tiles = -(-(hq // hkv * lq) // pl.rows)
    return b * hkv * tiles * pl.rows * _ld_pitch(lk)


def _quantize_consts(cfg: LogDomainConfig, d: int):
    """q's scale, then ``log_quantize``'s float32 constants: log_lo,
    1/step (``scalar_div``), the flush threshold ``exp(log_lo)`` (compared
    in float32) and the log's floor ``exp(float32(log_lo))``."""
    spec = cfg.mag_spec
    vals = (inv_sqrt(d), spec.log_lo, recip(spec.step),
            math.exp(spec.log_lo), float(np.exp(np.float32(spec.log_lo))))
    return (ctypes.c_float * 5)(*vals)


def log_quantize_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: LogDomainConfig = DEFAULT_CFG):
    """(log_quantize(q * 1/sqrt(d)), log_quantize(k), log_quantize(v)) as
    contiguous float32, every operand upcast first, as the plain version
    upcasts.  CPU tensors take ``log_quantize``; CUDA tensors one launch of
    the quantize kernel, whose values are ``log_quantize``'s on the card bit
    for bit: it reads float32 and bfloat16 as they are, and an operand of
    another floating dtype after one upcast on the card."""
    d = q.shape[-1]
    if q.device.type == "cpu":
        f32 = torch.float32
        return (log_quantize(q.to(f32) * inv_sqrt(d), cfg),
                log_quantize(k.to(f32), cfg), log_quantize(v.to(f32), cfg))
    if cfg.bits != 8:
        raise ValueError(f"log_quantize_qkv: {cfg.bits}-bit grid")
    if any(not t.is_floating_point() for t in (q, k, v)):
        raise TypeError("log_quantize_qkv: operands must be floating point")
    q, k, v = (t if t.dtype in (torch.float32, torch.bfloat16)
               else t.to(torch.float32) for t in (q, k, v))
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"log_quantize_qkv: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if max(q.numel(), k.numel()) // d >= 1 << 31:
        raise ValueError("log_quantize_qkv: 2^31 rows or more")
    q, k, v = (rows_aligned(t) for t in (q, k, v))
    outs = [torch.empty(t.shape, dtype=torch.float32, device=q.device)
            for t in (q, k, v)]
    b, hq, lq, _ = q.shape
    _, hkv, lk, _ = k.shape
    dec = logdomain_tables(cfg, q.device)[3]
    err = _ld_lib().logdomain_quantize_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(t.data_ptr() for t in outs),
        *(int(t.dtype == torch.bfloat16) for t in (q, k, v)),
        b, hq, hkv, lq, lk, d, strides(q, k, v), _quantize_consts(cfg, d),
        dec.data_ptr(),
        torch.cuda.get_device_properties(q.device).multi_processor_count,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "log_quantize_qkv")
    log_quantize_qkv.launches += 1
    return tuple(outs)


log_quantize_qkv.launches = 0


def logdomain_kernel(q_l: torch.Tensor, k_l: torch.Tensor,
                     v_l: torch.Tensor, out_dtype: torch.dtype,
                     cfg: LogDomainConfig = DEFAULT_CFG,
                     causal: bool = True,
                     plan: LdPlan | None = None) -> torch.Tensor:
    """Kernel C's attention launch over log-quantized operands (the
    outputs of ``log_quantize_qkv``): (B, H, Lq, D) in ``out_dtype``, the
    kernel writing float32 or bfloat16 (another dtype is cast from its
    float32 output); the instance ``plan``, by default
    ``logdomain_plan``'s.  Counts one launch of
    ``logdomain_flash_attention``."""
    b, hq, lq, d = q_l.shape
    _, hkv, lk, _ = k_l.shape
    pl = plan or logdomain_plan(lk, d)
    direct = out_dtype in (torch.float32, torch.bfloat16)
    out = torch.empty((b, hq, lq, d), device=q_l.device,
                      dtype=out_dtype if direct else torch.float32)
    nscratch = logdomain_scratch_bytes(pl, b, hq, hkv, lq, lk)
    scratch = torch.empty(nscratch, dtype=torch.uint8, device=q_l.device)
    grids = (ctypes.c_float * 9)(*logdomain_grids(cfg, lk))
    err = _ld_lib().logdomain_flash_launch(
        q_l.data_ptr(), k_l.data_ptr(), v_l.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.bfloat16), b, hq, hkv, lq, lk, d, int(causal),
        LD_INSTANCES.index(pl.instance), grids,
        logdomain_tables(cfg, q_l.device).data_ptr(),
        scratch.data_ptr() if nscratch else None, nscratch,
        torch.cuda.current_stream(q_l.device).cuda_stream)
    build.check(err, "logdomain_flash_attention")
    logdomain_flash_attention.launches += 1
    return out if direct else out.to(out_dtype)


def logdomain_flash_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              cfg: LogDomainConfig = DEFAULT_CFG,
                              causal: bool = True) -> torch.Tensor:
    """(B, H, Lq, D) x (B, Hkv, Lk, D)^2 -> (B, H, Lq, D) in q's dtype,
    GQA-aware (K/V are never repeated on the card).  The same grids as
    ``nldpe_attention`` at every ACAM crossing, the scores streamed in KV
    tiles.

    CPU tensors take the plain (materialized) version; CUDA tensors launch
    the quantize kernel and then the attention kernel (or raise — there is
    no fallback), the output in q's dtype."""
    if q.device.type == "cpu":
        return logdomain_flash_ref(q, k, v, cfg, causal).to(q.dtype)
    b, hq, lq, d = q.shape
    b2, hkv, lk, d2 = k.shape
    if b2 != b or d2 != d or v.shape != k.shape or hq % hkv:
        raise ValueError(f"logdomain_flash_attention: shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS or cfg.bits != 8:
        raise ValueError(f"logdomain_flash_attention: head_dim {d} not in "
                         f"{HEAD_DIMS} or {cfg.bits}-bit grids")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("logdomain_flash_attention: all operands on one "
                         "device")
    if min(b, hq, lq, lk) < 1:
        raise ValueError("logdomain_flash_attention: empty operand")
    return logdomain_kernel(*log_quantize_qkv(q, k, v, cfg), q.dtype, cfg,
                            causal)


logdomain_flash_attention.launches = 0

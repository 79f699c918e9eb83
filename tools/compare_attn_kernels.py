#!/usr/bin/env python3
"""Hold kernels F and C against an earlier build of their sources, and
split each call's time into its parts.

    python3 tools/compare_attn_kernels.py --extract <commit>   # where git is
    python3 tools/compare_attn_kernels.py                      # on the card
    python3 tools/compare_attn_kernels.py --old-only           # parent alone

``--extract`` writes the commit's ``flash_attention.cu``,
``logdomain_flash.cu`` and ``attn_tiles.cuh`` (``git show``) into
``--old-dir`` (default ``build/old_attn``, ignored by git) and exits.  On
the card the script builds those sources with nvcc beside the checkout's
kernels and feeds both builds the cases of ``chip_smoke.py``'s F and C
phases, plus Lk = 2048:

* F: (8, 16/2 heads, 512, 128) and (1, 16/2, 2048, 128), f32 and bf16;
* C: (4, 16/2, 256, 128) f32 and bf16, (8, 16/2, 512, 128) and
  (1, 16/2, 2048, 128) f32; and 64 queries over 12288 keys (the two-pass
  instance).  The parent took any length, so this case holds the new
  kernel to it past 2048 keys.

The old sources take the C interface they had before split-TF32 scores:
``flash_attention_launch(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal,
scale, stream)`` and ``logdomain_flash_launch(q_l, k_l, v_l, out, B, Hq,
Hkv, Lq, Lk, D, causal, grids, stream)`` over contiguous f32 operands; the
script repeats the old wrappers' conversions around them (F: ``.to(f32)``
of q, k, v and of the output back to q's dtype; C: ``log_quantize`` of q
scaled by 1/sqrt(D), of k and of v).

Each output must lie within ``F_TOL`` (C: ``C_TOL``) of the plain version
and of the other build, plus one bf16 step for bf16 outputs.  Old and new
are timed in turns (old, new, new, old) with ``chip_smoke.py``'s timer (a
spin kernel in front, L2 flushed before each call).  The attribution line
of each case splits a call into the wrapper's conversions and the kernel
alone; for the old C, into its three passes too (variants of the source
that stop after pass 0 or pass 1, whose outputs are wrong by design and
are not checked); for the new C, into the quantize launch and the
attention kernel.  Each C case also runs every instance of the new
kernel that fits it (resident, two-pass), each held against the plain
version and timed in turns (a, b, b, a).  Prints one JSON line per case and exits non-zero if a check fails.
Needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OLD_FILES = ("flash_attention.cu", "logdomain_flash.cu", "attn_tiles.cuh")
F_CASES = [((8, 16, 2, 512, 512, 128), "float32"),
           ((8, 16, 2, 512, 512, 128), "bfloat16"),
           ((1, 16, 2, 2048, 2048, 128), "float32"),
           ((1, 16, 2, 2048, 2048, 128), "bfloat16")]
C_CASES = [((4, 16, 2, 256, 256, 128), "float32"),
           ((4, 16, 2, 256, 256, 128), "bfloat16"),
           ((8, 16, 2, 512, 512, 128), "float32"),
           ((1, 16, 2, 2048, 2048, 128), "float32"),
           ((1, 16, 2, 64, 12288, 128), "float32")]
# the old C source cut after pass 0 and after pass 1
PASS_CUT = "  for (int phase = 0; phase < 3; ++phase) {"


def extract(commit: str, old_dir: Path) -> None:
    old_dir.mkdir(parents=True, exist_ok=True)
    for name in OLD_FILES:
        text = subprocess.run(
            ["git", "-C", str(ROOT), "show",
             f"{commit}:src/repro_torch/csrc/{name}"],
            capture_output=True, text=True, check=True).stdout
        (old_dir / name).write_text(text)
    print(f"wrote {', '.join(OLD_FILES)} of {commit} to {old_dir}")


def build_old(old_dir: Path) -> dict:
    """The old sources, and the old C cut after passes 0 and 1, built in
    parallel into ``old_dir``; returns the typed libraries by name."""
    from repro_torch.kernels import build
    srcs = {"flash": old_dir / "flash_attention.cu",
            "ld": old_dir / "logdomain_flash.cu"}
    text = srcs["ld"].read_text()
    if PASS_CUT not in text:
        sys.exit("compare_attn_kernels: the old logdomain_flash.cu has no "
                 "three-pass loop to cut")
    for n in (1, 2):
        srcs[f"ld_pass{n}"] = old_dir / f"logdomain_flash_pass{n}.cu"
        srcs[f"ld_pass{n}"].write_text(text.replace(
            PASS_CUT, PASS_CUT.replace("< 3", f"< {n}")))
    procs = {name: subprocess.Popen(
        [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", str(src.with_suffix(".so")),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, src in srcs.items()}
    libs = {}
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"compare_attn_kernels: old {name} did not build:\n"
                     f"{log}")
        lib = ctypes.CDLL(str(srcs[name].with_suffix(".so")))
        if name == "flash":
            lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 7 + [f, vp]
            lib.flash_attention_launch.restype = i
        else:
            lib.logdomain_flash_launch.argtypes = [vp] * 4 + [i] * 7 + [vp,
                                                                         vp]
            lib.logdomain_flash_launch.restype = i
        libs[name] = lib
    return libs


class OldF:
    """The parent's kernel F behind the parent's wrapper."""

    def __init__(self, torch, lib):
        self.torch, self.lib = torch, lib

    def convert(self, q, k, v):
        f32 = self.torch.float32
        return [t.to(f32).contiguous() for t in (q, k, v)]

    def kernel(self, qf, kf, vf, out, causal=True):
        from repro_torch.core.quantization import recip
        from repro_torch.kernels import build
        b, hq, lq, d = qf.shape
        _, hkv, lk, _ = kf.shape
        err = self.lib.flash_attention_launch(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), b,
            hq, hkv, lq, lk, d, int(causal), recip(math.sqrt(d)),
            self.torch.cuda.current_stream().cuda_stream)
        build.check(err, "old flash_attention")
        return out

    def __call__(self, q, k, v):
        qf, kf, vf = self.convert(q, k, v)
        out = self.torch.empty(qf.shape, dtype=self.torch.float32,
                               device=q.device)
        return self.kernel(qf, kf, vf, out).to(q.dtype)


class OldC:
    """The parent's kernel C behind the parent's wrapper; ``lib`` may be a
    build cut after an early pass."""

    def __init__(self, torch, lib):
        self.torch, self.lib = torch, lib

    def convert(self, q, k, v):
        from repro_torch.core.logdomain import (DEFAULT_CFG, inv_sqrt,
                                                log_quantize)
        f32 = self.torch.float32
        d = q.shape[-1]
        return [log_quantize(q.to(f32) * inv_sqrt(d), DEFAULT_CFG)
                .contiguous(),
                log_quantize(k.to(f32), DEFAULT_CFG).contiguous(),
                log_quantize(v.to(f32), DEFAULT_CFG).contiguous()]

    def kernel(self, ql, kl, vl, out, lib=None):
        from repro_torch.core.logdomain import DEFAULT_CFG
        from repro_torch.core.quantization import recip
        from repro_torch.kernels import build
        from repro_torch.kernels.dual_compute.ops import _grid_specs
        b, hq, lq, d = ql.shape
        _, hkv, lk, _ = kl.shape
        grids = (ctypes.c_float * 12)(*(         # the old four grids
            x for sp in _grid_specs(DEFAULT_CFG, lk)
            for x in (sp.lo, sp.step, recip(sp.step))))
        err = (lib or self.lib).logdomain_flash_launch(
            ql.data_ptr(), kl.data_ptr(), vl.data_ptr(), out.data_ptr(), b,
            hq, hkv, lq, lk, d, 1, ctypes.cast(grids, ctypes.c_void_p),
            self.torch.cuda.current_stream().cuda_stream)
        build.check(err, "old logdomain_flash")
        return out

    def __call__(self, q, k, v):
        ql, kl, vl = self.convert(q, k, v)
        out = self.torch.empty(ql.shape, dtype=self.torch.float32,
                               device=q.device)
        return self.kernel(ql, kl, vl, out).to(q.dtype)


def inputs(torch, shape, dtype, seed):
    b, hq, hkv, lq, lk, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(
        getattr(torch, dtype))
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]


def within(torch, out, ref, tol: float, bf16: bool) -> tuple[bool, float]:
    err = (out.float() - ref.float()).abs()
    slack = 2.0 ** -7 if bf16 else 0.0
    return (bool((err <= tol + slack * ref.float().abs()).all()),
            err.max().item())


def old_split(torch, timer, old, q, k, v, variants=None) -> dict:
    """The parent's call, its conversions alone and its kernel alone (and,
    given ``variants``, the kernel cut after each early pass)."""
    conv = old.convert(q, k, v)
    out = torch.empty(conv[0].shape, dtype=torch.float32, device=q.device)
    split = {
        "call_ms": timer.ms(lambda: old(q, k, v))[0],
        "conversions_ms": timer.ms(
            lambda: (old.convert(q, k, v), out.to(q.dtype)))[0],
        "kernel_ms": timer.ms(lambda: old.kernel(*conv, out))[0]}
    if variants:
        upto = [timer.ms(lambda lib=lib: old.kernel(*conv, out, lib=lib))[0]
                for lib in variants] + [split["kernel_ms"]]
        split["pass_ms"] = [upto[0], upto[1] - upto[0], upto[2] - upto[1]]
    return split


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", type=Path, default=ROOT / "build" /
                    "old_attn")
    ap.add_argument("--extract", metavar="COMMIT")
    ap.add_argument("--old-only", action="store_true",
                    help="time and split the old build alone")
    args = ap.parse_args()
    if args.extract:
        extract(args.extract, args.old_dir)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("compare_attn_kernels: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import C_TOL, F_TOL, Timer
    from repro_torch.kernels import build
    from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    libs = build_old(args.old_dir)
    if not args.old_only:
        build.build_all()
    timer = Timer(torch)
    old_f, old_c = OldF(torch, libs["flash"]), OldC(torch, libs["ld"])
    ok = True
    for kernel, cases in (("F", F_CASES), ("C", C_CASES)):
        for shape, dtype in cases:
            q, k, v = inputs(torch, shape, dtype, 3 if kernel == "F" else 4)
            bf16 = dtype == "bfloat16"
            if kernel == "F":
                old, tol = old_f, F_TOL
                ref = flash_attention_ref(q, k, v)
                split = old_split(torch, timer, old, q, k, v)
            else:
                old, tol = old_c, C_TOL
                ref = logdomain_flash_ref(q, k, v)
                split = old_split(torch, timer, old, q, k, v,
                                  [libs["ld_pass1"], libs["ld_pass2"]])
            old_out = old(q, k, v)
            old_ok, old_err = within(torch, old_out, ref, tol, bf16)
            line = {"kernel": kernel, "shape": list(shape), "dtype": dtype,
                    "tolerance": tol, "max_abs_err_old": old_err,
                    "old": split}
            case_ok = old_ok
            if not args.old_only:
                new_call, new_split = new_parts(torch, timer, kernel, q, k,
                                                v)
                new_out = new_call()
                torch.cuda.synchronize()
                new_ok, new_err = within(torch, new_out, ref, tol, bf16)
                pair_ok, pair_err = within(torch, new_out, old_out.float(),
                                           tol, bf16)
                case_ok &= new_ok and pair_ok
                times = [timer.ms(fn)[0] for fn in (
                    lambda: old(q, k, v), new_call, new_call,
                    lambda: old(q, k, v))]
                line.update({"max_abs_err_new": new_err,
                             "max_abs_new_minus_old": pair_err,
                             "old_ms": [times[0], times[3]],
                             "new_ms": times[1:3], "new": new_split})
                if kernel == "C":
                    line["instances"] = instance_times(torch, timer, q, k,
                                                       v, ref, bf16)
                    case_ok &= all(x["ok"]
                                   for x in line["instances"].values())
            line["ok"] = case_ok
            ok &= case_ok
            print(json.dumps(line), flush=True)
            del q, k, v, ref, old_out
            torch.cuda.empty_cache()
    if not ok:
        sys.exit("compare_attn_kernels: a case is outside the tolerance")


def instance_times(torch, timer, q, k, v, ref, bf16: bool) -> dict:
    """Every instance of the new C that fits the case: its largest error
    against the plain version (within ``C_TOL``) and its kernel time,
    the instances timed in turns (a, b, b, a)."""
    from chip_smoke import C_TOL
    from repro_torch.kernels.dual_compute import ops
    quantized = ops.log_quantize_qkv(q, k, v)
    lk, d = k.shape[2], q.shape[-1]
    calls = {}
    for name in ("resident", "two_pass"):
        try:
            pl = ops.logdomain_plan(lk, d, name)
        except ValueError:
            continue
        calls[name] = lambda pl=pl: ops.logdomain_kernel(
            *quantized, q.dtype, plan=pl)
    res = {}
    for name, call in calls.items():
        ok, err = within(torch, call(), ref, C_TOL, bf16)
        res[name] = {"ok": ok, "max_abs_err": err, "ms": []}
    for name in [*calls, *reversed(calls)]:
        res[name]["ms"].append(timer.ms(calls[name])[0])
    return res


def new_parts(torch, timer, kernel: str, q, k, v):
    """The new call, and its split: the new wrappers convert nothing, so
    F's call is its kernel; C's is the quantize launch and the kernel."""
    if kernel == "F":
        from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                             plan)

        def call():
            return flash_attention(q, k, v)
        pl = plan(q.dtype, q.shape[-1])
        return call, {"kernel_ms": timer.ms(call)[0],
                      "instance": pl.instance, "smem": pl.smem}
    from repro_torch.kernels.dual_compute import ops

    def call():
        return ops.logdomain_flash_attention(q, k, v)
    ql, kl, vl = ops.log_quantize_qkv(q, k, v)
    pl = ops.logdomain_plan(k.shape[2], q.shape[-1])
    return call, {
        "quantize_ms": timer.ms(lambda: ops.log_quantize_qkv(q, k, v))[0],
        "kernel_ms": timer.ms(lambda: ops.logdomain_kernel(
            ql, kl, vl, q.dtype))[0],
        "instance": pl.instance, "rows": pl.rows, "smem": pl.smem}


if __name__ == "__main__":
    main()

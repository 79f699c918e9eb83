#!/usr/bin/env python3
"""Where kernel A's time goes: the kernel timed beside variants of itself.

    python3 tools/attribute_kernel_a.py

Builds, from ``src/repro_torch/csrc/paged_attention.cu``, variants that
each cut one part out (by text substitution of the source; a variant's
output is wrong by design and is not checked):

* ``no_merge``: no second launch merging the split partials;
* ``length_only``: each block reads its sequence's length and exits (and
  no merge) — the launch and one load from device memory;
* ``no_math``: copies and ring waits, no scores, softmax or P @ V;
* ``no_copies``: the math on whatever shared memory holds, no cp.async;

and times each (``chip_smoke.py``'s timer: L2 flushed before each call)
at ``tools/compare_kernel_a.py``'s inputs (8 sequences, 16/2 heads, head
dim 128, 64 pages of 16 per table, lengths 320-736; Q = 1 and 64; f32 and
log8 pools).  Then profiles 20 decode calls of the kernel itself for each
launch's device time.  Prints one JSON line per (case, variant) and the
profiler's table.  Needs one CUDA GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CUTS = {
    "no_merge": [("  if (err || a.splits == 1) return err;",
                  "  return err;")],
    "no_math": [("    const int p0 = (c0 + warp + DEC_WARPS * n) * DEC_SW;\n\n",
                 "    const int p0 = (c0 + warp + DEC_WARPS * n) * DEC_SW;\n"
                 "    if (p0 >= 0) { __syncwarp(); continue; }\n\n"),
                ("    // Q.K^T: rows rg*RM + i x positions pg + 16c\n",
                 "    if (t >= 0) { if (next) issue(slot_i ^ 1); continue; }\n"
                 "    // Q.K^T: rows rg*RM + i x positions pg + 16c\n")],
    "no_copies": [('''  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));''', "  (void)s; (void)src; (void)ok;"),
                  ('''  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));''', "  (void)s; (void)src; (void)ok;")],
}
LEN_READ = "  const int len = __ldg(a.lengths + b);\n"   # both kernels
CUTS["length_only"] = CUTS["no_merge"] + [
    (LEN_READ, LEN_READ + "  if (len >= 0) return;\n")]


def variants(src: str) -> dict[str, str]:
    """The source with each variant's parts cut out; raises if a cut no
    longer matches the source."""
    out = {"kernel": src}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"attribute_kernel_a: {name}: the source "
                                 f"no longer has {old.strip()[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("attribute_kernel_a: needs a CUDA GPU")
    from chip_smoke import Timer
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.nn.attention import _quantize_kv
    src = (build.CSRC / "paged_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "attribute"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"attribute_kernel_a: {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.paged_attention_launch.argtypes = \
            ops._lib().paged_attention_launch.argtypes
        lib.paged_attention_launch.restype = ctypes.c_int
        libs[name] = lib
    timer = Timer(torch)
    b, hq, hkv, d, num_pages, ps, nb = 8, 16, 2, 128, 512, 16, 64
    rng = np.random.default_rng(0)
    bt = torch.tensor(rng.permutation(num_pages).reshape(b, nb),
                      dtype=torch.int32, device="cuda")
    pos = torch.tensor(rng.integers(320, 737, b), dtype=torch.int32,
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kf, vf = (torch.randn((num_pages, hkv, ps, d), generator=gen,
                          device="cuda") for _ in range(2))
    (kc, ks), (vc, vs) = _quantize_kv(kf, "log8"), _quantize_kv(vf, "log8")
    pools = {"float32": (kf, vf, None, None, None, 0),
             "log8": (kc, vc, ks, vs, "log8", 2)}

    def call(lib, q, lengths, pool):
        kp, vp, k_sc, v_sc, mode, kind = pools[pool]
        return ops._launch(lib, q, kp, vp, bt, lengths, k_sc, v_sc, mode,
                           kind, torch.cuda.current_stream().cuda_stream)

    for q_len in (1, 64):
        q = torch.randn((b, hq, q_len, d), generator=gen, device="cuda")
        lengths = (pos - q_len + 1).clamp(min=1).to(torch.int32)
        for pool in pools:
            for name, lib in libs.items():
                ms, _ = timer.ms(lambda: call(lib, q, lengths, pool),
                                 iters=20)
                print(json.dumps({"q_len": q_len, "pool": pool,
                                  "variant": name, "ms": ms}), flush=True)
    from torch.profiler import ProfilerActivity, profile
    q = torch.randn((b, hq, 1, d), generator=gen, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            timer.flush_buf.max()
            call(libs["kernel"], q, pos, "float32")
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=6,
                                    max_name_column_width=70))


if __name__ == "__main__":
    main()

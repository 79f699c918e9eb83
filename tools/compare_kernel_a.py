#!/usr/bin/env python3
"""Hold kernel A's fp-pool path against an earlier build of its source.

    python3 tools/compare_kernel_a.py --old-source OLD/paged_attention.cu

For a change to ``src/repro_torch/csrc/paged_attention.cu`` that must not
move the f32 and bf16 pool outputs: builds ``--old-source`` (an earlier
revision of the file, e.g. ``git show <commit>:src/repro_torch/csrc/
paged_attention.cu``) with nvcc beside the checkout's kernel, feeds both
the same inputs at the shapes ``chip_smoke.py``'s kernel-A phase gives
them (8 sequences, 16/2 heads, head dim 128, 512 pages of 16 positions,
64 blocks with two sentinel entries; Q = 1 and 64), checks that the
outputs are equal bit for bit, and times both in turns (old, new, new,
old) with ``chip_smoke.py``'s timer.  The old source must have the C
interface the code-pool variant replaced (``paged_attention_launch(q, k,
v, kv_dtype, bt, lengths, out, part_acc, part_ml, B, Hq, Hkv, Q, D, P,
ps, NB, splits, stream)``).  Prints one JSON line per case and exits
non-zero if any output differs.  Needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def old_kernel(source: Path):
    """The old source built into the ignored build directory, typed."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "old" / "libpaged_attention_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [vp, vp, vp, i, vp, vp, vp, vp, vp,
                                           i, i, i, i, i, i, i, i, i, vp]
    lib.paged_attention_launch.restype = i
    lib.paged_attention_rows_per_block.restype = i
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", type=Path, required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("compare_kernel_a: needs a CUDA GPU")
    from chip_smoke import Timer
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention.ops import (_sm_count,
                                                         num_splits,
                                                         paged_attention)
    build.build_all()
    old = old_kernel(args.old_source)
    timer = Timer(torch)
    b, hq, hkv, d, num_pages, ps, nb = 8, 16, 2, 128, 512, 16, 64
    rng = np.random.default_rng(0)
    bt = torch.tensor(rng.permutation(num_pages).reshape(b, nb),
                      dtype=torch.int32, device="cuda")
    bt[0, 3] = num_pages                    # unmapped sentinel
    bt[1, 5] = -1                           # negative sentinel
    pos = torch.tensor(rng.integers(320, 737, b), dtype=torch.int32,
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pools = [torch.randn((num_pages, hkv, ps, d), generator=gen,
                         device="cuda") for _ in range(2)]
    ok = True
    for q_len in (1, 64):
        q = torch.randn((b, hq, q_len, d), generator=gen, device="cuda")
        lengths = (pos - q_len + 1).clamp(min=1).to(torch.int32)
        splits = num_splits(b, hkv, (hq // hkv) * q_len, nb,
                            old.paged_attention_rows_per_block(),
                            _sm_count(0))
        for kind, dtype in ((0, torch.float32), (1, torch.bfloat16)):
            kp, vp = (p.to(dtype) for p in pools)
            new_out = paged_attention(q, kp, vp, bt, lengths)
            old_out = torch.empty_like(new_out)
            part = [torch.empty((b * hkv, splits, (hq // hkv) * q_len, w),
                                device="cuda") for w in (d, 2)]

            def run_old():
                err = old.paged_attention_launch(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kind,
                    bt.data_ptr(), lengths.data_ptr(), old_out.data_ptr(),
                    part[0].data_ptr(), part[1].data_ptr(), b, hq, hkv, q_len,
                    d, num_pages, ps, nb, splits,
                    torch.cuda.current_stream().cuda_stream)
                build.check(err, "old paged_attention")
                return old_out

            run_old()
            torch.cuda.synchronize()
            same = bool(torch.equal(old_out, new_out))
            ok &= same
            times = [timer.ms(fn, iters=20)[0] for fn in (
                run_old, lambda: paged_attention(q, kp, vp, bt, lengths),
                lambda: paged_attention(q, kp, vp, bt, lengths), run_old)]
            print(json.dumps({
                "q_len": q_len, "pool": str(dtype).split(".")[-1],
                "splits": splits, "bitwise_equal": same,
                "old_ms": [times[0], times[3]], "new_ms": times[1:3]}))
    if not ok:
        sys.exit("compare_kernel_a: outputs differ from the old source's")


if __name__ == "__main__":
    main()

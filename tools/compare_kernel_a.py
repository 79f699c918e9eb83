#!/usr/bin/env python3
"""Hold kernel A against an earlier build of its source.

    git show <commit>:src/repro_torch/csrc/paged_attention.cu \\
        > build/old/paged_attention.cu
    python3 tools/compare_kernel_a.py --old-source build/old/paged_attention.cu

Builds ``--old-source`` (an earlier revision of
``src/repro_torch/csrc/paged_attention.cu`` with the C interface of the
code-pool variant: ``paged_attention_launch(q, k, v, kv_kind, k_scale,
v_scale, table, bt, lengths, out, part_acc, part_ml, B, Hq, Hkv, Q, D, P,
ps, NB, splits, stream)`` and ``paged_attention_rows_per_block()``) with
nvcc beside the checkout's kernel, and feeds both the same inputs at the
eight cases of ``chip_smoke.py``'s kernel-A phase: f32, bf16, int8 and
log8 pools, each at Q = 1 (decode) and Q = 64 (chunk prefill) — 8
sequences, 16/2 heads, head dim 128, 512 pages of 16 positions, 64 blocks
with two sentinel entries, lengths of a served engine's (320-736).  Each
output must lie within ``A_TOL`` of the plain version and of the other
build's (the two sum in different orders, so bits cannot be compared), and
a code pool's output must equal the new build's on an f32 pool of its
decoded values bit for bit.  Old and new are timed in turns (old, new,
new, old) with ``chip_smoke.py``'s timer.  Prints one JSON line per case
and exits non-zero if any check fails.  Needs one CUDA GPU.
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

OLD_BLOCKS_PER_SM = 4   # the parent's split rule (128-thread blocks)


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
                                           vp, vp, vp, i, i, i, i, i, i, i,
                                           i, i, vp]
    lib.paged_attention_launch.restype = i
    lib.paged_attention_rows_per_block.restype = i
    return lib


def old_splits(b: int, hkv: int, n_rows: int, nb: int, rows: int,
               sms: int) -> int:
    """The parent wrapper's page-axis splits."""
    blocks = b * hkv * (-(-n_rows // rows))
    target = OLD_BLOCKS_PER_SM * sms
    if blocks >= target:
        return 1
    return max(1, min(nb, -(-target // blocks)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", type=Path, required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("compare_kernel_a: needs a CUDA GPU")
    from chip_smoke import A_TOL, Timer
    from repro_torch.core.quantization import kv_decode, kv_table
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention.ops import paged_attention, plan
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.nn.attention import _quantize_kv
    build.build_all()
    old = old_kernel(args.old_source)
    timer = Timer(torch)
    b, hq, hkv, d, num_pages, ps, nb = 8, 16, 2, 128, 512, 16, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    bt = torch.tensor(rng.permutation(num_pages).reshape(b, nb),
                      dtype=torch.int32, device="cuda")
    bt[0, 3] = num_pages                    # unmapped sentinel
    bt[1, 5] = -1                           # negative sentinel
    pos = torch.tensor(rng.integers(320, 737, b), dtype=torch.int32,
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kf, vf = (torch.randn((num_pages, hkv, ps, d), generator=gen,
                          device="cuda") for _ in range(2))
    pools = {"float32": (kf, vf, {}), "bfloat16": (
        kf.to(torch.bfloat16), vf.to(torch.bfloat16), {})}
    for mode in ("int8", "log8"):
        (kc, ks), (vc, vs) = _quantize_kv(kf, mode), _quantize_kv(vf, mode)
        pools[mode] = (kc, vc, dict(k_scale=ks, v_scale=vs, kv_quant=mode))
    kinds = {"float32": 0, "bfloat16": 1, "int8": 2, "log8": 2}
    ok = True
    for q_len in (1, 64):
        q = torch.randn((b, hq, q_len, d), generator=gen, device="cuda")
        lengths = (pos - q_len + 1).clamp(min=1).to(torch.int32)
        n_rows = (hq // hkv) * q_len
        splits = old_splits(b, hkv, n_rows, nb,
                            old.paged_attention_rows_per_block(), sms)
        for pool, (kp, vp, kw) in pools.items():
            call = (q, kp, vp, bt, lengths)
            new_out = paged_attention(*call, **kw)
            ref = paged_attention_ref(*call, **kw)
            old_out = torch.empty_like(new_out)
            part = [torch.empty((b * hkv, splits, n_rows, w), device="cuda")
                    for w in (d, 2)]
            table = kv_table(kw["kv_quant"], "cuda") if kw else None

            def ptr(t):
                return None if t is None else t.data_ptr()

            def run_old():
                err = old.paged_attention_launch(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kinds[pool],
                    ptr(kw.get("k_scale")), ptr(kw.get("v_scale")),
                    ptr(table), bt.data_ptr(), lengths.data_ptr(),
                    old_out.data_ptr(), part[0].data_ptr(),
                    part[1].data_ptr(), b, hq, hkv, q_len, d, num_pages, ps,
                    nb, splits, torch.cuda.current_stream().cuda_stream)
                build.check(err, "old paged_attention")
                return old_out

            run_old()
            torch.cuda.synchronize()
            err_new = (new_out - ref).abs().max().item()
            err_old = (old_out - ref).abs().max().item()
            err_pair = (new_out - old_out).abs().max().item()
            case_ok = max(err_new, err_old, err_pair) <= A_TOL
            if kw:
                fp = paged_attention(
                    q, kv_decode(kp, kw["k_scale"], kw["kv_quant"]),
                    kv_decode(vp, kw["v_scale"], kw["kv_quant"]), bt,
                    lengths)
                same = bool(torch.equal(fp, new_out))
                case_ok &= same
            ok &= case_ok
            times = [timer.ms(fn, iters=20)[0] for fn in (
                run_old, lambda: paged_attention(*call, **kw),
                lambda: paged_attention(*call, **kw), run_old)]
            pl = plan(b, hkv, n_rows, nb, ps, d, kinds[pool])
            line = {"q_len": q_len, "pool": pool, "ok": case_ok,
                    "max_abs_err_new": err_new, "max_abs_err_old": err_old,
                    "max_abs_new_minus_old": err_pair, "tolerance": A_TOL,
                    "old_splits": splits, "new_instance": pl.instance,
                    "new_rows": pl.rows, "new_splits": pl.splits,
                    "old_ms": [times[0], times[3]], "new_ms": times[1:3]}
            if kw:
                line["equals_f32_pool_of_decoded_values"] = same
            print(json.dumps(line), flush=True)
    if not ok:
        sys.exit("compare_kernel_a: a case is outside the tolerance")


if __name__ == "__main__":
    main()

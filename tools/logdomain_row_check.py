"""Kernel C (log-domain flash attention) against its plain version, row by
row, at the serve paths' head dims (256: PaliGemma, RecurrentGemma; 128
and 64), f32 and bf16, on the card.

For each case it prints the largest |kernel - plain|, the elements past
the tolerance (1/255, plus one bf16 step for bf16 outputs) and the query
rows they lie in, and kernel F's largest error on the same inputs.  A row
whose every element is off by about one log-softmax step while the rest
agree is a row whose log-sum code moved: its row sum was summed in
another order than the plain version's at a grid boundary.

    PYTHONPATH=src python3 tools/logdomain_row_check.py
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.dual_compute.ops import (  # noqa: E402
    logdomain_flash_attention, logdomain_plan)
from repro_torch.kernels.dual_compute.ref import logdomain_flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

SHAPES = [(1, 8, 1, 1280, 1280, 256), (2, 4, 1, 37, 53, 256),
          (1, 8, 1, 300, 300, 256), (1, 16, 1, 2048, 2048, 256),
          (1, 8, 1, 1280, 1280, 128), (1, 8, 1, 1280, 1280, 64)]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("logdomain_row_check: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(23)
            b, hq, hkv, lq, lk, d = shape
            q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
                       .to(dt).cuda()
                       for s in ((b, hq, lq, d), (b, hkv, lk, d),
                                 (b, hkv, lk, d)))
            out = logdomain_flash_attention(q, k, v)
            ref = logdomain_flash_ref(q, k, v)
            err = (out.float() - ref).abs()
            slack = 0.0 if dt == torch.float32 else 2.0 ** -7
            bad = err > 1.0 / 255 + slack * ref.abs()
            rows = bad.any(-1).nonzero()[:, 2].unique().tolist()
            f_err = (flash_attention(q, k, v).float()
                     - flash_attention_ref(q, k, v)).abs().max().item()
            print(f"C {shape} {str(dt)[6:]} {logdomain_plan(lk, d).instance}: "
                  f"max err {err.max().item():.3e}, bad elements "
                  f"{int(bad.sum())}, bad rows {rows[:12]} (of {len(rows)}); "
                  f"F max err {f_err:.3e}", flush=True)


if __name__ == "__main__":
    main()

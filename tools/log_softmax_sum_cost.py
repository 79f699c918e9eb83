"""What the exact (float64) row sum of ``core.logdomain.nldpe_log_softmax``
costs on the card, at shapes of the serve paths that run it.

The materialized NL-DPE attention (``core.attention.nldpe_attention``)
runs the log-softmax on every ``ON``/``FUSED`` masked or cached route:
Gemma3's windowed layers in a lockstep FUSED prefill (1, 32 heads, the
first prompt's 1110 positions, window 1024) and an ``ON`` decode step over
a 1024-position cache (8 slots, 16 heads).  For each it prints, in ms
(CUDA events, median of 20 calls after 3 warm ones): the whole
log-softmax, the whole attention, the float64 sum of the 8-bit exp
outputs, the float32 sum of the same tensor, and the float64 copy's bytes.

    PYTHONPATH=src python3 tools/log_softmax_sum_cost.py
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.attention import causal_mask, nldpe_attention  # noqa: E402
from repro_torch.core.logdomain import nldpe_log_softmax  # noqa: E402

# (label, (B, H, Lq, Lk), window or None, head dim)
CASES = [("gemma3 lockstep FUSED windowed layer", (1, 32, 1110, 1110), 1024,
          128),
         ("ON decode over a 1024-position cache", (8, 16, 1, 1024), None,
          128)]


def median_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("log_softmax_sum_cost: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, h, lq, lk), window, d in CASES:
        y = 3 * torch.randn((b, h, lq, lk), generator=gen, device="cuda")
        mask = causal_mask(lq, lk, "cuda")
        if window is not None:
            qpos = torch.arange(lk - lq, lk, device="cuda")[:, None]
            mask = mask & (torch.arange(lk, device="cuda")[None] > qpos
                           - window)
        mask = mask[None, None]
        q = torch.randn((b, h, lq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, h, lk, d), generator=gen, device="cuda")
                for _ in range(2))
        # an 8-bit exp output grid tensor, as the log-softmax sums it
        sq = torch.round(torch.rand((b, h, lq, lk), generator=gen,
                                    device="cuda") * 255) / 255
        out = {
            "case": label, "shape": [b, h, lq, lk], "window": window,
            "log_softmax_ms": median_ms(
                lambda: nldpe_log_softmax(y, mask=mask)),
            "attention_ms": median_ms(
                lambda: nldpe_attention(q, k, v, causal=False, mask=mask)),
            "sum_f64_ms": median_ms(lambda: torch.sum(
                sq.to(torch.float64), dim=-1, keepdim=True).to(sq.dtype)),
            "sum_f32_ms": median_ms(
                lambda: torch.sum(sq, dim=-1, keepdim=True)),
            "f64_copy_bytes": sq.numel() * 8}
        out["f64_extra_ms"] = out["sum_f64_ms"] - out["sum_f32_ms"]
        out["f64_extra_share_of_attention"] = (out["f64_extra_ms"]
                                               / out["attention_ms"])
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""End-to-end training on the port: the counterpart of
``examples/train_lm_100m.py``.

    PYTHONPATH=src python -m repro_torch.train_lm_100m [--steps 300]
        [--batch 8] [--seq 128] [--ckpt-dir D] [--device cpu]

Trains the example's ~100M-parameter qwen2-style LM (qwen2_7b's family
cut to 8 layers of width 512, vocab 4096, float32) for a few hundred
steps on the synthetic Markov corpus: config -> init -> ``build_train_step``
-> the WSD schedule -> ``resilient_loop`` with the async
``CheckpointManager`` (every 100 steps and at the end; the state saved
as ``{"params", "opt"}``, as the train CLI saves it).  It starts from
the train CLI's ``launch.train.setup``.  The loss falls from ~ln(V)
toward the corpus entropy.  The weights are the port's own seeded init.
Runs on the GPU unless ``--device cpu``.  ``--ckpt-dir`` defaults to a fresh temporary
directory; a directory that holds a checkpoint is resumed from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import torch

from . import resolve_device
from .checkpoint.manager import CheckpointManager
from .configs import get_config
from .core.drift import flatten
from .data.synthetic import DataConfig
from .launch.train import setup
from .optim import adamw
from .optim.schedules import wsd
from .runtime.fault_tolerance import resilient_loop


def hundred_m_config():
    base = get_config("qwen2_7b")
    return dataclasses.replace(
        base, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048,
        vocab_size=4096, scan_remat=False, activation_dtype=torch.float32)


def main(argv=None):
    """Returns the step losses and ``resilient_loop``'s report."""
    p = argparse.ArgumentParser(description="Train the ~100M LM on the "
                                "synthetic corpus")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = hundred_m_config()
    opt_cfg = adamw.AdamWConfig(
        lr=wsd(3e-4, warmup=20, stable=int(args.steps * 0.6),
               decay=int(args.steps * 0.3)))
    # a 512-symbol Markov corpus is learnable within a few hundred steps
    # (token ids stay valid for the 4096-entry model vocab)
    data = DataConfig(vocab_size=512, seq_len=args.seq,
                      global_batch=args.batch, seed=0)
    params, opt, batch_fn, step_fn = setup(cfg, opt_cfg, data, seed=0,
                                           device=dev)
    n_params = sum(x.numel() for _, x in flatten(params))
    print(f"[100m] params: {n_params / 1e6:.1f}M")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="nldpe_100m_ckpt")
    manager = CheckpointManager(ckpt_dir, keep=2, async_write=True)

    losses = []

    def one_step(state, i):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(state["params"], state["opt"],
                                       batch_fn(i))
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % 20 == 0:
            print(f"[100m] step {i:4d} loss {loss:.4f} lr "
                  f"{float(metrics['lr']):.2e} "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        return {"params": params, "opt": opt}

    _, report = resilient_loop(one_step, {"params": params, "opt": opt},
                               steps=args.steps,
                               manager=manager, ckpt_every=100)
    manager.wait()
    if losses:
        print(f"[100m] done. loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(restarts={report.restarts}, stragglers="
              f"{len(report.straggler_events)})")
    if args.steps >= 200 and not losses[-1] < losses[0] * 0.8:
        raise RuntimeError("training did not learn: loss "
                           f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses, report


if __name__ == "__main__":
    main()

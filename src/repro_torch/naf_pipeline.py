"""The four-step NAF pipeline (paper Fig 8) on a small end-to-end model:
the port's counterpart of ``examples/naf_pipeline.py``.

    PYTHONPATH=src python -m repro_torch.naf_pipeline [--device cpu]

Step 1 — crossbar NAF: fine-tune a small LM with Eq-6 weight noise
         injected every iteration and the Eq-8 loss (A-SL residual
         regularizer).
Step 2/3 — extract non-VMM ops and train per-bit DTs (the activation zoo).
Step 4 — per-DT ACAM NAF under threshold noise (every evaluation through
         kernel D on the card).
Finally: the model with all analog numerics enabled, the Table III stage
pattern at laptop scale.  Reduced MiniCPM-2B in float32, the reference's
seeds and step counts; the weights are the port's own seeded init (the
reference draws them with ``jax.random``).  Runs on the GPU unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from . import resolve_device
from .configs import get_config
from .core import dt, noise
from .core.engine import NLDPEConfig
from .core.naf import corrupt_table, finetune_table, inject_crossbar_noise
from .data.synthetic import DataConfig, make_batch_fn
from .launch import prng
from .launch.train import build_train_step
from .models import lm
from .optim import adamw

PRETRAIN_STEPS = 60
NAF_STEPS = 30


def eval_loss(params, cfg, batch_fn, nldpe, steps=4, noisy_weights=False):
    total = 0.0
    with torch.no_grad():
        for i in range(steps):
            batch = batch_fn(100 + i)
            run_params = params
            if noisy_weights:
                key = prng.prng_key(9).to(batch["tokens"].device)
                run_params = inject_crossbar_noise(prng.fold_in(key, i),
                                                   params)
            logits = lm.forward(run_params, batch["tokens"], cfg,
                                mode="train", nldpe=nldpe)
            total += float(lm.lm_loss(logits, batch["labels"]))
    return total / steps


def main(device=None) -> dict:
    """Run the four stages on ``device`` (the GPU by default); prints each
    stage's loss or MSE and returns them."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config("minicpm_2b", reduced=True),
                              activation_dtype=torch.float32)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    batch_fn = make_batch_fn(data, device=dev)
    params = lm.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    opt = adamw.init(params)
    out = {}

    # baseline pretraining (stands in for the downloaded pretrained model)
    pre = build_train_step(cfg, adamw.AdamWConfig(lr=2e-3))
    for i in range(PRETRAIN_STEPS):
        params, opt, _ = pre(params, opt, batch_fn(i))
    off = NLDPEConfig(enabled=False)
    out["fp32_loss"] = eval_loss(params, cfg, batch_fn, off)
    out["noisy_loss"] = eval_loss(params, cfg, batch_fn, off,
                                  noisy_weights=True)
    print(f"[naf] FP32 loss {out['fp32_loss']:.4f} | + crossbar noise "
          f"{out['noisy_loss']:.4f}")

    # Step 1: crossbar NAF (noise-injected fine-tuning, Eq 8)
    naf_step = build_train_step(cfg, adamw.AdamWConfig(lr=5e-4), naf=True)
    opt = adamw.init(params)
    for i in range(NAF_STEPS):
        params, opt, _ = naf_step(params, opt, batch_fn(1000 + i))
    out["step1_noisy_loss"] = eval_loss(params, cfg, batch_fn, off,
                                        noisy_weights=True)
    print(f"[naf] step-1 crossbar NAF: noisy-weight loss "
          f"{out['noisy_loss']:.4f} -> {out['step1_noisy_loss']:.4f}")

    # Steps 2-3: convert non-VMM ops to DTs (activation zoo) and check the
    # quantized-DT model end to end
    out["dt_loss"] = eval_loss(params, cfg, batch_fn,
                               NLDPEConfig(enabled=True))
    print(f"[naf] steps 2-3 (DT-ACAM numerics): loss {out['dt_loss']:.4f}")

    # Step 4: per-DT ACAM NAF — repair a persistent bad programming pass
    model = noise.DEFAULT.rescale(2.0)
    bad = corrupt_table(dt.build_table("silu"), prng.prng_key(11),
                        noise.DEFAULT.rescale(6.0), device=dev)
    res = finetune_table(bad, rng=prng.prng_key(1), model=model, epochs=5,
                         samples=2000, device=dev)
    out.update(step4_mse_before=res.mse_before, step4_mse_after=res.mse_after)
    print(f"[naf] step-4 per-DT NAF (silu, corrupted device): MSE "
          f"{res.mse_before:.2e} -> {res.mse_after:.2e}")
    print("naf pipeline OK")
    return out


def cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    main(p.parse_args(argv).device)


if __name__ == "__main__":
    cli()

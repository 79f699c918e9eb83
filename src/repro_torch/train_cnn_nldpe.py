"""The CNN side of the paper on the port: the counterpart of
``examples/train_cnn_nldpe.py``.

    PYTHONPATH=src python -m repro_torch.train_cnn_nldpe [--device cpu]

Trains a small ResNet-style CNN (``models/cnn.py``) on the synthetic
texture task (``data/images.py``) in float32 numerics, evaluates it
through the NL-DPE path (im2col conv-as-crossbar, log-domain DMMul —
kernel G on the card —, ACAM ReLU) and under 6x RRAM weight noise, then
repairs the noise with crossbar NAF (step 1: noise-injected fine-tuning,
trained straight through).  The example's configuration, seeds and step
counts; the weights are the port's own seeded init.  Runs on the GPU
unless ``--device cpu``, with TF32 off for matmuls and convolutions, so
that ``OFF`` is float32 on the card too.

``train_step`` and ``naf_step`` are the example's jitted steps as
functions; like the LM train step they update ``params`` and ``opt`` in
place and return them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import resolve_device
from .core import noise
from .core.drift import flatten
from .core.engine import NLDPEConfig
from .core.naf import inject_crossbar_noise, unflatten
from .data.images import ImageDataConfig, make_batch_fn
from .launch import prng
from .launch.train import _sync
from .models import cnn
from .optim import adamw

TRAIN_STEPS = 120
NAF_STEPS = 50
NOISE_SCALE = 6.0
EVAL_DRAWS = 3          # batches (and noise draws) per accuracy
EXAMPLE_CFG = cnn.CNNConfig(stage_channels=(8, 16), blocks_per_stage=1,
                            num_classes=8)


def _loss_and_grads(params: dict, run: list, batch: dict,
                    cfg: cnn.CNNConfig):
    """The loss of ``forward`` on the run leaves ``run`` (flatten order)
    and its gradients as a tree of ``params``'s structure."""
    run = [t.detach().requires_grad_() for t in run]
    loss = cnn.cnn_loss(cnn.forward(unflatten(params, run), batch["images"],
                                    cfg), batch["labels"])
    loss.backward()
    grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in run]
    return loss.detach(), unflatten(params, grads)


def train_step(params: dict, opt: dict, batch: dict, cfg: cnn.CNNConfig,
               opt_cfg: adamw.AdamWConfig):
    """One AdamW step on ``cnn_loss(forward(params, images))`` under
    ``OFF``; returns (params, opt, loss)."""
    loss, grads = _loss_and_grads(params, [w for _, w in flatten(params)],
                                  batch, cfg)
    params, opt, _ = adamw.update(opt_cfg, grads, opt, params)
    return params, opt, loss


def naf_step(params: dict, opt: dict, batch: dict, key: torch.Tensor,
             cfg: cnn.CNNConfig, opt_cfg: adamw.AdamWConfig,
             model: noise.NoiseModel):
    """One crossbar-NAF step: the forward on ``p + stop_gradient(pn -
    p)`` with ``pn = inject_crossbar_noise(key, p, model)`` (the gradient
    reaches ``p`` as the identity); returns (params, opt, loss)."""
    noisy = inject_crossbar_noise(key, params, model=model)
    run = [w + (n - w) for (_, w), (_, n) in zip(flatten(params),
                                                 flatten(noisy))]
    loss, grads = _loss_and_grads(params, run, batch, cfg)
    params, opt, _ = adamw.update(opt_cfg, grads, opt, params)
    return params, opt, loss


def main(cfg: cnn.CNNConfig = EXAMPLE_CFG, data: ImageDataConfig | None = None,
         device=None) -> dict:
    """Train, evaluate and repair ``cfg`` on ``data`` (the example's: batch
    24, noise 0.9) on ``device`` (the GPU by default); prints the stages
    and returns the losses, accuracies and seconds per step."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if data is None:
        data = ImageDataConfig(num_classes=cfg.num_classes, batch=24,
                               noise=0.9)
    batch_fn = make_batch_fn(data, device=dev)
    params = cnn.init_params(cfg, device=dev)
    opt = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        params, opt, loss = train_step(params, opt, batch_fn(i), cfg, opt_cfg)
        losses.append(float(loss))
        if i % 30 == 0:
            print(f"[cnn] step {i:3d} loss {losses[-1]:.3f}")
    _sync(dev)
    train_s = (time.perf_counter() - t0) / TRAIN_STEPS
    model = noise.DEFAULT.rescale(NOISE_SCALE)

    def acc(p, nldpe=NLDPEConfig(enabled=False), noisy=False,
            draws=EVAL_DRAWS):
        vals = []
        with torch.no_grad():
            for i in range(draws):
                run = p
                if noisy:
                    run = inject_crossbar_noise(
                        prng.prng_key(100 + i).to(dev), p, model=model)
                b = batch_fn(700 + i)
                vals.append(float(cnn.accuracy(
                    cnn.forward(run, b["images"], cfg, nldpe=nldpe),
                    b["labels"])))
        return float(np.mean(vals))

    out = {"losses": losses, "fp32_acc": acc(params),
           "nldpe_acc": acc(params, NLDPEConfig(enabled=True)),
           "noisy_acc": acc(params, noisy=True)}
    print(f"[cnn] accuracy fp32={out['fp32_acc']:.3f} | NL-DPE numerics="
          f"{out['nldpe_acc']:.3f} | +{NOISE_SCALE:g}x weight noise="
          f"{out['noisy_acc']:.3f} (chance={1 / cfg.num_classes:.3f})")

    # NAF step 1: noise-injected fine-tuning
    opt = adamw.init(params)
    naf_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(NAF_STEPS):
        params, opt, _ = naf_step(params, opt, batch_fn(2000 + i),
                                  prng.prng_key(i).to(dev), cfg, naf_cfg,
                                  model)
    _sync(dev)
    out["train_s_per_step"] = train_s
    out["naf_s_per_step"] = (time.perf_counter() - t0) / NAF_STEPS
    out["naf_acc"] = acc(params, noisy=True)
    print(f"[cnn] after crossbar NAF: noisy accuracy {out['noisy_acc']:.3f} "
          f"-> {out['naf_acc']:.3f}")
    print("cnn example OK")
    return out


def cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    return main(device=p.parse_args(argv).device)


if __name__ == "__main__":
    cli()

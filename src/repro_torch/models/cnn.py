"""CNN substrate, the paper's other half (port of ``repro.models.cnn``).

The paper maps convolutions onto crossbars through im2col (§V: "DMMul is
modeled as a grouped convolutional layer"), with ACAMs computing the ReLU
per output column.  A ResNet-style residual CNN over dict trees of
parameters, with ``repro``'s tree and layouts, so that
``convert.from_jax`` carries ``repro``'s weights across leaf by leaf:
images NHWC, conv weights HWIO ``(k, k, cin, cout)`` with a bias, RMSNorm
``{"scale"}``, the head ``{"w", "b"}``.  Each conv runs one of two ways:

* ``OFF`` (or ``logdomain_dmmul`` off): ``torch.nn.functional.conv2d`` of
  the NCHW view on an explicit pad, the counterpart of
  ``lax.conv_general_dilated`` (which ``repro`` computes outside Pallas).
  Padding is XLA's SAME: ``pad_total = (out - 1) * stride + k - in``,
  ``total // 2`` low and the rest high, so asymmetric at stride 2 (32 ->
  16 at k = 3 pads (0, 1)); PyTorch's ``padding="same"`` refuses stride 2
  and a symmetric pad would shift every output.  A float32 conv on the
  card runs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off:
  the CNN's entry point turns it off.
* NL-DPE: ``_im2col`` (patch columns in ``repro``'s ``(dy, dx, c)``
  order, which ``w.reshape(k * k * cin, cout)`` matches, so the K sum
  runs in the reference's order; ``F.unfold`` would order ``(c, dy,
  dx)``), then ``NLDPEConfig.dmmul``: the 8-bit log-quantized crossbar
  matmul, kernel G on the card.

The activations are ``nldpe.activation`` (the ACAM's piecewise path under
``ON``).  ``init_params`` draws ``repro``'s distributions on a CPU
``torch.Generator`` and moves the result, so a run on the card and one on
the CPU start from the same weights.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core.drift import flatten
from ..core.engine import OFF, NLDPEConfig
from ..core.naf import unflatten
from ..nn.basic import rmsnorm_apply


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "resnet-mini"
    num_classes: int = 10
    in_channels: int = 3
    stem_channels: int = 16
    stage_channels: tuple = (16, 32, 64)
    blocks_per_stage: int = 2
    img_size: int = 32
    act: str = "relu"


def conv_init(generator: torch.Generator, cin: int, cout: int,
              k: int = 3) -> dict:
    """``{"w": (k, k, cin, cout), "b": (cout,)}`` on the CPU: normal x
    ``(k * k * cin)^-1/2``, zero bias."""
    w = torch.randn((k, k, cin, cout), generator=generator)
    return {"w": w.mul_((k * k * cin) ** -0.5), "b": torch.zeros(cout)}


def same_pads(n: int, k: int, stride: int) -> tuple[int, int, int]:
    """XLA's SAME padding of one spatial axis: (out, low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return out, total // 2, total - total // 2


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, k*k*C) patches (each output pixel is
    one word-line activation vector), columns in ``(dy, dx, c)`` order."""
    _, h, w, _ = x.shape
    ho, ph_lo, ph_hi = same_pads(h, k, stride)
    wo, pw_lo, pw_hi = same_pads(w, k, stride)
    xp = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    patches = [xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                  dx:dx + (wo - 1) * stride + 1:stride, :]
               for dy in range(k) for dx in range(k)]
    return torch.cat(patches, dim=-1)


def conv_apply(p: dict, x: torch.Tensor, stride: int = 1,
               nldpe: NLDPEConfig = OFF) -> torch.Tensor:
    """Conv of NHWC ``x`` with HWIO ``p["w"]`` (SAME padding) plus bias;
    NL-DPE mode = im2col + log-quantized crossbar matmul."""
    k = p["w"].shape[0]
    if nldpe.enabled and nldpe.logdomain_dmmul:
        cols = _im2col(x, k, stride)                        # (B,Ho,Wo,kkC)
        b, ho, wo, kk = cols.shape
        wmat = p["w"].to(torch.float32).reshape(kk, -1)
        y = nldpe.dmmul(cols.reshape(-1, kk).to(torch.float32), wmat)
        y = y.reshape(b, ho, wo, -1)
    else:
        _, ph_lo, ph_hi = same_pads(x.shape[1], k, stride)
        _, pw_lo, pw_hi = same_pads(x.shape[2], k, stride)
        xp = F.pad(x.permute(0, 3, 1, 2), (pw_lo, pw_hi, ph_lo, ph_hi))
        y = F.conv2d(xp, p["w"].to(x.dtype).permute(3, 2, 0, 1),
                     stride=stride).permute(0, 2, 3, 1)
    return y + p["b"].to(y.dtype)


def block_init(generator: torch.Generator, cin: int, cout: int) -> dict:
    p = {"conv1": conv_init(generator, cin, cout),
         "conv2": conv_init(generator, cout, cout),
         "norm1": {"scale": torch.ones(cout)},
         "norm2": {"scale": torch.ones(cout)}}
    if cin != cout:
        p["proj"] = conv_init(generator, cin, cout, k=1)
    return p


def block_apply(p: dict, x: torch.Tensor, stride: int, cfg: CNNConfig,
                nldpe: NLDPEConfig = OFF) -> torch.Tensor:
    h = conv_apply(p["conv1"], x, stride=stride, nldpe=nldpe)
    h = nldpe.activation(rmsnorm_apply(p["norm1"], h), cfg.act).to(x.dtype)
    h = conv_apply(p["conv2"], h, nldpe=nldpe)
    h = rmsnorm_apply(p["norm2"], h)
    if "proj" in p:
        x = conv_apply(p["proj"], x, stride=stride, nldpe=nldpe)
    elif stride > 1:
        x = x[:, ::stride, ::stride, :]
    return nldpe.activation(x + h.to(x.dtype), cfg.act).to(x.dtype)


def init_params(cfg: CNNConfig, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters with ``repro``'s tree and distributions (normal x
    ``(k*k*cin)^-1/2`` conv weights, normal x ``cin^-1/2`` head, zero
    biases, unit norm scales), drawn on a CPU ``generator`` (seed 0 by
    default) and moved to ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if generator.device.type != "cpu":
        raise ValueError("cnn.init_params draws on a CPU generator, so that "
                         "the card and the CPU start from the same weights")
    params = {"stem": conv_init(generator, cfg.in_channels,
                                cfg.stem_channels)}
    cin = cfg.stem_channels
    for s, cout in enumerate(cfg.stage_channels):
        for b in range(cfg.blocks_per_stage):
            params[f"s{s}b{b}"] = block_init(generator, cin, cout)
            cin = cout
    w = torch.randn((cin, cfg.num_classes), generator=generator)
    params["head"] = {"w": w.mul_(cin ** -0.5),
                      "b": torch.zeros(cfg.num_classes)}
    return unflatten(params, [w.to(device) for _, w in flatten(params)])


def forward(params: dict, images: torch.Tensor, cfg: CNNConfig,
            nldpe: NLDPEConfig = OFF) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, num_classes) float32."""
    x = conv_apply(params["stem"], images, nldpe=nldpe)
    x = nldpe.activation(x, cfg.act).to(images.dtype)
    for s in range(len(cfg.stage_channels)):
        for b in range(cfg.blocks_per_stage):
            stride = 2 if (b == 0 and s > 0) else 1
            x = block_apply(params[f"s{s}b{b}"], x, stride, cfg, nldpe)
    x = torch.mean(x, dim=(1, 2))                           # global avg pool
    return (x.to(torch.float32) @ params["head"]["w"].to(torch.float32)
            + params["head"]["b"].to(torch.float32))


def cnn_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
    return torch.mean(lse - gold)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels.long())
                      .to(torch.float32))

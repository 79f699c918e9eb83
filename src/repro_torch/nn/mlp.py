"""Gated feed-forward block with NL-DPE activations (port of
``repro.nn.mlp.mlp_apply``)."""
from __future__ import annotations

import torch

from ..core.engine import NLDPEConfig, OFF


def mlp_apply(p: dict, x: torch.Tensor, act: str = "silu",
              nldpe: NLDPEConfig = OFF) -> torch.Tensor:
    """Gated SiLU MLP: down(act(x @ gate) * (x @ up)).  Under ``FUSED`` the
    gate Linear + ACAM activation is one crossbar->ACAM kernel pass and the
    product is a log-domain DMMul."""
    if "gate" in p:
        h = x @ p["up"].to(x.dtype)
        g = nldpe.linear_activation(x, p["gate"], act)
        h = nldpe.elementwise_mul(g, h)
    else:
        h = nldpe.linear_activation(x, p["up"], act)
    return h.to(x.dtype) @ p["down"].to(x.dtype)

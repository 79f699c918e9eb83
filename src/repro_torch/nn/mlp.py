"""Gated feed-forward block with NL-DPE activations (port of
``repro.nn.mlp.mlp_apply``)."""
from __future__ import annotations

import torch

from ..core.engine import NLDPEConfig, OFF
from ..parallel.context import enter, global_absmax, reduce_partial, shard


def mlp_apply(p: dict, x: torch.Tensor, act: str = "silu",
              nldpe: NLDPEConfig = OFF, d_ff: int | None = None
              ) -> torch.Tensor:
    """Gated SiLU MLP: down(act(x @ gate) * (x @ up)).  Under ``FUSED`` the
    gate Linear + ACAM activation is one crossbar->ACAM kernel pass and the
    product is a log-domain DMMul.

    Under a sharding context the gate and up hold this rank's columns of
    the ``d_ff`` (global; default the down projection's rows) ("mlp"), so
    kernel B runs on the column shard, programmed against the whole
    weight's largest magnitude (an all-reduce max: each column's
    conductances are the unsharded weight's).  At the contraction
    boundary ("mlp_in") the exact tables gather the columns before the
    down projection; ``train`` and ``serve`` multiply them by this rank's
    rows of ``down`` and all-reduce the partial sums."""
    w = p["gate"] if "gate" in p else p["up"]
    d_ff = d_ff or p["down"].shape[0]
    x = enter(x, "mlp", d_ff, w.shape[-1])
    w_max = global_absmax(w, d_ff) if nldpe.fused_linear else None
    if "gate" in p:
        h = x @ p["up"].to(x.dtype)
        g = nldpe.linear_activation(x, w, act, w_max=w_max)
        h = nldpe.elementwise_mul(g, h)
    else:
        h = nldpe.linear_activation(x, w, act, w_max=w_max)
    h = shard(h, "batch", None, "mlp_in", src=("batch", None, "mlp"),
              full=(None, None, d_ff))
    y = h.to(x.dtype) @ p["down"].to(x.dtype)
    return reduce_partial(y, "mlp_in", d_ff, p["down"].shape[0])

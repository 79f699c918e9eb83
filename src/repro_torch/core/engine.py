"""NLDPEConfig: the model-level switch for NL-DPE execution (port of
``repro.core.engine``).

Model code calls the dispatchers here (``activation``,
``linear_activation``, ``elementwise_mul``, ``attention``), which pick the
NL-DPE path or the float reference according to the config:

* ``OFF``   — float reference numerics;
* ``ON``    — ACAM activations (piecewise fast path), log-domain DMMul and
              the NL-DPE softmax;
* ``FUSED`` — ``ON`` with every Linear+activation pair in one crossbar->ACAM
              pass: the hand-written kernel of ``kernels/dual_compute`` on
              the GPU (the paper's ADC-free dataflow).

The streamed log-domain flash attention that ``FUSED`` uses for maskless
(train/lockstep prefill) attention in ``repro`` is not ported yet; every
attention call on the paged serve path carries a validity mask and runs
the materialized ``nldpe_attention`` there as well.
"""
from __future__ import annotations

import dataclasses

import torch

from .acam import acam_activation
from .attention import nldpe_attention
from .functions import TORCH_FUNCTIONS
from .logdomain import DEFAULT_CFG, nldpe_mul


BITS = 8    # ACAM resolution of every activation table


@dataclasses.dataclass(frozen=True)
class NLDPEConfig:
    enabled: bool = False
    fused_dual_compute: bool = False

    def activation(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.enabled:
            return acam_activation(x, name, bits=BITS)
        return TORCH_FUNCTIONS[name](x)

    def linear_activation(self, x: torch.Tensor, w: torch.Tensor,
                          name: str) -> torch.Tensor:
        """act(x @ w) — one fused crossbar->ACAM pass when configured
        (``w`` must then be the float32 master weight)."""
        if self.enabled and self.fused_dual_compute:
            from ..kernels.dual_compute.ops import fused_linear_acam
            return fused_linear_acam(x, w, name, bits=BITS).to(x.dtype)
        return self.activation(x @ w.to(x.dtype), name)

    def elementwise_mul(self, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
        if self.enabled:
            return nldpe_mul(a, b, DEFAULT_CFG)
        return a * b

    def attention(self, q, k, v, mask: torch.Tensor) -> torch.Tensor:
        """Masked, non-causal attention over a cache view; K/V carry as
        many heads as Q (the paged path folds GQA groups into rows)."""
        if not self.enabled:
            raise NotImplementedError(
                "float attention over a dense cache view is not ported; "
                "OFF attends through kernels.paged_attention")
        return nldpe_attention(q, k, v, DEFAULT_CFG, causal=False, mask=mask)


OFF = NLDPEConfig(enabled=False)
ON = NLDPEConfig(enabled=True)
FUSED = NLDPEConfig(enabled=True, fused_dual_compute=True)

"""NLDPEConfig: the model-level switch for NL-DPE execution (port of
``repro.core.engine``).

Model code calls the dispatchers here (``activation``,
``linear_activation``, ``softmax``, ``dmmul``, ``elementwise_mul``,
``attention``), which pick the NL-DPE path or the float reference
according to the config:

* ``OFF``   — float reference numerics;
* ``ON``    — ACAM activations (piecewise fast path), log-domain DMMul and
              the NL-DPE softmax;
* ``FUSED`` — ``ON`` with every Linear+activation pair in one crossbar->ACAM
              pass: the hand-written kernel of ``kernels/dual_compute`` on
              the GPU (the paper's ADC-free dataflow).

The ablation switches pick which op classes run on the analog engine:
``acam_activations`` (activations and the fused Linear+activation),
``logdomain_dmmul`` (DMMul, element-wise products and NL-DPE attention)
and ``acam_softmax`` (the standalone softmax).  ``bits`` is the ACAM
resolution of every activation table, ``logdomain`` the grids of the
DMMul/softmax pipeline.

``attention`` sends maskless causal attention (whole-prompt lockstep
prefill) under ``FUSED`` through the streamed log-domain flash attention of
``kernels/dual_compute`` (kernel C); masked attention over a cache view
runs the materialized ``nldpe_attention``; ``OFF`` runs
``reference_attention``.
"""
from __future__ import annotations

import dataclasses

import torch

from .acam import acam_activation
from .attention import nldpe_attention, reference_attention
from .functions import TORCH_FUNCTIONS
from .logdomain import (DEFAULT_CFG, LogDomainConfig, nldpe_matmul,
                        nldpe_mul, nldpe_softmax)


@dataclasses.dataclass(frozen=True)
class NLDPEConfig:
    enabled: bool = False
    bits: int = 8
    logdomain: LogDomainConfig = DEFAULT_CFG
    # which op classes run on the analog engine (ablation switches)
    acam_activations: bool = True
    logdomain_dmmul: bool = True
    acam_softmax: bool = True
    # crossbar->ACAM and attention as single passes (the ADC-free
    # dataflow); off = the two-kernel path with the same numerics
    fused_dual_compute: bool = False

    def activation(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.enabled and self.acam_activations:
            return acam_activation(x, name, bits=self.bits)
        return TORCH_FUNCTIONS[name](x)

    @property
    def fused_linear(self) -> bool:
        """Whether ``linear_activation`` takes the fused crossbar->ACAM
        pass (kernel B), which programs the float32 master weight."""
        return (self.enabled and self.acam_activations
                and self.fused_dual_compute)

    def linear_activation(self, x: torch.Tensor, w: torch.Tensor,
                          name: str, w_max=None) -> torch.Tensor:
        """act(x @ w) — one fused crossbar->ACAM pass when configured
        (``w`` must then be the float32 master weight; ``w_max``, where
        given, the largest magnitude the crossbar is programmed against,
        default ``w``'s own)."""
        if self.fused_linear:
            from ..kernels.dual_compute.ops import fused_linear_acam
            return fused_linear_acam(x, w, name, bits=self.bits,
                                     w_max=w_max).to(x.dtype)
        return self.activation(x @ w.to(x.dtype), name)

    def softmax(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        if self.enabled and self.acam_softmax:
            return nldpe_softmax(x, self.logdomain, axis=axis)
        return torch.softmax(x, dim=axis)

    def dmmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b; on the analog engine ``nldpe_matmul(mode="fused")``:
        kernel G (``kernels/nldpe_qmatmul``) for CUDA tensors — ``a``'s
        leading dimensions flattened against a 2-D ``b``; another rank, or
        a call that needs a gradient (G has no backward), raises — and the
        plain route for CPU tensors."""
        if not (self.enabled and self.logdomain_dmmul):
            return torch.matmul(a, b)
        if a.device.type == "cpu":
            return nldpe_matmul(a, b, self.logdomain, mode="fused")
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            raise NotImplementedError(
                "NLDPEConfig.dmmul: kernel G has no backward (no reference "
                "path trains through the log-domain DMMul)")
        if a.dim() < 2 or b.dim() != 2:
            raise ValueError(f"NLDPEConfig.dmmul on {a.device.type}: kernel "
                             f"G takes a (..., M, K) against a (K, N) b, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        from ..kernels.nldpe_qmatmul import ops
        out = ops.nldpe_matmul_int8(a.reshape(-1, a.shape[-1]), b,
                                    self.logdomain)
        return out.reshape(*a.shape[:-1], b.shape[1])

    def elementwise_mul(self, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
        if self.enabled and self.logdomain_dmmul:
            return nldpe_mul(a, b, self.logdomain, mode="fused")
        return a * b

    def attention(self, q, k, v, causal: bool = True,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
        """k/v may carry fewer (grouped) heads than q: the fused kernel
        takes them as they are, the materialized paths repeat them."""
        if (self.enabled and self.logdomain_dmmul and self.fused_dual_compute
                and mask is None):
            from ..kernels.dual_compute.ops import logdomain_flash_attention
            return logdomain_flash_attention(q, k, v, self.logdomain,
                                             causal=causal)
        if k.shape[1] != q.shape[1]:
            group = q.shape[1] // k.shape[1]
            k = torch.repeat_interleave(k, group, dim=1)
            v = torch.repeat_interleave(v, group, dim=1)
        if self.enabled and self.logdomain_dmmul:
            return nldpe_attention(q, k, v, self.logdomain, causal=causal,
                                   mask=mask)
        return reference_attention(q, k, v, causal=causal, mask=mask)


OFF = NLDPEConfig(enabled=False)
ON = NLDPEConfig(enabled=True)
FUSED = NLDPEConfig(enabled=True, fused_dual_compute=True)

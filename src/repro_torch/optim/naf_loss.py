"""Eq 8 — the A-SL-aware NAF loss for crossbar fine-tuning (paper §IV-B;
port of ``repro.optim.naf_loss``).

    Loss = MSE(y, y_hat) + lambda1 * ||W||_inf + lambda2 * ||eps||_inf

||W||_inf pushes weights toward smaller target conductances (lower noise
per Fig 7a/b); ||eps||_inf bounds the A-SL residual the second cell must
absorb.  ``eps`` comes from the noise-injection pass (``core.naf``).  The
max can be smoothed with logsumexp.  A plain max sends its gradient to the
arg-max elements, split evenly over ties, as the reference's ``jnp.max``
does.  These take whole trees; the full-width train step computes the
same terms chunk by chunk (``launch/train.py``).
"""
from __future__ import annotations

import torch

from ..core.drift import flatten


def linf(tree, smooth: float = 0.0) -> torch.Tensor:
    leaves = [x.to(torch.float32).reshape(-1) for _, x in flatten(tree)]
    flat = torch.cat(leaves) if leaves else torch.zeros((1,))
    a = torch.abs(flat)
    if smooth > 0:
        return smooth * torch.logsumexp(a / smooth, dim=0)
    return torch.amax(a)


def eq8_loss(task_loss: torch.Tensor, params, eps_tree=None,
             lambda1: float = 1e-4, lambda2: float = 1e-4,
             smooth: float = 0.0) -> tuple[torch.Tensor, dict]:
    w_inf = linf(params, smooth)
    e_inf = (linf(eps_tree, smooth) if eps_tree is not None
             else torch.tensor(0.0, device=w_inf.device))
    total = task_loss + lambda1 * w_inf + lambda2 * e_inf
    return total, {"w_inf": w_inf, "eps_inf": e_inf}

"""Pipeline parallelism over the pod axis (GPipe, port of
``repro.parallel.pipeline``).

The multi-pod mesh's "pod" axis is data parallel by default; this module
uses it as a pipeline axis: stage ``s`` of ``K`` holds its layer stage's
parameters and microbatches stream through the stages, each stage handing
its activation to the next one by ``send``/``recv``.  Where ``repro``'s
``ppermute`` differentiates into the reverse pipeline, the port's hand-off
is an autograd Function (``_Shift``) whose backward sends the input's
gradient back to the previous stage and receives the output's from the
next, so ``backward`` of a pipelined loss runs the backward pipeline.

Schedule: T = M + K - 1 ticks for M microbatches over K stages; stage
``s`` runs microbatch ``t - s`` at tick ``t``; bubble fraction
(K - 1) / T (``bubble_fraction``).  The last stage's outputs are
broadcast to every stage.
"""
from __future__ import annotations

import torch


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _peer(mesh, axis: str, stage: int) -> int:
    """The global rank of the stage ``stage`` of this rank's pipeline
    (every other coordinate this rank's)."""
    axes = list(mesh.shape)
    stride = 1
    for a in axes[axes.index(axis) + 1:]:
        stride *= mesh.shape[a]
    return mesh.rank + (stage - mesh.coords[axis]) * stride


class _Shift(torch.autograd.Function):
    """One tick's hand-off: send this stage's output ``y`` to the next
    stage (``dst``, or None) and receive the previous stage's (``src``, or
    None) — the next tick's input, autograd-linked to ``y``.  Backward:
    send the received input's gradient back to ``src`` and receive
    ``y``'s from ``dst``."""

    @staticmethod
    def forward(ctx, y, mesh, src, dst):
        import torch.distributed as dist
        ctx.args = (mesh, src, dst)
        out = torch.zeros_like(y)
        reqs = []
        if dst is not None:
            mesh._count(y)
            reqs.append(dist.isend(y.contiguous(), dst))
        if src is not None:
            reqs.append(dist.irecv(out, src))
        for r in reqs:
            r.wait()
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        mesh, src, dst = ctx.args
        gy = torch.zeros_like(g)
        reqs = []
        if src is not None:
            mesh._count(g)
            reqs.append(dist.isend(g.contiguous(), src))
        if dst is not None:
            reqs.append(dist.irecv(gy, dst))
        for r in reqs:
            r.wait()
        return gy, None, None, None


class _Broadcast(torch.autograd.Function):
    """``x`` of the rank ``src`` on every rank of ``group``; backward: the
    gradient on ``src`` (every rank computes the same loss from it)."""

    @staticmethod
    def forward(ctx, x, mesh, src, group):
        import torch.distributed as dist
        ctx.mine = mesh.rank == src
        out = x.detach().clone().contiguous()
        mesh._count(out)
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else None), None, None, None


def pipeline_forward(stage_params, x_micro, body_fn, mesh, axis: str = "pod"):
    """Run microbatches through the stages of ``axis``.

    stage_params: this rank's stage — a tree whose leaves lead with the
    stage axis split over ``axis`` (length 1 here: the slice of the
    (n_stages, ...) stack this stage holds).  x_micro: (M, mb, ...)
    microbatches, the same on every stage.  body_fn(params, x) -> y, x's
    shape.  Returns the (M, mb, ...) outputs of the last stage on every
    stage (differentiable: ``pipeline_loss``)."""
    k, s = mesh.shape[axis], mesh.coords[axis]
    m = x_micro.shape[0]
    params = {n: v[0] for n, v in stage_params.items()}
    nxt = _peer(mesh, axis, s + 1) if s < k - 1 else None
    prv = _peer(mesh, axis, s - 1) if s > 0 else None
    state, outs, loose = None, [], []
    for t in range(m + k - 1):
        if not s <= t < s + m:               # this stage idles this tick
            if prv is not None and s - 1 <= t < s - 1 + m:
                # a placeholder in the graph, so that the backward pass
                # sends this input's gradient back
                hold = torch.zeros_like(x_micro[0]).requires_grad_(
                    torch.is_grad_enabled())
                state = _Shift.apply(hold, mesh, prv, None)
            continue
        x_in = x_micro[t] if s == 0 else state
        y = body_fn(params, x_in)
        if s == k - 1:
            outs.append(y)
        recv = prv if s - 1 <= t < s - 1 + m else None
        if nxt is not None or recv is not None:
            got = _Shift.apply(y, mesh, recv, nxt)
            if recv is not None:
                state = got
            else:
                loose.append(got)            # links the send's backward
    out = (torch.stack(outs) if outs
           else torch.zeros_like(x_micro))
    out = _Broadcast.apply(out, mesh, _peer(mesh, axis, k - 1),
                           mesh.groups[axis])
    if loose:
        out = out + 0.0 * sum(g.sum() for g in loose)
    return out


def pipeline_loss(stage_params, x_micro, y_micro, body_fn, loss_fn, mesh,
                  axis: str = "pod"):
    """Differentiable pipelined loss (its backward runs the backward
    pipeline)."""
    outs = pipeline_forward(stage_params, x_micro, body_fn, mesh, axis)
    return loss_fn(outs, y_micro)

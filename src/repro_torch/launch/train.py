"""Training step builder and the train CLI (port of ``repro.launch.train``).

``build_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: one AdamW step on the float32 masters.
Where the reference returns new trees, the step updates ``params`` and
``opt_state`` in place and returns them (a second copy of a full-width
model's masters and moments would not fit on the card).  The key for NAF
noise is ``fold_in(key(17), opt_state["step"])``, as in the reference.

Every block type of ``repro`` trains (``attn``, ``local``, ``global``,
``moe``, ``rec``, ``rwkv``), through ``lm.forward(mode="train")``: the band
or ``blockwise_attention`` (never kernel F, which has no backward), the
RG-LRU scan, the MoE dispatch and combine with its expert ``bmm``s, the
chunked WKV.  The step is ``repro``'s: ``lm_loss`` (plus Eq 8 under NAF),
no auxiliary MoE loss.

The forward runs on a *run copy* of the masters: each float32 leaf cast
once to ``cfg.activation_dtype`` (``cast_compute_dtype``), the stacked
layer leaves (``groups``, an MoE expert leaf's (n_groups, E, d, ff)
included) held as per-layer tensors so each layer's gradient lands in its
own tensor; a ``tail`` leaf is one tensor.  The gradient of a cast is the cotangent cast back, so
the masters' gradients are the run copy's upcast to float32.

NAF mode (paper §IV-B step 1, ``naf=True``): every step round-trips the
weights through Eq 6 cells (``core.naf.inject_crossbar_noise``: one key
per leaf in flatten order, both polarities, ``w_max`` the largest
|weight| of the whole stacked leaf) and trains on them straight through
(``p + stop_gradient(n - p)``: identity backward into the master), with
Eq 8's regularizers ``lambda1 * ||W||_inf + lambda2 * ||eps||_inf``,
``eps = n - p``.  The noisy weights are never held in float32: the run
copy is written chunk by chunk (``core.drift.CHUNK`` elements, the draws
at counter offsets, bit for bit the whole-leaf draw) in the compute
dtype, and ``||eps||_inf`` is tracked on the way.  Its gradient reaches
the masters through the noise path (``n`` depends on ``p`` and on the
leaf's ``w_max``), so the arg-max elements (split evenly over ties, as
``jnp.max``) are recomputed differentiably, alone, after the pass; so are
the arg-max elements of ``||W||_inf``.

    python -m repro_torch.launch.train [--arch qwen2_7b] [--steps 50]
        [--batch 8] [--seq 64] [--nldpe] [--naf] [--schedule cosine|wsd]
        [--lr 1e-3] [--seed 0] [--ckpt-dir D] [--ckpt-every 20]
        [--fail-at-step N] [--device cpu]

runs the reduced config of ``--arch`` (any of the ten configs; as the
reference's CLI always does: the synthetic corpus's vocab x vocab
transition table fits only at reduced vocab) on the GPU unless
``--device cpu``.  With ``--ckpt-dir``
it restores ``{"params", "opt"}`` from the directory's ``LATEST`` on
start and resumes at that step, saves every ``--ckpt-every`` steps and
at the end (``checkpoint.manager``); ``--fail-at-step N`` raises at step
N, as a node failure would.  The batch is a function of the step index
and the NAF key of the restored ``opt["step"]``, so a resumed run repeats
and skips nothing: on the CPU its losses and parameters equal an
uninterrupted run's bit for bit.  ``batch_groups > 1`` is not ported yet
and raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.drift import _chunks, flatten
from ..core.engine import NLDPEConfig, OFF
from ..core.naf import leaf_amax, leaf_keys, noisy_chunk, unflatten
from ..core.noise import DEFAULT
from ..data.synthetic import DataConfig, make_batch_fn
from ..models import lm
from ..optim import adamw
from ..optim.schedules import warmup_cosine, wsd
from . import prng


def _stacked(path: tuple) -> bool:
    return path[0] == "groups"


def _run_leaf(path: tuple, buf: torch.Tensor):
    """The run copy's leaf over ``buf`` (the leaf's values in the compute
    dtype): one tensor requiring grad, or per-layer ones for a stacked
    leaf."""
    if _stacked(path):
        return [buf[i].detach().requires_grad_() for i in range(len(buf))]
    return buf.detach().requires_grad_()


def _leaf_grad(run_leaf, like: torch.Tensor) -> torch.Tensor:
    """A run leaf's gradient as a float32 tensor of the master's shape
    (zeros where the loss does not reach); the run copy's gradients are
    dropped as they are read."""
    if isinstance(run_leaf, list):
        g = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
        for i, t in enumerate(run_leaf):
            if t.grad is not None:
                g[i].copy_(t.grad)
                t.grad = None
        return g
    if run_leaf.grad is None:
        return torch.zeros(like.shape, dtype=torch.float32,
                           device=like.device)
    g = run_leaf.grad.to(torch.float32)
    run_leaf.grad = None
    return g


def _ties(flat: torch.Tensor, value: float) -> torch.Tensor:
    """Flat indices of ``flat`` where |x| == value (chunk by chunk)."""
    out = []
    for o, m in _chunks(flat.numel()):
        out.append(torch.nonzero(flat[o:o + m].abs() == value)[:, 0] + o)
    return torch.cat(out)


def _max_term(value: float, elems: list[torch.Tensor]) -> torch.Tensor:
    """``value`` (the max of |x| over a tree) whose gradient reaches each
    of ``elems`` (the differentiable arg-max elements, ties included) as
    sign(x) / count, as ``jnp.max`` sends it."""
    count = sum(e.numel() for e in elems)
    term = torch.tensor(np.float32(value), device=elems[0].device)
    for e in elems:
        a = torch.abs(e)
        term = term + torch.sum(a - a.detach()) / count
    return term


class _NAFPass:
    """One step's noisy run copy and the pieces of Eq 8 (see the module
    docstring).  ``run`` is the run copy's leaves in flatten order;
    ``inf_terms()`` builds ``(||W||_inf, ||eps||_inf)`` differentiably
    over the arg-max elements; ``add_grads(grads)`` adds their gradients
    into the masters' float32 gradients."""

    def __init__(self, key: torch.Tensor, params: dict, dtype_of):
        self.leaves = flatten(params)
        self.keys = [tuple(k.to(w.device) for k in ks) for (_, w), ks in
                     zip(self.leaves, leaf_keys(key, params))]
        self.run, self.amax = [], []
        e_best, e_sel = -1.0, []
        with torch.no_grad():
            for li, ((path, w), keys) in enumerate(zip(self.leaves,
                                                       self.keys)):
                flat = w.reshape(-1)
                amax = leaf_amax(w)
                self.amax.append(float(amax))
                wm = torch.clamp(amax, min=1e-6)
                buf = torch.empty(flat.numel(), dtype=dtype_of(w),
                                  device=w.device)
                for o, m in _chunks(flat.numel()):
                    p = flat[o:o + m]
                    d = noisy_chunk(keys, p, wm, DEFAULT, o) - p
                    buf[o:o + m] = p + d
                    e = d.abs_()
                    em = float(e.max())
                    if em >= e_best:
                        idx = torch.nonzero(e == em)[:, 0] + o
                        if em > e_best:
                            e_best, e_sel = em, []
                        e_sel.append((li, idx))
                self.run.append(_run_leaf(path, buf.view(w.shape)))
        self.e_inf, self.e_sel = e_best, e_sel
        self.w_inf = max(self.amax)
        self.w_sel = [(li, _ties(w.reshape(-1), self.w_inf))
                      for li, (_, w) in enumerate(self.leaves)
                      if self.amax[li] == self.w_inf]
        self._elems = []                   # (leaf, flat indices, tensor)

    def _take(self, li: int, idx: torch.Tensor) -> torch.Tensor:
        w = self.leaves[li][1].reshape(-1)
        t = w[idx].detach().clone().requires_grad_()
        self._elems.append((li, idx, t))
        return t

    def inf_terms(self) -> tuple[torch.Tensor, torch.Tensor]:
        w_term = _max_term(self.w_inf, [self._take(li, idx)
                                        for li, idx in self.w_sel])
        eps = []
        for li, idx in self.e_sel:
            flat = self.leaves[li][1].reshape(-1)
            wm = torch.clamp(_max_term(
                self.amax[li], [self._take(li, _ties(flat, self.amax[li]))]),
                min=1e-6)
            x = self._take(li, idx)
            for j, off in enumerate(idx.tolist()):
                xj = x[j:j + 1]
                eps.append(noisy_chunk(self.keys[li], xj, wm, DEFAULT,
                                       off) - xj)
        return w_term, _max_term(self.e_inf, eps)

    def add_grads(self, grads: list[torch.Tensor]) -> None:
        for li, idx, t in self._elems:
            if t.grad is not None:
                grads[li].view(-1).index_add_(0, idx, t.grad)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                     nldpe: NLDPEConfig = OFF, batch_groups: int = 1,
                     naf: bool = False, naf_lambda1: float = 1e-5,
                     naf_lambda2: float = 1e-5,
                     cast_compute_dtype: bool = True, timed: bool = False):
    """``train_step(params, opt_state, batch)`` for ``cfg`` (see the
    module docstring); a VLM batch's ``"patch_embeds"`` (B, P, d) go before
    its tokens, and the loss drops the first P logits, as ``repro``'s step
    does.  ``timed`` adds ``metrics["seconds"]``: the noise
    pass, forward plus backward and the update, each behind a device
    sync.  FUSED numerics and ``batch_groups > 1`` raise."""
    if batch_groups != 1:
        raise NotImplementedError(
            "build_train_step: batch_groups > 1 (grouped GQA batches under "
            "a mesh) is not ported yet (ROADMAP.md A.2)")
    if nldpe.enabled and nldpe.fused_dual_compute:
        raise NotImplementedError(
            "build_train_step: training under FUSED numerics (kernels B "
            "and C have no backward; ROADMAP.md A)")

    def dtype_of(w: torch.Tensor) -> torch.dtype:
        return (cfg.activation_dtype if cast_compute_dtype
                and w.dtype == torch.float32 else w.dtype)

    def train_step(params: dict, opt_state: dict, batch: dict):
        leaves = flatten(params)
        dev = leaves[0][1].device
        seconds = {}
        t0 = time.perf_counter()
        naf_pass = None
        if naf:
            key = prng.fold_in(prng.prng_key(17).to(dev), opt_state["step"])
            naf_pass = _NAFPass(key, params, dtype_of)
            run = naf_pass.run
        else:
            run = [_run_leaf(path, w.detach().to(dtype_of(w)))
                   for path, w in leaves]
        if timed:
            _sync(dev)
            seconds["noise"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        patches = batch.get("patch_embeds")
        logits = lm.forward(unflatten(params, run), batch["tokens"], cfg,
                            mode="train", nldpe=nldpe, patch_embeds=patches)
        if patches is not None:            # the loss reads the text only
            logits = logits[:, patches.shape[1]:]
        loss = lm.lm_loss(logits, batch["labels"])
        del logits
        if naf_pass is not None:
            # eq8_loss: task + lambda1 * ||W||_inf + lambda2 * ||eps||_inf
            w_inf, e_inf = naf_pass.inf_terms()
            loss = loss + naf_lambda1 * w_inf + naf_lambda2 * e_inf
        loss.backward()
        grads = []
        for li, (_, w) in enumerate(leaves):
            grads.append(_leaf_grad(run[li], w))
            run[li] = None                 # frees the run copy leaf by leaf
        if naf_pass is not None:
            naf_pass.add_grads(grads)
        if timed:
            _sync(dev)
            seconds["fwd_bwd"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        params, opt_state, metrics = adamw.update(
            opt_cfg, unflatten(params, grads), opt_state, params)
        metrics["loss"] = loss.detach()
        if timed:
            _sync(dev)
            seconds["update"] = time.perf_counter() - t0
            metrics["seconds"] = seconds
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------

def setup(cfg, opt_cfg: adamw.AdamWConfig, data_cfg: DataConfig, *,
          seed: int, device, **step_kw):
    """What a training driver starts from: the seeded float32 masters of
    ``cfg`` on ``device``, their AdamW state, the synthetic corpus's batch
    function (a batch is a function of the step index) and the train step
    (``step_kw`` go to ``build_train_step``)."""
    params = lm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
    return (params, adamw.init(params), make_batch_fn(data_cfg,
                                                      device=device),
            build_train_step(cfg, opt_cfg, **step_kw))


def run(argv=None) -> list[float]:
    p = argparse.ArgumentParser(description="Train a reduced config on the "
                                "synthetic corpus (the port's train CLI)")
    p.add_argument("--arch", default="qwen2_7b")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--nldpe", action="store_true")
    p.add_argument("--naf", action="store_true")
    p.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--fail-at-step", type=int, default=None,
                   help="simulate a node failure (raises) at this step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    from .. import resolve_device
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    sched = (wsd(args.lr, 5, int(args.steps * 0.6), int(args.steps * 0.3))
             if args.schedule == "wsd"
             else warmup_cosine(args.lr, 5, args.steps))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    params, opt_state, batch_fn, step_fn = setup(
        cfg, adamw.AdamWConfig(lr=sched), data_cfg, seed=args.seed,
        device=dev, nldpe=NLDPEConfig(enabled=args.nldpe), naf=args.naf)

    start = 0
    manager = None
    if args.ckpt_dir:
        from ..checkpoint.manager import CheckpointManager
        manager = CheckpointManager(args.ckpt_dir)
        restored = manager.restore_latest({"params": params,
                                           "opt": opt_state})
        if restored is not None:
            state, start = restored
            params, opt_state = state["params"], state["opt"]
            print(f"[train] restored checkpoint at step {start}")

    losses = []
    for step in range(start, args.steps):
        if args.fail_at_step is not None and step == args.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = batch_fn(step)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step:4d} loss {loss:.4f} "
                  f"({(time.time() - t0) * 1e3:.0f} ms)")
        if manager and (step + 1) % args.ckpt_every == 0:
            manager.save({"params": params, "opt": opt_state}, step + 1)
    if manager:
        manager.save({"params": params, "opt": opt_state}, args.steps)
    print(f"[train] done: first-10 mean "
          f"{sum(losses[:10]) / max(len(losses[:10]), 1):.4f} "
          f"last-10 mean {sum(losses[-10:]) / max(len(losses[-10:]), 1):.4f}")
    return losses


if __name__ == "__main__":
    run()

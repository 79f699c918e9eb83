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
        [--fail-at-step N] [--mesh DP,TP [--mesh-rules train|train_fsdp]]
        [--device cpu]

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
uninterrupted run's bit for bit.  ``--mesh DP,TP`` trains on a
("data", "model") mesh of DP * TP ranks under ``--mesh-rules`` (default
``train``): the CLI spawns its ranks unless it runs under ``torchrun``
(``launch.mesh.run_ranks``), rank 0 prints, and a checkpoint holds whole
arrays (gathered; restored onto any mesh).
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.drift import _at, _chunks, flatten
from ..core.engine import NLDPEConfig, OFF
from ..core.naf import leaf_amax, leaf_keys, noisy_chunk, unflatten
from ..core.noise import DEFAULT
from ..data.synthetic import DataConfig, make_batch_fn
from ..models import lm
from ..nn.module import shard_tree, spec_tree
from ..optim import adamw
from ..parallel import sharding
from ..parallel.context import ShardingContext, sharding_ctx
from ..parallel.sharding import Spec
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


class _Shard:
    """Where a leaf's local shard sits in the whole leaf: maps this
    rank's flat indices to the leaf's (``glob``) and back (``local``).
    Without a split every index is its own."""

    def __init__(self, shape: tuple, spec, mesh):
        self.shape = tuple(shape)
        self.start, self.full = [], []
        for d, n in enumerate(self.shape):
            axes = spec.axes_of(d) if spec is not None else ()
            k = axes and mesh.axis_size(axes)
            self.start.append(mesh.position(axes) * n if k else 0)
            self.full.append(n * k if k else n)
        self.split = self.full != list(self.shape)

    def glob(self, idx: torch.Tensor) -> torch.Tensor:
        if not self.split:
            return idx
        out, stride = torch.zeros_like(idx), 1
        for d in reversed(range(len(self.shape))):
            out += (idx % self.shape[d] + self.start[d]) * stride
            idx = idx // self.shape[d]
            stride *= self.full[d]
        return out

    def local(self, idx: torch.Tensor):
        """(local flat indices, owned mask) of global flat indices."""
        if not self.split:
            return idx, None
        out = torch.zeros_like(idx)
        own = torch.ones_like(idx, dtype=torch.bool)
        for d in range(len(self.shape)):
            stride = math.prod(self.full[d + 1:])
            c = (idx // stride) % self.full[d] - self.start[d]
            own &= (c >= 0) & (c < self.shape[d])
            out = out * self.shape[d] + torch.clamp(c, 0, self.shape[d] - 1)
        return out, own


def _gather_objects(mesh, obj) -> list:
    """Every rank's picklable ``obj``, in rank order (one rank: [obj])."""
    if mesh is None or mesh.size == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * mesh.size
    mesh.collectives += 1
    dist.all_gather_object(out, obj)
    return out


def _merged(mesh, parts: list) -> list:
    """(leaf, global indices, values) candidates of every rank, each
    element once (replicated shards send it more than once), sorted."""
    if mesh is None or mesh.size == 1:
        return parts
    seen: dict = {}
    for rank_parts in _gather_objects(mesh, [
            (li, idx.tolist(), vals.tolist()) for li, idx, vals in parts]):
        for li, idx, vals in rank_parts:
            for i, v in zip(idx, vals):
                seen[(li, i)] = v
    by_leaf: dict = {}
    for (li, i), v in sorted(seen.items()):
        by_leaf.setdefault(li, ([], []))
        by_leaf[li][0].append(i)
        by_leaf[li][1].append(v)
    dev = mesh.device
    return [(li, torch.tensor(i, dtype=torch.int64, device=dev),
             torch.tensor(v, dtype=torch.float32, device=dev))
            for li, (i, v) in by_leaf.items()]


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
    into the masters' float32 gradients.

    On a ``mesh`` the leaves are this rank's shards at ``specs``: each
    element's noise is drawn at its counter in the whole leaf (bit for
    bit the single-device draw's slice), ``w_max`` and both maxima are
    all-reduced, and the arg-max elements of every rank (values and
    indices in their leaves; a replicated element once) are gathered, so
    every rank builds the same two terms and counts each tie once; an
    element's gradient is added by the ranks whose shard holds it."""

    def __init__(self, key: torch.Tensor, params: dict, dtype_of,
                 specs=None, mesh=None):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.leaves = flatten(params)
        spec = dict(flatten(specs)) if specs is not None else {}
        self.where = [_Shard(w.shape, spec.get(path), mesh)
                      if self.mesh is not None else None
                      for path, w in self.leaves]
        self.keys = [tuple(k.to(w.device) for k in ks) for (_, w), ks in
                     zip(self.leaves, leaf_keys(key, params))]
        self.run, self.amax = [], []
        e_best, e_sel = -1.0, []
        with torch.no_grad():
            for li, ((path, w), keys) in enumerate(zip(self.leaves,
                                                       self.keys)):
                flat = w.reshape(-1)
                amax = self._max(leaf_amax(w))
                self.amax.append(float(amax))
                wm = torch.clamp(amax, min=1e-6)
                buf = torch.empty(flat.numel(), dtype=dtype_of(w),
                                  device=w.device)
                for o, m in _chunks(flat.numel()):
                    p = flat[o:o + m]
                    d = noisy_chunk(keys, p, wm, DEFAULT,
                                    self._counters(li, o, m)) - p
                    buf[o:o + m] = p + d
                    e = d.abs_()
                    em = float(e.max())
                    if em >= e_best:
                        idx = torch.nonzero(e == em)[:, 0] + o
                        if em > e_best:
                            e_best, e_sel = em, []
                        e_sel.append((li, idx))
                self.run.append(_run_leaf(path, buf.view(w.shape)))
        self.e_inf = float(self._max(torch.tensor(
            e_best, device=self.leaves[0][1].device)))
        if e_best < self.e_inf:            # another rank holds the max
            e_sel = []
        self.e_sel = self._candidates(e_sel)
        self.w_inf = max(self.amax)
        self.ties = {}                     # leaf -> its |w| == amax elements
        for li in sorted({li for li, a in enumerate(self.amax)
                          if a == self.w_inf} | {li for li, *_ in
                                                 self.e_sel}):
            flat = self.leaves[li][1].reshape(-1)
            self.ties[li] = self._candidates(
                [(li, _ties(flat, self.amax[li]))])
        self.w_sel = [c for li, a in enumerate(self.amax)
                      if a == self.w_inf for c in self.ties[li]]
        self._elems = []                   # (leaf, flat indices, tensor)

    def _max(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mesh is None else self.mesh.all_reduce(
            x, tuple(self.mesh.shape), op="max")

    def _counters(self, li: int, o: int, m: int):
        """The noise counters of this shard's flat elements [o, o + m):
        their indices in the whole leaf (``o`` where they are its own)."""
        if self.mesh is None or not self.where[li].split:
            return o
        w = self.leaves[li][1]
        return self.where[li].glob(torch.arange(o, o + m, device=w.device))

    def _candidates(self, sel: list) -> list:
        """(leaf, local flat indices) of this rank -> (leaf, indices in
        the leaf, values) of every rank."""
        out = []
        for li, idx in sel:
            vals = self.leaves[li][1].reshape(-1)[idx]
            if self.mesh is not None and self.where[li].split:
                idx = self.where[li].glob(idx)
            out.append((li, idx, vals))
        return _merged(self.mesh, out)

    def _take(self, li: int, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
        t = vals.detach().clone().requires_grad_()
        self._elems.append((li, idx, t))
        return t

    def inf_terms(self) -> tuple[torch.Tensor, torch.Tensor]:
        w_term = _max_term(self.w_inf, [self._take(*c) for c in self.w_sel])
        eps = []
        for li, idx, vals in self.e_sel:
            wm = torch.clamp(_max_term(
                self.amax[li], [self._take(*c) for c in self.ties[li]]),
                min=1e-6)
            x = self._take(li, idx, vals)
            for j, off in enumerate(idx.tolist()):
                xj = x[j:j + 1]
                eps.append(noisy_chunk(self.keys[li], xj, wm, DEFAULT,
                                       off) - xj)
        return w_term, _max_term(self.e_inf, eps)

    def add_grads(self, grads: list[torch.Tensor]) -> None:
        for li, idx, t in self._elems:
            if t.grad is None:
                continue
            g = t.grad
            if self.mesh is not None:
                idx, own = self.where[li].local(idx)
                if own is not None:
                    idx, g = idx[own], g[own]
            grads[li].view(-1).index_add_(0, idx, g)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                     nldpe: NLDPEConfig = OFF, batch_groups: int = 1,
                     naf: bool = False, naf_lambda1: float = 1e-5,
                     naf_lambda2: float = 1e-5,
                     cast_compute_dtype: bool = True, timed: bool = False,
                     mesh=None, rules=None):
    """``train_step(params, opt_state, batch)`` for ``cfg`` (see the
    module docstring); a VLM batch's ``"patch_embeds"`` (B, P, d) go before
    its tokens, and the loss drops the first P logits, as ``repro``'s step
    does.  ``batch_groups`` splits each MoE layer's tokens into that many
    routing groups.  ``timed`` adds ``metrics["seconds"]``: the noise
    pass, forward plus backward and the update, each behind a device
    sync.  FUSED numerics raise.

    ``mesh`` (a ``parallel.context.Mesh``) and ``rules`` (a name of
    ``sharding.TRAIN_TABLES``, default ``"train"``): ``params`` and
    ``opt_state`` hold this rank's shards (``state_specs``), the batch is
    the global one and each rank takes its rows over the rules' "batch"
    axes.  The step computes the single-device step: each rank's loss is
    the mean over its rows; the gradients of leaves replicated over a
    batch axis are all-reduced over it, those of leaves split over one
    (FSDP) reduce-scatter through the gather's backward, and all are
    divided by the batch shards; the loss in ``metrics`` is the global
    batch's mean.  A batch group splits with the rows: each rank routes
    its own groups (``nn.moe.moe_apply``), so a sharded step with
    ``batch_groups`` equal to the batch shards is the single-device step
    with those groups.  Recurrent and RWKV6 blocks raise under a mesh."""
    if nldpe.enabled and nldpe.fused_dual_compute:
        raise NotImplementedError(
            "build_train_step: training under FUSED numerics (kernels B "
            "and C have no backward; ROADMAP.md A)")
    specs = None
    if mesh is not None:
        bad = sorted({t for t in cfg.layer_pattern if t in ("rec", "rwkv")})
        if bad:
            raise NotImplementedError(
                f"build_train_step: {cfg.name}'s {bad} blocks under a mesh "
                f"(ROADMAP.md A.2 queue, item 3: RG-LRU and RWKV6 under a "
                f"mesh)")
        rules = sharding.training_rules(rules or "train")
        specs = spec_tree(lm.param_shapes(cfg), cfg, mesh, rules)

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
            naf_pass = _NAFPass(key, params, dtype_of, specs, mesh)
            run = naf_pass.run
        else:
            run = [_run_leaf(path, w.detach().to(dtype_of(w)))
                   for path, w in leaves]
        if timed:
            _sync(dev)
            seconds["noise"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        ctx, rows, shards = contextlib.nullcontext(), (), 1
        if mesh is not None:
            b = batch["tokens"].shape[0]
            ctx = sharding_ctx(mesh, rules, batch=b, specs=specs)
            rows = ShardingContext(mesh, rules, b).batch_axes()
            shards = mesh.axis_size(rows) if rows else 1
            batch = {k: Spec((rows,)).local(v, mesh) for k, v in
                     batch.items()}
        drops = None
        if cfg.moe is not None:
            drops = torch.zeros(2, dtype=torch.int64, device=dev)
        patches = batch.get("patch_embeds")
        with ctx:
            logits = lm.forward(unflatten(params, run), batch["tokens"], cfg,
                                mode="train", nldpe=nldpe,
                                patch_embeds=patches,
                                batch_groups=batch_groups, moe_drops=drops)
            if patches is not None:        # the loss reads the text only
                logits = logits[:, patches.shape[1]:]
            loss = task = lm.lm_loss(logits, batch["labels"],
                                     vocab=cfg.vocab_size)
            del logits
            reg = None
            if naf_pass is not None:
                # eq8_loss: task + lambda1 * ||W||_inf + lambda2 * ||eps||_inf
                w_inf, e_inf = naf_pass.inf_terms()
                reg = naf_lambda1 * w_inf + naf_lambda2 * e_inf
                loss = loss + reg
            loss.backward()
        grads = []
        for li, (path, w) in enumerate(leaves):
            g = _leaf_grad(run[li], w)
            run[li] = None                 # frees the run copy leaf by leaf
            if shards > 1:
                # the batch shards' gradients summed (all-reduced where
                # the leaf is replicated over a batch axis; an FSDP leaf's
                # came summed through its gather), then their mean
                used = {a for a in adamw._split_axes(_at(specs, path), mesh)}
                red = tuple(a for a in rows if a not in used)
                if red:
                    g = mesh.all_reduce(g, red)
                g = g.div_(shards)
            grads.append(g)
        if naf_pass is not None:
            naf_pass.add_grads(grads)
        if timed:
            _sync(dev)
            seconds["fwd_bwd"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        params, opt_state, metrics = adamw.update(
            opt_cfg, unflatten(params, grads), opt_state, params,
            specs=specs, mesh=mesh)
        if shards > 1:
            # the global batch's mean (the rows split evenly) plus the NAF
            # terms (the same on every rank)
            loss = mesh.all_reduce(task.detach(), rows) / shards
            if reg is not None:
                loss = loss + reg.detach()
            drops = None if drops is None else mesh.all_reduce(drops, rows)
        metrics["loss"] = loss.detach()
        if drops is not None:
            metrics["moe_dropped"] = drops
        if timed:
            _sync(dev)
            seconds["update"] = time.perf_counter() - t0
            metrics["seconds"] = seconds
        return params, opt_state, metrics

    train_step.specs = specs
    return train_step


def state_specs(specs) -> dict:
    """The placements of a train state ``{"params", "opt"}`` from the
    parameters' (``train_step.specs``): AdamW's moments split as their
    parameters, its step replicated."""
    return {"params": specs,
            "opt": {"m": specs, "v": specs, "step": Spec()}}


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------

def setup(cfg, opt_cfg: adamw.AdamWConfig, data_cfg: DataConfig, *,
          seed: int, device, **step_kw):
    """What a training driver starts from: the seeded float32 masters of
    ``cfg`` on ``device``, their AdamW state, the synthetic corpus's batch
    function (a batch is a function of the step index) and the train step
    (``step_kw`` go to ``build_train_step``; with a ``mesh`` the masters
    and moments are this rank's shards)."""
    step = build_train_step(cfg, opt_cfg, **step_kw)
    params = lm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
    if step.specs is not None:
        params = shard_tree(params, step.specs, step_kw["mesh"])
    return (params, adamw.init(params), make_batch_fn(data_cfg,
                                                      device=device), step)


def _mesh_shape(text: str) -> tuple[int, int]:
    try:
        dp, tp = (int(v) for v in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh takes DP,TP (two integers), got {text!r}") from None
    if dp < 1 or tp < 1:
        raise argparse.ArgumentTypeError("--mesh DP,TP must be >= 1")
    return dp, tp


def _rank_run(argv, device):
    """One spawned rank of ``--mesh``: the CLI again, inside the process
    group."""
    return run(argv)


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
    p.add_argument("--mesh", type=_mesh_shape, default=None,
                   metavar="DP,TP",
                   help="train on a (data, model) mesh of DP*TP ranks "
                        "(spawned here, or torchrun's); the losses are "
                        "the unsharded command's up to float sums")
    p.add_argument("--mesh-rules", default=None,
                   choices=sorted(sharding.TRAIN_TABLES),
                   help="rule table for --mesh (default train: FSDP of "
                        "d_model over data, heads/FFN columns/vocab over "
                        "model; train_fsdp: the batch over both axes, "
                        "every weight gathered at use)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    from .. import resolve_device
    from . import mesh as mesh_lib

    cfg = get_config(args.arch, reduced=True)
    if args.mesh_rules and not args.mesh:
        p.error("--mesh-rules requires --mesh DP,TP")
    if args.mesh and any(t in ("rec", "rwkv") for t in cfg.layer_pattern):
        p.error(f"--mesh: {args.arch}'s recurrent/RWKV6 blocks do not "
                f"train under a mesh yet (ROADMAP.md A.2 queue, item 3)")
    mesh = None
    if args.mesh:
        dp, tp = args.mesh
        if not mesh_lib.in_process_group():
            # spawn the ranks; each runs this command inside the group
            return mesh_lib.run_ranks(
                _rank_run, dp * tp,
                (sys.argv[1:] if argv is None else list(argv),),
                device=args.device or "cuda")[0]
        mesh = mesh_lib.serve_mesh(dp, tp, mesh_lib.rank_device(
            torch.device(args.device or "cuda"), mesh_lib.world_rank(),
            dp * tp))
        if mesh.rank:
            sys.stdout = open(os.devnull, "w")   # rank 0 reports
    dev = mesh.device if mesh is not None else resolve_device(args.device)

    sched = (wsd(args.lr, 5, int(args.steps * 0.6), int(args.steps * 0.3))
             if args.schedule == "wsd"
             else warmup_cosine(args.lr, 5, args.steps))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    mesh_kw = {} if mesh is None else dict(mesh=mesh,
                                          rules=args.mesh_rules or "train")
    params, opt_state, batch_fn, step_fn = setup(
        cfg, adamw.AdamWConfig(lr=sched), data_cfg, seed=args.seed,
        device=dev, nldpe=NLDPEConfig(enabled=args.nldpe), naf=args.naf,
        **mesh_kw)
    if mesh is not None:
        print(f"[train] mesh {args.mesh} over ('data', 'model'), rules "
              f"{mesh_kw['rules']}, backend "
              f"{mesh_lib.describe_backend(mesh.backend, mesh.device)}")
    ckpt_kw = {} if mesh is None else dict(
        specs=state_specs(step_fn.specs), mesh=mesh)

    start = 0
    manager = None
    if args.ckpt_dir:
        from ..checkpoint.manager import CheckpointManager
        manager = CheckpointManager(args.ckpt_dir)
        restored = manager.restore_latest({"params": params,
                                           "opt": opt_state}, **ckpt_kw)
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
            manager.save({"params": params, "opt": opt_state}, step + 1,
                         **ckpt_kw)
    if manager:
        manager.save({"params": params, "opt": opt_state}, args.steps,
                     **ckpt_kw)
    print(f"[train] done: first-10 mean "
          f"{sum(losses[:10]) / max(len(losses[:10]), 1):.4f} "
          f"last-10 mean {sum(losses[-10:]) / max(len(losses[-10:]), 1):.4f}")
    return losses


if __name__ == "__main__":
    run()

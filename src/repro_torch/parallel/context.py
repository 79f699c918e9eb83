"""The port's device mesh and the ambient sharding context (port of
``repro.parallel.context``).

Where ``repro`` hands global arrays to GSPMD, the port holds **local
shards**: every leaf is a plain tensor holding this rank's slice of the
global one, its placement (a ``sharding.Spec``) kept beside it, and every
collective is an explicit call on the mesh's process groups.  That is the
view ``shard_map`` gives a ``pallas_call``, which is what lets kernels A
and B launch once per shard on local tensors.

``Mesh`` is one rank's view of a ("data", "model") grid of processes:
rank ``r`` sits at row-major coordinates of ``shape``, with one process
group per axis of size > 1 (``launch/mesh.py`` builds it).  A mesh of one
rank has no groups and every collective is the identity.

``sharding_ctx(mesh, rules, batch=, specs=)`` installs (mesh, rules)
while the model runs; ``batch`` is the global row count of the forward
when its rows are split over the rules' "batch" axes (the serve engines
pass their slot count, the train step its global batch); ``specs`` is the
parameter tree's placements (``nn.module.spec_tree``) where leaves
sharded over a batch axis are gathered at use (FSDP: ``gather_params``).
Without a context ``shard``, ``reduce_partial`` and ``enter`` are no-ops,
so single-device code is unchanged.

Activations split their rows over the batch axes first, so a mesh axis
the batch takes splits none of an activation's other dimensions
(``act_axes``; ``resolve``'s one-use rule over ``("batch", ...)``): under
``train_fsdp`` the batch spans both axes and every weight is gathered
whole at use.

**Collectives under autograd** (a replicated loss: every rank of a
"model" group computes the same loss; the batch shards each compute the
mean of their own rows, and the train step sums their gradients):

* ``gather`` — all-gather forward; backward hands each rank its own slice
  of the *sum* of the ranks' gradients (a reduce-scatter): the gathered
  tensor feeds rows that differ per rank (FSDP weights over the batch
  axes, MoE routing groups spanning ranks), so each rank's gradient is a
  partial one.
* ``reduce_partial`` — Megatron's "g" at a contraction split over ranks
  (the output projection's heads, the down projection's rows, a
  vocab-parallel lookup or loss sum): forward all-reduces the partial
  sums in float32 and casts once; backward is the identity (the sum is
  consumed alike on every rank, so each already holds its gradient).
* ``enter`` — its twin "f", where a replicated activation enters a
  column-split region (q/k/v heads, the gate/up columns, the unembed's
  vocab columns): identity forward; backward all-reduces the ranks'
  partial input gradients.

``torch.distributed.nn``'s all-reduce differentiates as an all-reduce,
which multiplies a replicated loss's gradient by the group size.

"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from .sharding import Rules, Spec, resolve

_STATE = threading.local()


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a mesh of processes.

    ``shape`` maps axis name -> size in mesh order (ranks are row-major
    over it, as ``jax.make_mesh`` lays devices out); ``groups`` holds the
    process group of each axis of size > 1 (the ranks that share every
    other coordinate) and ``"world"`` the group of every rank.  ``device``
    is where this rank's tensors live; ``backend`` the process group's
    backend.  ``collectives`` counts the collective calls this rank has
    issued and ``bytes`` the bytes of the tensors it handed them."""

    shape: dict
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    collectives: int = 0          # collective calls issued (a counter)
    bytes: int = 0                # bytes handed to them (a counter)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> dict:
        out, r = {}, self.rank
        for ax in reversed(list(self.shape)):
            out[ax] = r % self.shape[ax]
            r //= self.shape[ax]
        return dict(reversed(list(out.items())))

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def _flat(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if self.shape.get(a, 1) > 1)

    def position(self, axes) -> int:
        """This rank's index over ``axes`` (major first): which slice of
        a dimension split over them it holds."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx, coords = 0, self.coords
        for ax in axes:
            idx = idx * self.shape[ax] + coords[ax]
        return idx

    def _count(self, x: torch.Tensor) -> None:
        self.collectives += 1
        self.bytes += x.numel() * x.element_size()

    def all_gather(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim`` over ``axes``
        (major first), in coordinate order: exact."""
        for ax in reversed(self._flat(axes)):
            x = self._gather_one(x, dim, ax)
        return x

    def _gather_one(self, x: torch.Tensor, dim: int, ax: str):
        import torch.distributed as dist
        if x.dtype == torch.bool:             # carried as bytes
            return self._gather_one(x.to(torch.uint8), dim, ax).to(
                torch.bool)
        n, group = self.shape[ax], self.groups[ax]
        x = x.contiguous()
        self._count(x)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """Reduce ``x`` over ``axes`` ("sum" or "max"), out of place."""
        import torch.distributed as dist
        x = x.clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        for ax in self._flat(axes):
            self._count(x)
            dist.all_reduce(x, op=red, group=self.groups[ax])
        return x

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` (n, ...) over the n ranks of ``axis``: chunk ``j`` goes
        to rank ``j``, and chunk ``i`` of the result came from rank
        ``i`` (``jax.lax.all_to_all`` with ``split_axis = concat_axis =
        0``, untiled)."""
        import torch.distributed as dist
        if self.shape.get(axis, 1) == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        self._count(x)
        dist.all_to_all_single(out, x, group=self.groups[axis])
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int, axes
                       ) -> torch.Tensor:
        """The sum of every rank's ``x`` over ``axes``, split along
        ``dim`` as ``all_gather`` concatenates (major first): this rank's
        slice.  Floats narrower than 32 bits are summed in float32 and
        cast once."""
        import torch.distributed as dist
        dtype = x.dtype
        if x.is_floating_point() and x.element_size() < 4:
            x = x.to(torch.float32)
        for ax in self._flat(axes):              # major first
            n, group = self.shape[ax], self.groups[ax]
            xt = x.movedim(dim, 0).contiguous()
            self._count(xt)
            out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
            dist.reduce_scatter_tensor(out, xt, group=group)
            x = out.movedim(0, dim)
        return x.to(dtype).contiguous()


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    mesh: Mesh
    rules: Rules
    batch: int | None = None      # global rows of the forward (split rows)
    specs: dict | None = None     # the parameters' placements (FSDP)

    def batch_axes(self) -> tuple:
        """The mesh axes the forward's rows are split over (empty when
        they are replicated or no ``batch`` was given)."""
        if self.batch is None:
            return ()
        return resolve(self.rules, ("batch",), (self.batch,),
                       self.mesh).axes_of(0)

    def batch_shards(self) -> int:
        return self.mesh.axis_size(self.batch_axes()) if self.batch_axes() \
            else 1


def sharding_ctx(mesh: Mesh, rules: Rules, batch: int | None = None,
                 specs: dict | None = None):
    return installed(None if mesh is None
                     else ShardingContext(mesh, rules, batch, specs))


@contextlib.contextmanager
def installed(ctx: ShardingContext | None):
    """``ctx`` (None: none) as this thread's context while the block runs.
    The context is per thread, and autograd runs a CUDA backward pass on
    a thread of its own: a layer it recomputes there reinstalls the
    forward's context (``models.lm.forward``)."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def current() -> ShardingContext | None:
    return getattr(_STATE, "ctx", None)


class _Gather(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward (the module
    docstring)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axes):
        ctx.args = (mesh, dim, axes)
        return mesh.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, axes = ctx.args
        return mesh.reduce_scatter(g, dim, axes), None, None, None


class _Reduce(torch.autograd.Function):
    """Megatron's "g": all-reduce (sum in float32, one cast) forward,
    identity backward."""

    @staticmethod
    def forward(ctx, y, mesh, axes):
        return mesh.all_reduce(y.to(torch.float32), axes).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Megatron's "f": identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_reduce(g, axes), None, None


def gather(x: torch.Tensor, dim: int, axes, mesh: Mesh | None = None
           ) -> torch.Tensor:
    """``mesh.all_gather`` (the context's mesh by default) under
    autograd: its backward reduce-scatters (``_Gather``)."""
    mesh = mesh if mesh is not None else current().mesh
    if not mesh._flat(axes):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, mesh, dim, tuple(axes))
    return mesh.all_gather(x, dim, axes)


def act_axes(logical: str | None, n: int) -> tuple:
    """The mesh axes the rules split an activation's ``logical``
    dimension of global size ``n`` over under the context: none where
    the forward's rows already take one of them (the batch comes first
    in every activation)."""
    ctx = current()
    if ctx is None or logical is None:
        return ()
    axes = resolve(ctx.rules, (logical,), (n,), ctx.mesh).axes_of(0)
    return () if set(axes) & set(ctx.batch_axes()) else axes


def shard(x: torch.Tensor, *axes, src: tuple | None = None,
          full: tuple | None = None) -> torch.Tensor:
    """Bring the local shard ``x`` to the placement the rules give the
    logical ``axes`` (a no-op without a context).

    ``src`` names the logical axes ``x`` carries now and ``full`` the
    global size of each dimension (None: leave that dimension as it is).
    A dimension whose local size is below its global one is split over
    the mesh axes its ``src`` name resolves to (``act_axes``).  Where the
    target splits it over the same axes, the shard stays as it is: at a
    contraction boundary ("o_heads", "mlp_in" under ``train`` or
    ``serve``) the caller multiplies it by its rows of the weight and
    sums the partial products with ``reduce_partial``.  Where the target
    does not split it so, the shards are all-gathered (under autograd):
    the exact concatenation of the exact tables."""
    ctx = current()
    if ctx is None or full is None:
        return x
    src = axes if src is None else src
    for d, (want, have, n) in enumerate(zip(axes, src, full)):
        if n is None or want == have or x.shape[d] == n:
            continue
        have_axes = act_axes(have, n)
        if have_axes != act_axes(want, n):
            x = gather(x, d, have_axes, ctx.mesh)
    return x


def reduce_partial(y: torch.Tensor, logical: str, full: int,
                   local: int) -> torch.Tensor:
    """``y`` = this rank's product over its ``local`` of the ``full``
    entries of a contraction dimension named ``logical``: the all-reduced
    sum of the ranks' partial products (``_Reduce``: float32, one cast;
    identity backward), or ``y`` itself where the rank contracted the
    whole dimension (the exact tables, or a weight gathered at use)."""
    ctx = current()
    if ctx is None or local == full:
        return y
    return _Reduce.apply(y, ctx.mesh, act_axes(logical, full))


def enter(x: torch.Tensor, logical: str, full: int,
          local: int) -> torch.Tensor:
    """``x``, replicated over the ranks, entering a region whose
    ``logical`` output dimension (global ``full``) each rank holds
    ``local`` of: identity, whose backward all-reduces (``_Enter``)."""
    ctx = current()
    if (ctx is None or local == full or not torch.is_grad_enabled()
            or not x.requires_grad):
        return x
    return _Enter.apply(x, ctx.mesh, act_axes(logical, full))


def gather_params(tree, specs):
    """FSDP at use: every leaf of ``tree`` (this rank's shards; a stacked
    leaf's layer, whose spec leads with the stack's None) gathered over
    the dimensions its spec splits over a batch axis (under autograd:
    their gradients reduce-scatter back)."""
    ctx = current()
    if ctx is None or specs is None or not ctx.batch_axes():
        return tree
    if isinstance(tree, dict):
        return {k: gather_params(v, specs[k]) for k, v in tree.items()}
    sp = Spec(specs)
    lead = len(sp) - tree.dim()
    batch = set(ctx.batch_axes())
    for d in range(tree.dim()):
        axes = sp.axes_of(d + lead)
        if set(axes) & batch:
            tree = gather(tree, d, axes, ctx.mesh)
    return tree


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The forward's split rows of ``x`` gathered back over the batch
    axes (the identity when the rows are not split; under autograd the
    gradient reduce-scatters back)."""
    ctx = current()
    if ctx is None or not ctx.batch_axes():
        return x
    return gather(x, dim, ctx.batch_axes(), ctx.mesh)


def global_absmax(w: torch.Tensor, full_cols: int) -> torch.Tensor | None:
    """max |w| over the whole weight when ``w`` holds a column shard of a
    (K, ``full_cols``) weight (an all-reduce max over "model", exact),
    or None when it holds every column."""
    ctx = current()
    if ctx is None or w.shape[-1] == full_cols:
        return None
    axes = resolve(ctx.rules, ("mlp",), (full_cols,), ctx.mesh).axes_of(0)
    local = torch.amax(torch.abs(w.to(torch.float32)))
    return ctx.mesh.all_reduce(local, axes, op="max")

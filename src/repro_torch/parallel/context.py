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

``sharding_ctx(mesh, rules, batch=)`` installs (mesh, rules) while the
model runs; ``batch`` is the global row count of the forward when its rows
are split over the rules' "batch" axes (the serve engines pass their slot
count).  Without a context ``shard`` is a no-op, so single-device code is
unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from .sharding import Rules, resolve

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
    issued."""

    shape: dict
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    collectives: int = 0          # collective calls issued (a counter)

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
        self.collectives += 1
        x = x.contiguous()
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
            self.collectives += 1
            dist.all_reduce(x, op=red, group=self.groups[ax])
        return x


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    mesh: Mesh
    rules: Rules
    batch: int | None = None      # global rows of the forward (split rows)

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


@contextlib.contextmanager
def sharding_ctx(mesh: Mesh, rules: Rules, batch: int | None = None):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (None if mesh is None
                  else ShardingContext(mesh, rules, batch))
    try:
        yield
    finally:
        _STATE.ctx = prev


def current() -> ShardingContext | None:
    return getattr(_STATE, "ctx", None)


def shard(x: torch.Tensor, *axes, src: tuple | None = None,
          full: tuple | None = None) -> torch.Tensor:
    """Bring the local shard ``x`` to the placement the rules give the
    logical ``axes`` (a no-op without a context).

    ``src`` names the logical axes ``x`` carries now and ``full`` the
    global size of each dimension (None: leave that dimension as it is).
    A dimension whose local size is below its global one is split over
    the mesh axes its ``src`` name resolves to; where the target does not
    split it so, the shards are all-gathered over those axes: the exact
    concatenation at a contraction boundary ("o_heads", "mlp_in" under
    the exact tables, the only boundaries the engines run)."""
    ctx = current()
    if ctx is None or full is None:
        return x
    mesh, rules = ctx.mesh, ctx.rules
    src = axes if src is None else src
    for d, (want, have, n) in enumerate(zip(axes, src, full)):
        if n is None or want == have or x.shape[d] == n:
            continue
        have_axes = resolve(rules, (have,), (n,), mesh).axes_of(0)
        if have_axes != resolve(rules, (want,), (n,), mesh).axes_of(0):
            x = mesh.all_gather(x, d, have_axes)
    return x


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The forward's split rows of ``x`` gathered back over the batch
    axes (the identity when the rows are not split)."""
    ctx = current()
    if ctx is None or not ctx.batch_axes():
        return x
    return ctx.mesh.all_gather(x, dim, ctx.batch_axes())


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

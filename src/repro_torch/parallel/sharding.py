"""Logical-axis sharding rules -> per-dimension placements (port of
``repro.parallel.sharding``).

Model code names tensor axes logically ("batch", "embed", "heads", ...);
a ``Rules`` table maps each logical name to zero or more mesh axes.
``resolve`` checks divisibility against the actual dimension size and the
mesh shape and drops to replication when a mapping does not divide, and
maps a mesh axis at most once per tensor — ``repro``'s resolver line for
line, so one model definition serves every (arch x shape x mesh) cell.

A resolved ``Spec`` is the port's placement, what ``repro``'s
``PartitionSpec`` is: one entry per tensor dimension (None, a mesh axis
name, or a tuple of names, major first); ``Spec.local`` is the slice of a
global tensor one rank holds.

Rule tables: ``train``, ``serve``, ``long``, ``train_fsdp``,
``serve_dshard`` and ``serve_exact`` (``exact(serve)``: every mapping of a
contraction axis dropped, so shards combine only by concatenation and
sharded serving is bit-identical to single-device serving; the serve
engines' default).  ``repro``'s docstrings give each table's rationale.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Rules:
    name: str
    table: dict                      # logical axis -> mesh axis | tuple | None

    def lookup(self, logical: str):
        return self.table.get(logical, None)


class Spec(tuple):
    """Per-tensor-dimension mesh axes of a resolved placement (a tuple of
    None, axis names and tuples of names)."""

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"

    def axes_of(self, dim: int) -> tuple:
        """The mesh axes dimension ``dim`` is split over, major first."""
        a = self[dim] if dim < len(self) else None
        if a is None:
            return ()
        return tuple(a) if isinstance(a, (tuple, list)) else (a,)

    def local(self, x, mesh):
        """The slice of the global tensor ``x`` this rank of ``mesh`` holds
        (a view; the whole tensor where every dim is replicated)."""
        for d in range(min(len(self), x.dim())):
            axes = self.axes_of(d)
            if not axes:
                continue
            n, idx = 1, 0
            for ax in axes:                          # major first
                n *= mesh.shape[ax]
                idx = idx * mesh.shape[ax] + mesh.coords[ax]
            size = x.shape[d] // n
            x = x.narrow(d, idx * size, size)
        return x


def axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def resolve(rules: Rules, axes: tuple, shape: tuple, mesh) -> Spec:
    """Logical axes + concrete shape -> Spec with divisibility checks.
    ``mesh`` is anything with a ``shape`` mapping of axis name -> size
    (None: everything replicated)."""
    if mesh is None:
        return Spec()
    spec = []
    used: set = set()
    for dim, logical in zip(shape, axes):
        mesh_axis = rules.lookup(logical) if logical else None
        if mesh_axis is None:
            spec.append(None)
            continue
        flat = (tuple(mesh_axis) if isinstance(mesh_axis, (tuple, list))
                else (mesh_axis,))
        # an axis may appear only once in a spec; also require divisibility
        if (any(a in used for a in flat)
                or any(a not in mesh.shape for a in flat)):
            spec.append(None)
            continue
        if dim % axis_size(mesh, mesh_axis) != 0:
            # partial fallback: try the first sub-axis alone
            if (len(flat) > 1 and dim % axis_size(mesh, flat[0]) == 0
                    and flat[0] not in used):
                spec.append(flat[0])
                used.add(flat[0])
            else:
                spec.append(None)
            continue
        spec.append(tuple(mesh_axis) if isinstance(mesh_axis, list)
                    else mesh_axis)
        used.update(flat)
    return Spec(spec)


# ---------------------------------------------------------------------------
# Standard rule tables.  "pod" exists only on the multi-pod mesh; the
# resolver ignores mesh axes that are absent.
# ---------------------------------------------------------------------------

def train_rules(multi_pod: bool = False) -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    return Rules("train", {
        "batch": batch, "embed": "data", "mlp": "model", "mlp_in": "model",
        "heads": "model", "o_heads": "model", "kv_heads": "model",
        "vocab": "model", "experts": None, "expert_group": batch,
        "seq": None, "kv_seq": None, "act_embed": None})


def serve_rules(multi_pod: bool = False) -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    return Rules("serve", {
        "batch": batch, "slots": batch, "pages": None, "embed": None,
        "mlp": "model", "mlp_in": "model", "heads": "model",
        "o_heads": "model", "kv_heads": "model", "vocab": "model",
        "experts": None, "expert_group": batch, "seq": None,
        "kv_seq": "model", "act_embed": None})


def long_rules(multi_pod: bool = False) -> Rules:
    r = serve_rules(multi_pod).table.copy()
    r["kv_seq"] = ("data", "model")
    r["pages"] = "data"
    r["batch"] = None
    r["slots"] = None
    r["expert_group"] = None
    return Rules("long", r)


def train_fsdp_rules(multi_pod: bool = False) -> Rules:
    batch = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Rules("train_fsdp", {
        "batch": batch, "embed": "data", "mlp": "model", "mlp_in": "model",
        "heads": "model", "o_heads": "model", "kv_heads": "model",
        "vocab": "model", "experts": None, "expert_group": batch,
        "seq": None, "kv_seq": None, "act_embed": None})


def serve_dshard_rules(multi_pod: bool = False) -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    return Rules("serve_dshard", {
        "batch": batch, "slots": batch, "pages": None, "embed": "model",
        "mlp": None, "mlp_in": None, "heads": None, "o_heads": None,
        "kv_heads": None, "vocab": None, "experts": None,
        "expert_group": batch, "seq": None, "kv_seq": "model",
        "act_embed": None})


# Logical axes whose sharding splits a contraction (or a later reduction
# over that axis): each shard then holds a partial sum, and the combine is
# a float all-reduce whose addition order differs from the single-device
# contraction.  Everything else shards batch or output dims, which combine
# by concatenation — exact.
INEXACT_AXES = ("o_heads", "mlp_in", "embed", "kv_seq", "vocab", "seq",
                "act_embed")


def exact(rules: Rules) -> Rules:
    """The bit-exact variant of a rule table: every mapping of an
    ``INEXACT_AXES`` axis dropped."""
    table = dict(rules.table)
    for ax in INEXACT_AXES:
        if ax in table:
            table[ax] = None
    return Rules(f"{rules.name}_exact", table)


def is_exact(rules: Rules) -> bool:
    """True when the table maps no contraction axis (its forward combines
    shards by concatenation only)."""
    return all(rules.lookup(ax) is None for ax in INEXACT_AXES)


def serve_exact_rules(multi_pod: bool = False) -> Rules:
    """The serve engines' default: TP over heads/kv-heads/ffn output dims,
    DP over slots, contraction dims replicated."""
    return exact(serve_rules(multi_pod))


RULES = {"train": train_rules, "serve": serve_rules, "long": long_rules,
         "train_fsdp": train_fsdp_rules, "serve_dshard": serve_dshard_rules,
         "serve_exact": serve_exact_rules}


def serve_dshard_exact_rules(multi_pod: bool = False) -> Rules:
    """``exact(serve_dshard)``: slots over "data", every weight and pool
    replicated (data parallel only)."""
    return exact(serve_dshard_rules(multi_pod))


# The tables the serve engines run: the exact ones, and ``serve``, whose
# contractions ("o_heads", "mlp_in", "vocab") are partial sums combined by
# an all-reduce (``parallel.context.reduce_partial``)
SERVE_TABLES = {"serve_exact": serve_exact_rules,
                "serve_dshard_exact": serve_dshard_exact_rules,
                "serve": serve_rules}

# The tables the train step runs (``launch.train.build_train_step``)
TRAIN_TABLES = {"train": train_rules, "train_fsdp": train_fsdp_rules}

# What the engines do not serve yet, each with its ROADMAP.md A.2 queue item
NOT_SERVED = {
    "serve_dshard": "every weight is split on d_model, so kernel B's "
                    "contraction is split: the rank must gather the gate's "
                    "rows first (ROADMAP.md A.2 queue, item 1: serve_dshard)",
    "long": "pages over \"data\" need kernel A per page shard merged by "
            "parallel/cp_decode.py (ROADMAP.md A.2 queue, item 2: long and "
            "context-parallel paged decode)"}


def serving_rules(name: str) -> Rules:
    """The serve table ``name``; a table the engines do not serve yet
    raises ``NotImplementedError`` naming its ROADMAP item."""
    if name in SERVE_TABLES:
        return SERVE_TABLES[name]()
    rules_for(name)
    if name in NOT_SERVED:
        raise NotImplementedError(f"rule table {name!r}: {NOT_SERVED[name]}")
    raise NotImplementedError(
        f"rule table {name!r} is a training table; the engines serve "
        f"{sorted(SERVE_TABLES)}")


def training_rules(rules: str) -> Rules:
    """The train table named ``rules`` (``TRAIN_TABLES``); another name
    raises ``ValueError``."""
    if rules not in TRAIN_TABLES:
        raise ValueError(f"train rule table {rules!r}: one of "
                         f"{sorted(TRAIN_TABLES)}")
    return TRAIN_TABLES[rules]()


def rules_for(mode: str, multi_pod: bool = False) -> Rules:
    if mode not in RULES:
        raise ValueError(f"unknown rule table {mode!r}; one of "
                         f"{sorted(RULES)}")
    return RULES[mode](multi_pod)

"""Logical axes of the parameter tree, and its spec tree (the role of
``repro.nn.module``'s spec mode).

``repro`` names every parameter's logical axes where it draws it
(``param(key, shape, axes)``) and gets a sharding tree by running the
init in spec mode.  The port draws (``models.lm.init_params``) or
converts (``convert.from_jax``) its weights without that hook, so
``param_axes(cfg)`` states the same axes as a tree mirroring
``init_params``'s: stacked ``groups`` leaves carry a leading None (the
layer-stack axis), the ``tail`` blocks none.  ``spec_tree(params, cfg,
mesh, rules)`` resolves each leaf's axes against its shape
(``parallel.sharding.resolve``) — leaf for leaf what ``repro``'s
``spec_tree(lm.init_params, ...)`` gives — and ``shard_tree`` keeps
this rank's slice of every leaf; ``gather_tree`` is its inverse (every
rank gets the whole tree back: saving, and tests).  ``lm.param_shapes``
gives the global shapes a rank that holds only shards resolves against.
"""
from __future__ import annotations

from ..parallel.sharding import Spec, resolve

NORM = {"scale": ("act_embed",)}


def _block_axes(cfg, btype: str) -> dict:
    p = {"norm1": dict(NORM), "norm2": dict(NORM)}
    if btype == "rwkv":
        p["tm"] = {"mu": (None, "act_embed"), "w_r": ("embed", "heads"),
                   "w_k": ("embed", "heads"), "w_v": ("embed", "heads"),
                   "w_g": ("embed", "heads"), "w_o": ("heads", "embed"),
                   "decay_base": ("heads",), "decay_A": ("embed", None),
                   "decay_B": (None, "heads"), "bonus_u": ("heads", None)}
        p["cm"] = {"mu": (None, "act_embed"), "w_k": ("embed", "mlp"),
                   "w_v": ("mlp", "embed"), "w_r": ("embed", "mlp")}
        return p
    if btype == "rec":
        p["rec"] = {"in_gate": ("embed", "mlp"), "in_x": ("embed", "mlp"),
                    "conv": (None, "mlp"),
                    "rglru": {"w_a": ("embed", "mlp"), "b_a": ("mlp",),
                              "w_x": ("embed", "mlp"), "b_x": ("mlp",),
                              "lam": ("mlp",)},
                    "out": ("mlp", "embed")}
    else:
        attn = {"wq": ("embed", "heads", None),
                "wk": ("embed", "kv_heads", None),
                "wv": ("embed", "kv_heads", None),
                # the output projection's contraction: exact tables
                # replicate it (parallel.sharding.INEXACT_AXES)
                "wo": ("o_heads", None, "embed")}
        if cfg.qkv_bias:
            attn.update(bq=("heads", None), bk=("kv_heads", None),
                        bv=("kv_heads", None))
        if cfg.qk_norm:
            attn["q_norm"] = dict(NORM)
            attn["k_norm"] = dict(NORM)
        p["attn"] = attn
    if btype == "moe":
        p["ffn"] = {"router": ("embed", "experts"),
                    "gate": ("experts", "embed", "mlp"),
                    "up": ("experts", "embed", "mlp"),
                    "down": ("experts", "mlp_in", "embed")}
        return p
    ffn = {"up": ("embed", "mlp"), "down": ("mlp_in", "embed")}
    if cfg.gated_mlp:
        ffn["gate"] = ("embed", "mlp")
    p["ffn"] = ffn
    return p


def _stack(tree):
    if isinstance(tree, dict):
        return {k: _stack(v) for k, v in tree.items()}
    return (None, *tree)


def param_axes(cfg) -> dict:
    """The logical axes of every leaf of ``init_params(cfg)``'s tree."""
    from ..models.lm import _pattern_split
    pat, _, tail = _pattern_split(cfg)
    out = {"embed": {"table": ("vocab", "embed")},
           "groups": {f"b{i}": _stack(_block_axes(cfg, t))
                      for i, t in enumerate(pat)},
           "final_norm": dict(NORM)}
    if tail:
        out["tail"] = {f"b{i}": _block_axes(cfg, t)
                       for i, t in enumerate(tail)}
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": ("embed", "vocab")}
    return out


def spec_tree(params: dict, cfg, mesh, rules) -> dict:
    """The resolved ``Spec`` of every leaf of ``params`` (tensors, or
    anything with a ``shape``) on ``mesh`` under ``rules``."""
    def walk(p, axes):
        if isinstance(p, dict):
            missing = set(p) - set(axes)
            if missing:
                raise KeyError(f"param_axes has no axes for {sorted(missing)}")
            return {k: walk(v, axes[k]) for k, v in p.items()}
        return resolve(rules, axes, tuple(p.shape), mesh)

    return walk(params, param_axes(cfg))


def shard_tree(tree: dict, specs: dict, mesh) -> dict:
    """This rank's slice of every leaf of ``tree`` (contiguous copies
    where a leaf is split, the leaf itself where it is replicated)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if all(a is None for a in specs):
        return tree
    return Spec(specs).local(tree, mesh).contiguous()


def gather_tree(tree: dict, specs: dict, mesh) -> dict:
    """The whole of every leaf of ``tree`` (this rank's shards at
    ``specs``), all-gathered over the axes each dimension is split over:
    every rank calls it, in the same order."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    sp = Spec(specs)
    for d in range(min(len(sp), tree.dim())):
        if sp.axes_of(d):
            tree = mesh.all_gather(tree, d, sp.axes_of(d))
    return tree

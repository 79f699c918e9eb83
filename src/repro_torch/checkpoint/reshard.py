"""Elastic resharding: restore a checkpoint onto a different mesh (port
of ``repro.checkpoint.reshard``).

Checkpoints store whole (unsharded) host arrays (``manager.py``; a sharded
state is gathered leaf by leaf before rank 0 writes it), so restoring
onto another mesh is slicing each whole leaf to the placement the new
mesh gives it: ``reshard_tree`` keeps this rank's slice of every leaf per
a spec tree (``nn.module.spec_tree``, ``launch.train.state_specs``).
Where ``repro`` places global arrays with ``device_put``, the port's
ranks hold local shards, so a placement is a slice and a replication is
the whole leaf on every rank.  ``tests/test_torch_parallel_extras.py``
trains on a (1, 2) mesh, restores onto (2, 1) and continues bit for bit,
as ``repro``'s elastic round trip does.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import Spec


def reshard_tree(tree, specs, mesh):
    """This rank's slice of every whole leaf of ``tree`` at the matching
    spec of ``specs`` on ``mesh`` (a contiguous copy where the leaf is
    split, the leaf itself where it is replicated), on the mesh's
    device."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, specs[k], mesh) for k, v in tree.items()}
    spec = Spec(specs) if specs is not None else Spec()
    out = spec.local(tree, mesh)
    if out is not tree:
        out = out.contiguous()
    return out.to(mesh.device)


def replicate_tree(tree, mesh):
    """Every leaf of ``tree`` whole on this rank (a replicated placement:
    each rank holds the same copy), on the mesh's device."""
    if isinstance(tree, dict):
        return {k: replicate_tree(v, mesh) for k, v in tree.items()}
    return tree.to(mesh.device, copy=True) if torch.is_tensor(tree) \
        else tree

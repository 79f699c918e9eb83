"""Atomic, retained, optionally asynchronous checkpoints of parameter and
optimizer trees (port of ``repro.checkpoint.manager``).

Layout, as the reference writes it:  ``<dir>/step_<N>/arrays.npz`` (leaves
``a0 .. an`` in ``jax.tree.flatten`` order: the keys of every dict sorted,
``core.drift.flatten``) and ``tree.json`` (``{"n", "step"}``), with a
``<dir>/LATEST`` pointer.  A save writes into a temporary directory and
renames it into place, then replaces ``LATEST`` with ``os.replace``, so a
crash mid-save never corrupts the restore path; the newest ``keep`` steps
are retained.  A checkpoint written by either package restores in the
other.

The snapshot owns its bytes.  The port's train step and ``adamw.update``
write parameters and moments in place, and ``.numpy()`` of a CPU tensor
aliases its storage, so ``save`` copies every leaf to the host before it
returns (``detach().to("cpu", copy=True)``, a synchronous copy for CUDA
tensors): an in-place update between ``save(blocking=False)`` and
``wait()`` never reaches the file.

bfloat16 leaves (numpy has no bfloat16) are stored as their raw 16-bit
patterns, ``uint16`` arrays, and restored by reinterpreting those bits as
the bfloat16 template leaf's, bit for bit; a 2-byte leaf of ``repro``'s
(``ml_dtypes.bfloat16``, which ``np.savez`` writes as raw ``V2``) restores
the same way.  ``restore(template, step)`` gives each leaf the template
leaf's dtype and device; integer leaves (AdamW's int32 ``step``) keep
theirs.

On a mesh (``save(..., specs=, mesh=)``) the tree holds this rank's
shards at ``specs``: every rank gathers each leaf whole
(``nn.module.gather_tree``), rank 0 writes, and all ranks wait for the
write (a barrier), so the files hold whole arrays as ``repro``'s do.
``restore(..., specs=, mesh=)`` slices each whole leaf to this rank's
shard at ``specs`` — another mesh's or table's than the save's
(``reshard.reshard_tree``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from ..core.drift import flatten
from ..core.naf import unflatten


def _host(x: torch.Tensor) -> np.ndarray:
    """A leaf as a numpy array that owns its bytes."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _leaf(arr: np.ndarray, tmpl: torch.Tensor) -> torch.Tensor:
    """``arr`` restored as ``tmpl``'s dtype on ``tmpl``'s device."""
    if tmpl.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "uV":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True)).to(tmpl.dtype)
    return t.to(tmpl.device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._pending: threading.Thread | None = None
        # a failed async write must not vanish with its thread: the writer
        # parks the exception here and the next save()/wait()/close()
        # re-raises it on the caller
        self._error: BaseException | None = None
        self._error_step: int | None = None
        os.makedirs(directory, exist_ok=True)

    def _check_error(self):
        if self._error is not None:
            err, step = self._error, self._error_step
            self._error = self._error_step = None
            raise RuntimeError(
                f"async checkpoint write for step {step} failed") from err

    # -- save ----------------------------------------------------------------
    def save(self, tree, step: int, blocking: bool = True, specs=None,
             mesh=None):
        """Write ``tree`` as step ``step`` (asynchronously where the
        manager is and ``blocking`` is False; on a ``mesh``, a blocking
        write by rank 0 of the gathered leaves)."""
        self._check_error()
        if mesh is not None and mesh.size > 1:
            from ..nn.module import gather_tree
            import torch.distributed as dist
            tree = gather_tree(tree, specs, mesh)
            if mesh.rank == 0:
                self._write_tree(tree, step, blocking=True)
            dist.barrier(group=mesh.groups["world"])
            return
        self._write_tree(tree, step, blocking)

    def _write_tree(self, tree, step: int, blocking: bool) -> None:
        host = [_host(x) for _, x in flatten(tree)]

        def _write():
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
            try:
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{f"a{i}": a for i, a in enumerate(host)})
                with open(os.path.join(tmp, "tree.json"), "w") as f:
                    json.dump({"n": len(host), "step": step}, f)
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                with open(os.path.join(self.dir, ".latest_tmp"), "w") as f:
                    f.write(str(step))
                os.replace(os.path.join(self.dir, ".latest_tmp"),
                           os.path.join(self.dir, "LATEST"))
                self._gc()
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)

        if self.async_write and not blocking:
            self.wait()

            def _guarded():
                try:
                    _write()
                except BaseException as exc:   # park it for the caller
                    self._error, self._error_step = exc, step

            self._pending = threading.Thread(target=_guarded, daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self):
        """Join the in-flight async write, re-raising its failure (the
        barrier a caller takes before reading the checkpoint)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._check_error()

    def close(self):
        """Join any pending writer and surface its error.  Idempotent;
        the manager stays usable (a barrier, not an invalidation)."""
        self.wait()

    def _gc(self):
        steps = self.available_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def available_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.dir, f"step_{s}")):
                return s
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int, specs=None, mesh=None):
        """Restore into the structure, dtypes and devices of
        ``template``; on a ``mesh``, each leaf sliced to this rank's
        shard at ``specs``."""
        path = os.path.join(self.dir, f"step_{step}")
        leaves = [x for _, x in flatten(template)]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            out = [_leaf(data[f"a{i}"], tmpl)
                   for i, tmpl in enumerate(leaves)]
        tree = unflatten(template, out)
        if mesh is not None:
            from .reshard import reshard_tree
            tree = reshard_tree(tree, specs, mesh)
        return tree

    def restore_latest(self, template, specs=None, mesh=None):
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(template, step, specs, mesh), step

"""Mesh construction and rank spawning (port of ``repro.launch.mesh``).

A mesh is a grid of processes (ranks), one ``parallel.context.Mesh`` per
rank.  ``repro`` forces host devices inside one process; the port runs one
process per mesh position and joins them with ``torch.distributed``:

* ``init_ranks(rank, world, port, device)`` joins a process group at
  ``tcp://localhost:<port>``.  The backend follows the device: **gloo** on
  the CPU; **NCCL** when every rank has a GPU of its own (rank ``r`` takes
  ``cuda:r``); **gloo over CUDA tensors** when ranks outnumber the GPUs,
  as on a one-card machine (NCCL refuses two ranks on one device; gloo
  stages each collective through host memory).  It prints the backend it
  took.
* ``make_mesh(shape, axes)`` builds this rank's view of a mesh over the
  process group (its per-axis groups; any axis names: ("pod",) is the
  pipeline's), ``serve_mesh(dp, tp)`` the serving and training mesh over
  ("data", "model"), ``single_device_mesh()`` the (1, 1) mesh of one
  process, ``make_production_mesh()`` the 16 x 16 (2 x 16 x 16
  multi-pod) one.  Each raises with the rank count it needs when the
  process group's world differs.
* ``run_ranks(fn, world, args, device=)`` spawns ``world`` processes,
  each joining the group and calling ``fn(*args)``; it returns their
  results in rank order (a failing rank fails the call).
"""
from __future__ import annotations

import math
import os
import socket

import torch

from ..parallel.context import Mesh


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def in_process_group() -> bool:
    """Whether this process is a rank already: inside a process group,
    or started by ``torchrun`` (which sets ``WORLD_SIZE``; the group is
    then joined here, its backend following the device)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = rank_device(dev, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev, world)
    dist.init_process_group(backend, rank=rank, world_size=world)
    if rank == 0:
        print(f"[mesh] {world} ranks (torchrun), backend "
              f"{describe_backend(backend, dev)}", flush=True)
    return True


def world_rank() -> int:
    """This process's rank (0 outside a process group)."""
    return _rank()


def backend_for(device: torch.device, world: int) -> str:
    """gloo on the CPU, NCCL when every rank has its own GPU, gloo over
    CUDA tensors when the ranks outnumber the GPUs."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def rank_device(device: torch.device, rank: int, world: int
                ) -> torch.device:
    """The device rank ``rank`` runs on: its own GPU under NCCL, the
    shared one otherwise."""
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    return torch.device("cuda", rank if world <= n else 0)


def describe_backend(backend: str, device: torch.device) -> str:
    if backend == "gloo" and device.type == "cuda":
        return ("gloo over CUDA tensors: collectives stage through host "
                "memory; not NCCL times")
    return backend


def init_ranks(rank: int, world: int, port: int, device,
               verbose: bool = True) -> torch.device:
    """Join the process group of ``world`` ranks at localhost:``port``;
    returns this rank's device."""
    import torch.distributed as dist
    device = torch.device(device)
    backend = backend_for(device, world)
    dev = rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    if verbose and rank == 0:
        print(f"[mesh] {world} ranks, backend "
              f"{describe_backend(backend, dev)}", flush=True)
    return dev


def make_mesh(shape: tuple, axes: tuple, device=None) -> Mesh:
    """This rank's view of a ``shape`` mesh over ``axes`` (the process
    group's ranks laid out row-major); every rank must call it, in the
    same order, since each builds every axis's process groups."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    need = math.prod(shape)
    if need != _world():
        raise ValueError(
            f"mesh {shape} over {axes} needs {need} ranks, the process "
            f"group has {_world()}; start {need} ranks (launch.mesh."
            f"run_ranks, or torchrun --nproc-per-node {need})")
    dims = dict(zip(axes, shape))
    rank = _rank()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() and dist.is_initialized()
                  and dist.get_backend() == "nccl" else torch.device("cpu"))
    mesh = Mesh(shape=dims, rank=rank, device=torch.device(device),
                backend=dist.get_backend() if dist.is_initialized()
                else None)
    if need == 1:
        return mesh
    mesh.groups["world"] = dist.group.WORLD
    strides = {}
    s = 1
    for ax in reversed(axes):
        strides[ax] = s
        s *= dims[ax]
    for ax in axes:
        if dims[ax] == 1:
            continue
        others = [a for a in axes if a != ax]
        # every combination of the other coordinates, in row-major order
        combos = [{}]
        for a in others:
            combos = [dict(c, **{a: i}) for c in combos
                      for i in range(dims[a])]
        for c in combos:
            base = sum(c[a] * strides[a] for a in others)
            ranks = [base + i * strides[ax] for i in range(dims[ax])]
            g = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[ax] = g
    return mesh


def serve_mesh(dp: int, tp: int, device=None) -> Mesh:
    """The serving mesh (dp, tp) over ("data", "model"): slots and
    position tracks split over "data", heads and KV pools over "model"
    (DESIGN.md §9); the train step's mesh too.  Needs dp * tp ranks."""
    if dp * tp != _world():
        raise ValueError(
            f"serve mesh ({dp}, {tp}) needs {dp * tp} ranks, the process "
            f"group has {_world()}; spawn {dp * tp} ranks "
            f"(launch.mesh.run_ranks, or torchrun --nproc-per-node "
            f"{dp * tp}), or shrink the mesh")
    return make_mesh((dp, tp), ("data", "model"), device)


def single_device_mesh(device="cpu") -> Mesh:
    """The (1, 1) mesh of one process: every placement replicated."""
    return Mesh(shape={"data": 1, "model": 1}, device=torch.device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh: (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model") — 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, device, args, queue):
    # CPU ranks share the host's cores; a card's ranks need few
    torch.set_num_threads(1 if device.type == "cpu"
                          else max(1, (os.cpu_count() or 1) // world))
    dev = init_ranks(rank, world, port, device)
    import torch.distributed as dist
    out = fn(*args, dev)
    # every rank done with every collective before any closes its
    # connections (a rank that tears down early aborts a peer still
    # finishing its last exchange)
    dist.barrier()
    dist.destroy_process_group()
    queue.put((rank, out))


def run_ranks(fn, world: int, args: tuple = (), *, device="cpu",
              port: int | None = None) -> list:
    """Spawn ``world`` ranks; each joins the process group and calls
    ``fn(*args, rank_device)``.  Returns the ranks' results in rank order
    (picklable; CPU tensors); a rank that raises fails the call.  ``fn``
    must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(fn, world, port or free_port(),
                          torch.device(device), args, queue),
        nprocs=world, join=False, start_method="spawn")
    out: dict = {}
    done = False
    while not done:
        # drain while waiting: a rank blocks in put() until its result
        # is read
        done = procs.join(timeout=0.05)
        while not queue.empty():
            r, v = queue.get()
            out[r] = v
    return [out[r] for r in range(world)]

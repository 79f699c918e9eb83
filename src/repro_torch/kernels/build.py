"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``: pointers and the stream pass as
``c_void_p``, outputs are allocated by the Python wrappers, and every
launch function returns its ``cudaGetLastError()`` code, which
``check`` raises on.  Libraries go to ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``) and are built at first use, from
the repository's sources only; a library's name hashes its source and the
shared headers (``csrc/*.cuh``) it may include.  ``build_all`` starts one
``nvcc`` per source at once, so a fresh checkout pays the slowest compile,
not the sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "dual_compute", "flash_attention",
           "logdomain_flash", "acam_activation", "crossbar_vmm",
           "nldpe_qmatmul")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# the crossbar family's tiles, by xbar::Variant (csrc/xbar_tiles.cuh)
TILE_VARIANTS = ("small 16x32", "mid 64x64", "large 128x128")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header of ``csrc/`` (``*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path, verbose: bool) -> list[str]:
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(out), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel source that has no up-to-date library, all
    ``nvcc`` processes in parallel.  Returns ``{name: compiler output}``
    for the sources compiled (``-Xptxas -v`` register and shared-memory
    reports when ``verbose``); raises with the compiler's message if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, out, subprocess.Popen(
                _command(name, tmp, verbose), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")

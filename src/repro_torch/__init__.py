"""PyTorch + CUDA port of the NL-DPE reproduction (``src/repro``).

The package mirrors ``repro``'s layout and module names so each ported
function sits where its JAX counterpart does.  It imports ``torch`` and
numpy only — never ``jax`` and nothing of ``repro`` — and its entry points
run on the GPU unless the caller asks for the CPU (``device="cpu"``, as
the tests do).  With no GPU and no explicit CPU request they raise rather
than continue on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: ``cuda`` when a GPU is present, otherwise a
    ``RuntimeError`` — a serve or kernel run that silently fell back to
    the CPU would report CPU numbers as the port's.  Pass ``"cpu"`` (or a
    ``torch.device``) to choose explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device

"""The single-variable function zoo NL-DPE computes with ACAMs (port of
``repro.core.functions``; the host-numpy definitions are copied verbatim).

Table I of the paper profiles: Sigmoid, Tanh, SiLU, GELU, ReLU, Identity,
log, exp.  These are the functions that get converted to per-bit decision
trees and programmed into ACAM arrays.  Each entry carries a *reference
domain* used when profiling row counts (the paper profiles 8-bit versions
over the ranges the tested models exercise; we use symmetric [-8, 8] for
activations and the DMMul log/exp ranges for log/exp, all overridable).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    name: str
    fn: Callable
    domain: tuple[float, float]
    monotonic: bool = True


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _tanh(x):
    return np.tanh(x)


def _silu(x):
    return x * _sigmoid(x)


def _gelu(x):
    # tanh approximation (matches jax.nn.gelu(approximate=True))
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


def _relu(x):
    return np.maximum(x, 0.0)


def _identity(x):
    return x


def _log(x):
    return np.log(np.maximum(x, 1e-12))


def _exp(x):
    return np.exp(x)


def _dyn_tanh(x, alpha: float = 1.0):
    """Dynamic Tanh (paper §VII "Other operators", ref [42])."""
    return np.tanh(alpha * x)


FUNCTIONS: dict[str, FunctionSpec] = {
    "sigmoid": FunctionSpec("sigmoid", _sigmoid, (-8.0, 8.0)),
    "tanh": FunctionSpec("tanh", _tanh, (-8.0, 8.0)),
    "silu": FunctionSpec("silu", _silu, (-8.0, 8.0), monotonic=False),
    "gelu": FunctionSpec("gelu", _gelu, (-8.0, 8.0), monotonic=False),
    "relu": FunctionSpec("relu", _relu, (-8.0, 8.0)),
    "identity": FunctionSpec("identity", _identity, (-8.0, 8.0)),
    "log": FunctionSpec("log", _log, (1e-4, 8.0)),
    "exp": FunctionSpec("exp", _exp, (-8.0, 2.0)),
    "dyn_tanh": FunctionSpec("dyn_tanh", _dyn_tanh, (-8.0, 8.0)),
}


# torch twins for model code (ideal, non-ACAM references)
TORCH_FUNCTIONS: dict[str, Callable] = {
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "tanh": torch.tanh,
    "silu": lambda x: x * (1.0 / (1.0 + torch.exp(-x))),
    "gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3))),
    "relu": lambda x: torch.clamp(x, min=0.0),
    "identity": lambda x: x,
    "log": lambda x: torch.log(torch.clamp(x, min=1e-12)),
    "exp": torch.exp,
    "dyn_tanh": torch.tanh,
}

TABLE1_FUNCTIONS = ["sigmoid", "tanh", "silu", "gelu", "relu", "identity", "log", "exp"]

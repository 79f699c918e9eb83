"""ArchConfig — the port's copy of ``repro.configs.base`` (field names kept).

Only the dense attention family is ported (``qwen2_5_3b``, ``qwen2_7b``,
``minicpm_2b``: the ``("attn",)`` pattern); the other families' fields
stay so configs round-trip by name, and the model rejects patterns it
cannot run.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    rope_theta_global: float | None = None
    tie_embeddings: bool = False
    layer_pattern: tuple = ("attn",)
    window: int | None = None
    qk_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    embed_scale: bool = False
    scan_remat: bool = True           # train: recompute each layer backward
    kv_cache_dtype: str = "bf16"
    activation_dtype: torch.dtype = torch.bfloat16
    notes: str = ""
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count of the dense attention pattern
        (embeddings + blocks + head), as ``repro``'s for ``("attn",)``."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d
        if not self.tie_embeddings:
            total += d * v
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        ffn = (3 if self.gated_mlp else 2) * d * self.d_ff
        return total + self.n_layers * (attn + ffn + 2 * d)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    mod = importlib.import_module(f".{name.replace('-', '_')}", __package__)
    return mod.reduced() if reduced else mod.CONFIG

"""ArchConfig — the port's copy of ``repro.configs.base`` (field names kept).

Ported families: the dense attention pattern ``("attn",)`` (``qwen2_5_3b``,
``qwen2_7b``, ``minicpm_2b``), Gemma3's local:global sliding-window
pattern (``gemma3_27b``), RecurrentGemma's RG-LRU hybrid
(``recurrentgemma_9b``), the MoE pattern ``("moe",)``
(``qwen3_moe_30b_a3b``, ``llama4_scout_17b_a16e``), RWKV6 (``rwkv6_3b``),
PaliGemma's image prefix (``paligemma_3b``: ``frontend="siglip_stub"``,
``n_patches`` precomputed patch embeddings prepended under a prefix-LM
mask) and the MusicGen backbone (``musicgen_large``: ``"encodec_stub"``,
token ids in, a plain GELU MLP).  ``repro``'s dry-run accounting
(``input_specs``, ``SHAPES``) is not ported.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from ..nn.moe import MoESpec


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
    moe: MoESpec | None = None        # the expert FFN of "moe" blocks
    d_rnn: int | None = None          # RG-LRU width ("rec" blocks)
    frontend: str | None = None       # "siglip_stub" | "encodec_stub"
    n_patches: int = 256              # vlm prefix length
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
        """Analytic parameter count (embeddings + blocks + head), as
        ``repro``'s."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d
        if not self.tie_embeddings:
            total += d * v
        pat = self.layer_pattern
        counts = {t: 0 for t in pat}
        for i in range(self.n_layers):
            counts[pat[i % len(pat)]] += 1
        for t, n in counts.items():
            ffn = (3 if self.gated_mlp else 2) * d * self.d_ff
            if t in ("attn", "local", "global", "moe"):
                blk = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
            elif t == "rec":
                dr = self.d_rnn or d
                blk = 2 * d * dr + 3 * dr * dr + dr * d
            elif t == "rwkv":
                blk = 0
                ffn = 2 * d * self.d_ff + 6 * d * d   # cm + tm projections
            else:
                raise ValueError(t)
            if t == "moe":
                m = self.moe
                ffn = m.n_experts * (3 * d * m.d_expert_ff) + d * m.n_experts
            total += n * (blk + ffn + 2 * d)
        return total

    def active_param_count(self) -> int:
        """MoE: the parameters one token routes through (``top_k`` of the
        experts), as ``repro``'s; the whole count otherwise."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert_ff
        return (self.param_count() - self.n_layers * m.n_experts * per_expert
                + self.n_layers * m.top_k * per_expert)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    mod = importlib.import_module(f".{name.replace('-', '_')}", __package__)
    return mod.reduced() if reduced else mod.CONFIG

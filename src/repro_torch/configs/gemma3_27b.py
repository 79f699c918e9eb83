"""Gemma3-27B: 62L d=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
5:1 local:global (window 1024), 128k context.  [hf:google/gemma-3; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab_size=262144, head_dim=128, qk_norm=True, embed_scale=True,
    tie_embeddings=True,
    act="gelu", gated_mlp=True,
    rope_theta=10000.0, rope_theta_global=1e6,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    source="hf:google/gemma-3-27b (family config; 1b-pt verified tier)",
    notes="62 = 10x(5 local + 1 global) + 2 local tail; global layers use "
          "rope theta 1M.")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, window=16, scan_remat=False)

"""Qwen2.5-3B: 36L d=2048 16H (GQA kv=2) d_ff=11008 vocab=151936; QKV bias.
[hf:Qwen/Qwen2.5 family; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    act="silu", gated_mlp=True, rope_theta=1e6,
    layer_pattern=("attn",),
    source="hf:Qwen/Qwen2.5-3B (0.5B config verified tier)",
    notes="GQA kv=2 — below TP16, exercises the context-parallel KV fallback.")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, scan_remat=False)

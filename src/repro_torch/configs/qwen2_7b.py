"""Qwen2-7B: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; QKV bias.
[arXiv:2407.10671; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab_size=152064, qkv_bias=True,
    act="silu", gated_mlp=True, rope_theta=1e6,
    layer_pattern=("attn",),
    source="arXiv:2407.10671",
    notes="GQA with QKV bias; canonical Fig-6c NL-DPE attention target.")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, scan_remat=False)

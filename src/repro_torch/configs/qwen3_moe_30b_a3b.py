"""Qwen3-30B-A3B: 48L d=2048 32H (GQA kv=4) MoE 128e top-8, d_expert_ff=768.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from ..nn.moe import MoESpec
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab_size=151936, head_dim=128, qk_norm=True,
    act="silu", gated_mlp=True, rope_theta=1e6,
    layer_pattern=("moe",),
    moe=MoESpec(n_experts=128, top_k=8, d_expert_ff=768),
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="128-expert fine-grained MoE; per-layer MoE FFN; qk-norm.")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        moe=MoESpec(n_experts=8, top_k=2, d_expert_ff=32,
                    capacity_factor=0.0), scan_remat=False)

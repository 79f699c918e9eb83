"""Llama4-Scout-17B-16E: 48L d=5120 40H (GQA kv=8) MoE 16e top-1, d_ff=8192.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from ..nn.moe import MoESpec
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128,
    act="silu", gated_mlp=True, rope_theta=5e5,
    layer_pattern=("moe",),
    moe=MoESpec(n_experts=16, top_k=1, d_expert_ff=8192,
                router_norm_topk=False),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    notes="top-1 routing (argmax comparator in NL-DPE terms); early fusion "
          "multimodality not in scope of the assigned backbone.")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256,
        moe=MoESpec(n_experts=4, top_k=1, d_expert_ff=64, router_norm_topk=False,
                    capacity_factor=0.0), scan_remat=False)

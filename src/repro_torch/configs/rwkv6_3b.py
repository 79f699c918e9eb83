"""RWKV6-3B "Finch": 32L d=2560 (attention-free) d_ff=8960 vocab=65536;
data-dependent decay.  [arXiv:2404.05892; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab_size=65536,
    act="relu", gated_mlp=False, rope_theta=10000.0,
    layer_pattern=("rwkv",),
    source="arXiv:2404.05892",
    notes="head size 64 (40 heads); exp(-exp(.)) decay + element-wise "
          "products are the best structural fit for the paper's ACAM "
          "exp/log primitives (DESIGN.md §4).")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
        vocab_size=256, scan_remat=False)

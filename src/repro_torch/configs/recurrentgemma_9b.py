"""RecurrentGemma-9B (Griffin): 38L d=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention 1:2 pattern, window 2048.
[arXiv:2402.19427; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab_size=256000, head_dim=256, embed_scale=True, tie_embeddings=True,
    act="gelu", gated_mlp=True, rope_theta=10000.0,
    layer_pattern=("rec", "rec", "local"),
    window=2048, d_rnn=4096,
    source="arXiv:2402.19427",
    notes="38 = 12x(rec,rec,local) + (rec,rec) tail; RG-LRU gates map to "
          "ACAM sigmoids, recurrence products to log-domain DMMul.")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, window=16, d_rnn=64, scan_remat=False)

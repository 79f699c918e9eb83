"""MiniCPM-2B: 40L d=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753.
WSD schedule (arch llama-like).  [arXiv:2404.06395; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753, tie_embeddings=True,
    act="silu", gated_mlp=True, rope_theta=10000.0,
    layer_pattern=("attn",),
    source="arXiv:2404.06395",
    notes="llama-like; the paper's WSD (warmup-stable-decay) schedule is "
          "implemented in repro_torch.optim.schedules.")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, d_ff=144,
        vocab_size=255, scan_remat=False)

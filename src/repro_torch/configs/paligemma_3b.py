"""PaliGemma-3B: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.
SigLIP frontend is a STUB (precomputed patch embeddings); prefix-LM mask.
[arXiv:2407.07726; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=257216, head_dim=256, embed_scale=True, tie_embeddings=True,
    act="gelu", gated_mlp=True, rope_theta=10000.0,
    layer_pattern=("attn",),
    frontend="siglip_stub", n_patches=256,
    source="arXiv:2407.07726",
    notes="input_specs supplies (B, 256, d) precomputed SigLIP patch "
          "embeddings; attention is bidirectional over the image prefix.")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, n_patches=8, scan_remat=False)

"""MusicGen-large: 48L d=2048 32H (MHA kv=32) d_ff=8192 vocab=2048;
decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048,
    act="gelu", gated_mlp=False, rope_theta=10000.0,
    layer_pattern=("attn",),
    frontend="encodec_stub",
    source="arXiv:2306.05284",
    notes="backbone only per the brief: EnCodec tokenizer and T5 text "
          "conditioning are stubs (inputs are precomputed token ids); "
          "plain (non-gated) GELU FFN; RoPE replaces the original learned "
          "positional embedding (TPU-idiomatic; noted in DESIGN.md).")


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=128, scan_remat=False)

"""Architecture configs of the port: the ``("attn",)`` family, Gemma3's
local:global pattern, RecurrentGemma's RG-LRU hybrid, the MoE pattern
(Qwen3-30B-A3B, Llama4-Scout), RWKV6, PaliGemma (the VLM prefix) and the
MusicGen backbone: all ten of ``repro``'s architectures."""
from .base import ArchConfig, get_config

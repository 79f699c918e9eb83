"""Architecture configs of the port: the ``("attn",)`` family, Gemma3's
local:global pattern, RecurrentGemma's RG-LRU hybrid, the MoE pattern
(Qwen3-30B-A3B, Llama4-Scout) and RWKV6."""
from .base import ArchConfig, get_config

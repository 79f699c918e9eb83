"""Architecture configs of the port: the ``("attn",)`` family, Gemma3's
local:global pattern and RecurrentGemma's RG-LRU hybrid."""
from .base import ArchConfig, get_config

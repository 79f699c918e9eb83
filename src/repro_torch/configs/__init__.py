"""Architecture configs of the port (the ``("attn",)`` family)."""
from .base import ArchConfig, get_config

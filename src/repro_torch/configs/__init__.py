"""Architecture configs of the port (the paged engine's model)."""
from .base import ArchConfig, get_config

"""Checkpointing of the port (``repro.checkpoint``'s manager)."""

"""Layers of the port: embedding, norms, rotary, attention, MLP."""

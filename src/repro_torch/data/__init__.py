"""Training data of the port (``repro.data``'s synthetic token pipeline)."""

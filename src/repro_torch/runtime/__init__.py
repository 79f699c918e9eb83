"""The fault-tolerant step loop of the port (``repro.runtime``)."""

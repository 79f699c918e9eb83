"""Sharding rules, the ambient sharding context and context-parallel
decode (port of ``repro.parallel``'s serving half)."""

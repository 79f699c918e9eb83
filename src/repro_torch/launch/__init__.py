"""Serving of the port: paged engine, page pool, sampling, CLI."""

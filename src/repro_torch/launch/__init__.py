"""Serving of the port: slotted and paged engines, page pool, lockstep
steps and CLI, sampling and its threefry keys."""

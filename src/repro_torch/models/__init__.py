"""Models of the port (the dense LM the paged engine serves)."""

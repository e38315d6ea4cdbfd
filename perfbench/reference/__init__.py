"""Plain float32 references: PyTorch only, no kernel of the port and nothing
imported from it or from JAX."""

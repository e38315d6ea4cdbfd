"""Fused K-means assignment: CUDA kernel, wrapper and plain version."""

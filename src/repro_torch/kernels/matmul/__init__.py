"""Stacked block GEMM: CUDA kernel, wrapper and plain version."""

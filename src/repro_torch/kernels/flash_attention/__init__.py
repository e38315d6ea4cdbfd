"""Fused attention: the CUDA kernel ``csrc/flash_attention.cu``, its wrapper
and its plain PyTorch version."""

"""Mamba-2 SSD: the CUDA chunk kernel ``csrc/ssd_chunk.cu``, its wrapper, the
plain PyTorch versions and the public scan."""

"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes wrappers
and their plain PyTorch versions.  A wrapper launches its kernel for a CUDA
tensor and takes the plain version only for a CPU tensor; kernels are built
by ``_build`` at first use, never at import."""

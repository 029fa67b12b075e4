"""Attention ops and the port's hand-written CUDA kernels."""

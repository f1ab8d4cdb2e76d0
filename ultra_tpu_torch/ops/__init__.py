"""Relational message-passing ops and their CUDA kernels."""

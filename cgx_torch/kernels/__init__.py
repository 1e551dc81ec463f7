"""Hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``cgx.kernels``.
"""

"""Hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``cgx.kernels``; exports the block-ELL surface as the JAX
package does.
"""
from cgx_torch.kernels.bsr import (BlockELL, bell_from_bsr, bell_spmm,
                                   bell_spmv)

__all__ = ["BlockELL", "bell_from_bsr", "bell_spmm", "bell_spmv"]

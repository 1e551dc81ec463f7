"""cgx_torch — the PyTorch / CUDA port of cgx for NVIDIA Hopper.

The JAX package ``cgx`` is the reference; every module here has one
counterpart there.  Plain tensor code is PyTorch; the TPU kernels on the
ported path are hand-written CUDA C++ for ``sm_90a`` under
``cgx_torch/csrc``, built with ``nvcc`` at first use.  Importing this
package imports neither JAX nor ``cgx`` and needs no GPU.
"""
from cgx_torch.sparse.stencil import (GeneralStencil3D, Stencil2D, Stencil3D,
                                      poisson2d_stencil, poisson3d_27point,
                                      poisson3d_stencil)
from cgx_torch.ops.spmv import spmm, spmv
from cgx_torch.ops import blas
from cgx_torch.solve.cg import CGResult, cg_solve
from cgx_torch.solve.auto import auto_solve, select_backend

__version__ = "0.1.0"

__all__ = [
    "Stencil2D", "Stencil3D", "GeneralStencil3D", "poisson2d_stencil",
    "poisson3d_stencil", "poisson3d_27point", "spmv", "spmm", "blas",
    "CGResult", "cg_solve", "auto_solve", "select_backend",
]

"""Sparse matrix–vector / matrix–matrix products (PyTorch).

Counterpart of :mod:`cgx.ops.spmv` for the matrix-free stencils.  A
``Stencil3D`` SpMV on a CUDA tensor goes through the hand-written CUDA
kernel (:func:`cgx_torch.kernels.stencil.stencil3d_spmv`), which takes
float32 only; on a CPU tensor the same wrapper takes its plain PyTorch
version, in any dtype.  The 2-D and general stencils use their plain
``matvec`` on every device, as in the JAX package.  Stored formats
(CSR/COO/ELL/BSR/DIA/WBELL) are not ported yet and raise ``TypeError``.
"""
from __future__ import annotations

import functools

import torch

from cgx_torch.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D

__all__ = ["spmv", "spmm"]


@functools.singledispatch
def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for a cgx_torch operator."""
    raise TypeError(f"spmv: unsupported operand type {type(a)!r}")


@functools.singledispatch
def spmm(a, x: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for a dense block of right-hand sides ``X: (m, k)``."""
    raise TypeError(f"spmm: unsupported operand type {type(a)!r}")


@spmv.register(Stencil2D)
@spmv.register(GeneralStencil3D)
def _stencil_spmv(a, x: torch.Tensor) -> torch.Tensor:
    return a.matvec(x)


@spmv.register(Stencil3D)
def _stencil3d_spmv(a, x: torch.Tensor) -> torch.Tensor:
    from cgx_torch.kernels.stencil import stencil3d_spmv
    return stencil3d_spmv(x, nx=a.nx, ny=a.ny, nz=a.nz,
                          coeffs=(a.c_center, a.c_x, a.c_y, a.c_z))


@spmm.register(Stencil2D)
@spmm.register(Stencil3D)
@spmm.register(GeneralStencil3D)
def _stencil_spmm(a, x: torch.Tensor) -> torch.Tensor:
    return torch.stack([a.matvec(x[:, j]) for j in range(x.shape[1])],
                       dim=1)

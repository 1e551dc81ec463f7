"""Sparse matrix–vector / matrix–matrix products (PyTorch).

Counterpart of :mod:`cgx.ops.spmv` for the matrix-free stencils and the
COO, CSR, BSR, ELL, DIA and WBELL formats.  A ``Stencil3D`` SpMV on a CUDA tensor
goes through the hand-written CUDA kernel (:func:`cgx_torch.kernels.
stencil.stencil3d_spmv`), which takes float32 only; on a CPU tensor the
same wrapper takes its plain PyTorch version, in any dtype.  A
``WBELLMatrix`` product takes internal-layout vectors and goes through
K7 (:func:`cgx_torch.kernels.wbell.wbell_spmv`/``wbell_spmm``; ``X`` is
``(nrhs, nt, 8, 128)``).  The 2-D and general stencils, COO and CSR
(gather + ``index_add``), BSR (gather of ``x``'s blocks, a batched
``(bs, bs)`` product, ``index_add`` over block rows), ELL (gather + row
sum) and DIA (shifted multiply-adds) are plain PyTorch on every device,
as the JAX package leaves them to XLA.  The block-ELL kernel K11 is
reached through :func:`cgx_torch.kernels.bsr.bell_spmm`, not from here.
"""
from __future__ import annotations

import functools

import torch

from cgx_torch.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D
from cgx_torch.sparse.types import (BSRMatrix, COOMatrix, CSRMatrix,
                                    DIAMatrix, ELLMatrix)
from cgx_torch.sparse.wbell import WBELLMatrix
from cgx_torch.kernels.wbell import wbell_spmm, wbell_spmv

__all__ = ["spmv", "spmm", "shifted"]


@functools.singledispatch
def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for a cgx_torch operator."""
    raise TypeError(f"spmv: unsupported operand type {type(a)!r}")


@functools.singledispatch
def spmm(a, x: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for a dense block of right-hand sides ``X: (m, k)``."""
    raise TypeError(f"spmm: unsupported operand type {type(a)!r}")


# -- COO and CSR (both carry the row id of every nonzero) ---------------------

@spmv.register(COOMatrix)
@spmv.register(CSRMatrix)
def _csr_spmv(a, x: torch.Tensor) -> torch.Tensor:
    prods = a.values * x[a.col_indices]
    y = torch.zeros(a.shape[0], dtype=prods.dtype, device=prods.device)
    return y.index_add_(0, a.row_indices, prods)


@spmm.register(COOMatrix)
@spmm.register(CSRMatrix)
def _csr_spmm(a, x: torch.Tensor) -> torch.Tensor:
    prods = a.values[:, None] * x[a.col_indices]
    y = torch.zeros((a.shape[0], x.shape[1]), dtype=prods.dtype,
                    device=prods.device)
    return y.index_add_(0, a.row_indices, prods)


# -- BSR ----------------------------------------------------------------------

@spmv.register(BSRMatrix)
def _bsr_spmv(a, x: torch.Tensor) -> torch.Tensor:
    return _bsr_spmm(a, x[:, None])[:, 0]


@spmm.register(BSRMatrix)
def _bsr_spmm(a, x: torch.Tensor) -> torch.Tensor:
    bs = a.blocksize
    k = x.shape[1]
    xb = x.reshape(-1, bs, k)                   # (n_block_cols, bs, k)
    prods = torch.bmm(a.values, xb[a.col_indices])   # (nnzb, bs, k)
    y = torch.zeros((a.shape[0] // bs, bs, k), dtype=prods.dtype,
                    device=prods.device)
    return y.index_add_(0, a.row_indices, prods).reshape(-1, k)


# -- ELL ----------------------------------------------------------------------

@spmv.register(ELLMatrix)
def _ell_spmv(a, x: torch.Tensor) -> torch.Tensor:
    return torch.sum(a.values * x[a.col_indices], dim=1)


@spmm.register(ELLMatrix)
def _ell_spmm(a, x: torch.Tensor) -> torch.Tensor:
    return torch.sum(a.values[..., None] * x[a.col_indices], dim=1)


# -- DIA ----------------------------------------------------------------------

def shifted(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``shifted(x, o)[i] = x[i + o]`` with zero fill (along dim 0)."""
    if offset == 0:
        return x
    out = torch.zeros_like(x)
    n = x.shape[0]
    if abs(offset) >= n:
        return out
    if offset > 0:
        out[:n - offset] = x[offset:]
    else:
        out[-offset:] = x[:n + offset]
    return out


@spmv.register(DIAMatrix)
def _dia_spmv(a, x: torch.Tensor) -> torch.Tensor:
    y = a.data[0] * shifted(x, a.offsets[0])
    for k in range(1, len(a.offsets)):
        y = y + a.data[k] * shifted(x, a.offsets[k])
    return y


@spmm.register(DIAMatrix)
def _dia_spmm(a, x: torch.Tensor) -> torch.Tensor:
    y = a.data[0][:, None] * shifted(x, a.offsets[0])
    for k in range(1, len(a.offsets)):
        y = y + a.data[k][:, None] * shifted(x, a.offsets[k])
    return y


# -- WBELL (internal layout, kernel K7) ---------------------------------------

@spmv.register(WBELLMatrix)
def _wbell_spmv(a, x: torch.Tensor) -> torch.Tensor:
    return wbell_spmv(a, x)


@spmm.register(WBELLMatrix)
def _wbell_spmm(a, x: torch.Tensor) -> torch.Tensor:
    return wbell_spmm(a, x)


# -- Matrix-free stencils -----------------------------------------------------

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

"""Sparse matrix–vector / matrix–matrix products (PyTorch).

Counterpart of :mod:`cgx.ops.spmv` for the matrix-free stencils and the
COO, CSR, BSR, ELL, DIA and WBELL formats.  A ``Stencil3D`` SpMV on a
contiguous float32 CUDA vector goes through the hand-written CUDA kernel
(:func:`cgx_torch.kernels.stencil.stencil3d_spmv`); any other dtype or
layout on the card takes the plain ``matvec``, as the JAX package's
default ``backend="xla"`` does, and on a CPU tensor the wrapper takes its
plain PyTorch version.  A ``WBELLMatrix`` product takes internal-layout
vectors and goes through K7 (:func:`cgx_torch.kernels.wbell.wbell_spmv`/
``wbell_spmm``; ``X`` is ``(nrhs, nt, 8, 128)``).  The 2-D and general
stencils, COO and CSR (gather + a row-ordered sum), BSR (gather of
``x``'s blocks, a batched ``(bs, bs)`` product, a row-ordered sum over
block rows), ELL (gather + row sum) and DIA (shifted multiply-adds) are
plain PyTorch on every device, as the JAX package leaves them to XLA.  The
block-ELL kernel K11 is reached through
:func:`cgx_torch.kernels.bsr.bell_spmm`, not from here.

The COO/CSR/BSR sums add each row's entries one at a time in storage
order, one slot of every row per step (:func:`row_sum`): no float atomics,
so a product gives the same bits every run, on the card as on the CPU
(``index_add_`` on CUDA sums with atomics in an order that can change).
"""
from __future__ import annotations

import functools

import torch

from cgx_torch.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D
from cgx_torch.sparse.types import (BSRMatrix, COOMatrix, CSRMatrix,
                                    DIAMatrix, ELLMatrix)
from cgx_torch.sparse.wbell import WBELLMatrix
from cgx_torch.kernels.wbell import wbell_spmm, wbell_spmv

__all__ = ["spmv", "spmm", "shifted", "row_sum"]


@functools.singledispatch
def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for a cgx_torch operator."""
    raise TypeError(f"spmv: unsupported operand type {type(a)!r}")


@functools.singledispatch
def spmm(a, x: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for a dense block of right-hand sides ``X: (m, k)``."""
    raise TypeError(f"spmm: unsupported operand type {type(a)!r}")


# -- The row-ordered sum ------------------------------------------------------

def row_sum(rows: torch.Tensor, vals: torch.Tensor, nrows: int,
            rows_sorted: bool = False) -> torch.Tensor:
    """``y[i] = Σ vals[j]`` over the ``j`` with ``rows[j] == i``, each row
    adding its entries one at a time in the order they are stored, from 0
    (what ``index_add_`` computes on the CPU, bit for bit).

    Step ``s`` adds the ``s``-th entry of every row that has one: the rows
    of a step are distinct, so there are no atomics and the bits do not
    change from run to run.  The rows are walked longest first, so step
    ``s`` touches a prefix of that order and the steps together touch each
    entry once.  One host read per call (the rows in each step); as many
    steps as the longest row has entries.  ``rows_sorted``: the entries
    are already grouped by row in storage order (CSR), so no stable sort
    is needed.
    """
    y = torch.zeros((nrows,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                    device=vals.device)
    if rows.numel() == 0:
        return y
    rows = rows.to(torch.int64)
    if not rows_sorted:
        order = torch.argsort(rows, stable=True)
        rows, vals = rows[order], vals[order]
    counts = torch.bincount(rows, minlength=nrows)
    first = torch.cumsum(counts, 0) - counts
    longest_first = torch.argsort(counts, descending=True, stable=True)
    # Rows with more than s entries, for s = 0 .. longest − 1.
    at_least = nrows - torch.cumsum(torch.bincount(counts), 0)[:-1]
    for s, size in enumerate(at_least.tolist()):
        r = longest_first[:size]
        y[r] = y[r] + vals[first[r] + s]
    return y


# -- COO and CSR (both carry the row id of every nonzero) ---------------------

@spmv.register(COOMatrix)
@spmv.register(CSRMatrix)
def _csr_spmv(a, x: torch.Tensor) -> torch.Tensor:
    return row_sum(a.row_indices, a.values * x[a.col_indices], a.shape[0],
                   isinstance(a, CSRMatrix))


@spmm.register(COOMatrix)
@spmm.register(CSRMatrix)
def _csr_spmm(a, x: torch.Tensor) -> torch.Tensor:
    return row_sum(a.row_indices, a.values[:, None] * x[a.col_indices],
                   a.shape[0], isinstance(a, CSRMatrix))


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
    return row_sum(a.row_indices, prods, a.shape[0] // bs).reshape(-1, k)


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
    if x.device.type == "cuda" and (x.dtype != torch.float32
                                    or not x.is_contiguous()
                                    or x.dim() != 1):
        return a.matvec(x)        # K1 takes contiguous float32 vectors only
    return stencil3d_spmv(x, nx=a.nx, ny=a.ny, nz=a.nz,
                          coeffs=(a.c_center, a.c_x, a.c_y, a.c_z))


@spmm.register(Stencil2D)
@spmm.register(Stencil3D)
@spmm.register(GeneralStencil3D)
def _stencil_spmm(a, x: torch.Tensor) -> torch.Tensor:
    return torch.stack([a.matvec(x[:, j]) for j in range(x.shape[1])],
                       dim=1)

"""Stored sparse formats (PyTorch): COO, CSR, BSR, ELL and DIA.

Counterpart of :mod:`cgx.sparse.types`: :class:`COOMatrix` (triplets,
sorted by row then column), :class:`CSRMatrix` (what a scipy matrix
arrives as), :class:`BSRMatrix` (dense ``(bs, bs)`` blocks, the input of
the block-ELL kernel K11, :mod:`cgx_torch.kernels.bsr`),
:class:`ELLMatrix` (near-uniform row degrees,
:func:`cgx_torch.sparse.wbell.auto_format`'s first choice) and
:class:`DIAMatrix` (the variable-coefficient banded operators that the
whole-solve and two-pass kernels run).

The containers are frozen dataclasses holding tensors.  Index arrays are
``int64``, PyTorch's index type, where the JAX package keeps ``int32``.
The host conversions (:func:`csr_from_scipy`, :func:`coo_from_scipy`,
:func:`bsr_from_csr`, :func:`ell_from_csr`, :func:`dia_from_csr`) run once
at set-up in numpy and scipy, as in the JAX package.  A builder puts its
result on ``device``, the card unless the caller asks for the CPU;
:func:`resolve_device` raises when the card is missing rather than
falling back.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["COOMatrix", "CSRMatrix", "BSRMatrix", "ELLMatrix", "DIAMatrix",
           "csr_from_scipy", "coo_from_scipy", "bsr_from_csr",
           "ell_from_csr", "dia_from_csr", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`.  A CUDA device on a machine
    without a card raises: no builder falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cgx_torch: no CUDA card for device "
                           f"{str(dev)!r}; pass device='cpu' to build on "
                           "the CPU")
    return dev


def _index(v, dev) -> torch.Tensor:
    """A host index array as an int64 tensor on ``dev``."""
    return torch.from_numpy(np.asarray(v, dtype=np.int64).copy()).to(dev)


@dataclass(frozen=True, eq=False)
class COOMatrix:
    """Coordinate-format matrix (sorted by row, then column)."""

    values: torch.Tensor        # (nnz,) float
    row_indices: torch.Tensor   # (nnz,) int64
    col_indices: torch.Tensor   # (nnz,) int64
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def astype(self, dtype) -> "COOMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))


@dataclass(frozen=True, eq=False)
class CSRMatrix:
    """Compressed-sparse-row matrix with the expanded row id of every
    nonzero cached (``row_indices``), so the SpMV needs no search over
    ``indptr``."""

    values: torch.Tensor        # (nnz,) float
    col_indices: torch.Tensor   # (nnz,) int64
    indptr: torch.Tensor        # (n_rows + 1,) int64
    row_indices: torch.Tensor   # (nnz,) int64
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def astype(self, dtype) -> "CSRMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))

    @classmethod
    def from_arrays(cls, values, col_indices, indptr, shape,
                    device="cuda") -> "CSRMatrix":
        """Build from host arrays on ``device``; expands the row ids
        eagerly."""
        dev = resolve_device(device)
        indptr_np = np.asarray(indptr, dtype=np.int64)
        rows = np.repeat(np.arange(len(indptr_np) - 1, dtype=np.int64),
                         np.diff(indptr_np))
        return cls(values=torch.from_numpy(np.array(values,
                                                    copy=True)).to(dev),
                   col_indices=torch.from_numpy(
                       np.asarray(col_indices, dtype=np.int64).copy()
                   ).to(dev),
                   indptr=torch.from_numpy(indptr_np.copy()).to(dev),
                   row_indices=torch.from_numpy(rows).to(dev),
                   shape=(int(shape[0]), int(shape[1])))

    def diagonal(self) -> torch.Tensor:
        """Main diagonal as a dense vector (missing entries are 0)."""
        on_diag = self.row_indices == self.col_indices
        d = torch.zeros(self.shape[0], dtype=self.values.dtype,
                        device=self.values.device)
        return d.index_add_(0, self.row_indices[on_diag],
                            self.values[on_diag])

    def to_coo(self) -> COOMatrix:
        return COOMatrix(self.values, self.row_indices, self.col_indices,
                         self.shape)


@dataclass(frozen=True, eq=False)
class BSRMatrix:
    """Block-CSR matrix with dense ``(bs, bs)`` blocks; ``row_indices`` is
    the cached block-row id of every block.  ``shape`` is padded to a
    multiple of ``blocksize``."""

    values: torch.Tensor        # (nnzb, bs, bs) float
    col_indices: torch.Tensor   # (nnzb,) int64, block-column ids
    indptr: torch.Tensor        # (n_block_rows + 1,) int64
    row_indices: torch.Tensor   # (nnzb,) int64, block-row ids
    shape: Tuple[int, int]
    blocksize: int

    @property
    def nnzb(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def astype(self, dtype) -> "BSRMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))


@dataclass(frozen=True, eq=False)
class ELLMatrix:
    """Row-padded ELLPACK matrix: every row stores ``width`` (value,
    column) pairs; padding has value 0 and the row's own column, so the
    gathers stay in range."""

    values: torch.Tensor        # (n_rows, width) float
    col_indices: torch.Tensor   # (n_rows, width) int64
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def astype(self, dtype) -> "ELLMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))


@dataclass(frozen=True, eq=False)
class DIAMatrix:
    """Diagonal (banded) storage with static offsets.

    Row-aligned: ``data[k, i] = A[i, i + offsets[k]]``, zero where the
    column falls outside the matrix.  ``grid`` is the optional ``(nx, ny,
    nz)`` of an operator discretised on a grid; the kernels need it to
    decompose any banded set other than the exact 7-point one into grid
    taps (:func:`cgx_torch.kernels.fused_dia_cg.dia_engine_spec`).
    """

    data: torch.Tensor          # (n_diags, n_rows) float
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    grid: Optional[Tuple[int, int, int]] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def astype(self, dtype) -> "DIAMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def to(self, device) -> "DIAMatrix":
        return dataclasses.replace(self, data=self.data.to(device))

    def diagonal(self) -> torch.Tensor:
        return self.data[self.offsets.index(0)]


def csr_from_scipy(a, device="cuda") -> CSRMatrix:
    """Build a :class:`CSRMatrix` on ``device`` from a ``scipy.sparse``
    matrix."""
    a = a.tocsr()
    a.sort_indices()
    return CSRMatrix.from_arrays(a.data, a.indices, a.indptr, a.shape,
                                 device=device)


def coo_from_scipy(a, device="cuda") -> COOMatrix:
    """Build a :class:`COOMatrix` on ``device`` from a ``scipy.sparse``
    matrix, sorted by row, then column."""
    dev = resolve_device(device)
    a = a.tocoo()
    order = np.lexsort((a.col, a.row))
    return COOMatrix(values=torch.from_numpy(a.data[order].copy()).to(dev),
                     row_indices=_index(a.row[order], dev),
                     col_indices=_index(a.col[order], dev),
                     shape=(int(a.shape[0]), int(a.shape[1])))


def bsr_from_csr(a: CSRMatrix, blocksize: int) -> BSRMatrix:
    """Convert CSR → BSR on the host (scipy, sorted block indices), with
    n and m padded to a multiple of ``blocksize``; the result lands on the
    input's device."""
    import scipy.sparse as sp

    dev = a.values.device
    vals = a.values.detach().cpu().numpy()
    cols = a.col_indices.cpu().numpy()
    indptr = a.indptr.cpu().numpy()
    n, m = a.shape
    bs = int(blocksize)
    n_pad = (-n) % bs
    m_pad = (-m) % bs
    s = sp.csr_matrix((vals, cols, indptr), shape=(n, m))
    if n_pad or m_pad:
        s = sp.csr_matrix(
            sp.vstack([
                sp.hstack([s, sp.csr_matrix((n, m_pad), dtype=s.dtype)]),
                sp.csr_matrix((n_pad, m + m_pad), dtype=s.dtype),
            ]))
    b = sp.bsr_matrix(s, blocksize=(bs, bs))
    b.sort_indices()
    counts = np.diff(b.indptr).astype(np.int64)
    rows = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    return BSRMatrix(values=torch.from_numpy(np.ascontiguousarray(b.data))
                     .to(dev),
                     col_indices=_index(b.indices, dev),
                     indptr=_index(b.indptr, dev),
                     row_indices=torch.from_numpy(rows).to(dev),
                     shape=(n + n_pad, m + m_pad), blocksize=bs)


def ell_from_csr(a: CSRMatrix, width: Optional[int] = None,
                 width_multiple: int = 1, device="cuda") -> ELLMatrix:
    """Convert CSR → padded ELLPACK on the host, result on ``device``.

    ``width`` defaults to the longest row, rounded up to
    ``width_multiple``; padding gets value 0 and the row's own column.
    """
    dev = resolve_device(device)
    vals = a.values.detach().cpu().numpy()
    cols = a.col_indices.cpu().numpy()
    indptr = a.indptr.cpu().numpy()
    n = a.shape[0]
    counts = np.diff(indptr)
    natural = int(counts.max()) if n else 0
    w = natural if width is None else int(width)
    if w < natural:
        raise ValueError(f"ELL width {w} < max row length {natural}")
    w = max(1, -(-w // width_multiple) * width_multiple)
    ell_vals = np.zeros((n, w), dtype=vals.dtype)
    ell_cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, w))
    rows = np.repeat(np.arange(n), counts)
    offs = np.arange(len(vals)) - np.repeat(indptr[:-1], counts)
    ell_vals[rows, offs] = vals
    ell_cols[rows, offs] = cols
    return ELLMatrix(values=torch.from_numpy(ell_vals).to(dev),
                     col_indices=torch.from_numpy(ell_cols).to(dev),
                     shape=a.shape)


def dia_from_csr(a: CSRMatrix) -> DIAMatrix:
    """Convert CSR → row-aligned DIA on the host; the result lands on the
    input's device.

    Meant for matrices with few populated diagonals (stencils); raises if
    more than 64 distinct offsets are present.
    """
    vals = a.values.detach().cpu().numpy()
    cols = a.col_indices.cpu().numpy()
    rows = a.row_indices.cpu().numpy()
    n, m = a.shape
    if n != m:
        raise ValueError("DIA requires a square matrix")
    offs = cols - rows
    uniq = np.unique(offs)
    if len(uniq) > 64:
        raise ValueError(
            f"matrix has {len(uniq)} populated diagonals; DIA is meant for "
            "stencil-like operators (<= 64)")
    data = np.zeros((len(uniq), n), dtype=vals.dtype)
    data[np.searchsorted(uniq, offs), rows] = vals
    return DIAMatrix(data=torch.from_numpy(data).to(a.values.device),
                     offsets=tuple(int(o) for o in uniq), shape=(n, m))

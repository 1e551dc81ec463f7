"""Stored sparse formats (PyTorch): CSR and DIA.

Counterpart of :mod:`cgx.sparse.types` for the two formats the Jacobi-PCG
slice needs: :class:`CSRMatrix` (what a scipy matrix arrives as) and
:class:`DIAMatrix` (the variable-coefficient banded operators that the
whole-solve and two-pass kernels run).  COO, ELL and BSR are not ported
yet (ROADMAP queue A item 2).

The containers are frozen dataclasses holding tensors.  Index arrays are
``int64``, PyTorch's index type, where the JAX package keeps ``int32``.
The host conversions (:func:`csr_from_scipy`, :func:`dia_from_csr`) run
once at set-up in numpy, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["CSRMatrix", "DIAMatrix", "csr_from_scipy", "dia_from_csr"]


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
    def from_arrays(cls, values, col_indices, indptr, shape) -> "CSRMatrix":
        """Build from host arrays; expands the row ids eagerly."""
        indptr_np = np.asarray(indptr, dtype=np.int64)
        rows = np.repeat(np.arange(len(indptr_np) - 1, dtype=np.int64),
                         np.diff(indptr_np))
        return cls(values=torch.from_numpy(np.array(values, copy=True)),
                   col_indices=torch.from_numpy(
                       np.asarray(col_indices, dtype=np.int64).copy()),
                   indptr=torch.from_numpy(indptr_np.copy()),
                   row_indices=torch.from_numpy(rows),
                   shape=(int(shape[0]), int(shape[1])))

    def diagonal(self) -> torch.Tensor:
        """Main diagonal as a dense vector (missing entries are 0)."""
        on_diag = self.row_indices == self.col_indices
        d = torch.zeros(self.shape[0], dtype=self.values.dtype,
                        device=self.values.device)
        return d.index_add_(0, self.row_indices[on_diag],
                            self.values[on_diag])


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


def csr_from_scipy(a) -> CSRMatrix:
    """Build a :class:`CSRMatrix` from a ``scipy.sparse`` matrix."""
    a = a.tocsr()
    a.sort_indices()
    return CSRMatrix.from_arrays(a.data, a.indices, a.indptr, a.shape)


def dia_from_csr(a: CSRMatrix) -> DIAMatrix:
    """Convert CSR → row-aligned DIA on the host.

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
    return DIAMatrix(data=torch.from_numpy(data),
                     offsets=tuple(int(o) for o in uniq), shape=(n, m))

"""Poisson-type problems in CSR and DIA form (PyTorch).

Counterpart of :mod:`cgx.io.poisson`: the CSR builders (``poisson2d``,
``poisson3d`` and their host arrays) and the DIA builders
(``poisson2d_dia``, ``poisson3d_dia``, ``poisson3d_dia27``).  The data is
built with numpy exactly as the JAX package builds it, from the same
seed, so both packages hold bit-identical coefficients and index arrays;
the result is a :class:`~cgx_torch.sparse.types.CSRMatrix` or
:class:`~cgx_torch.sparse.types.DIAMatrix` on ``device``, the card unless
the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from cgx_torch.sparse.types import CSRMatrix, DIAMatrix, resolve_device

__all__ = ["poisson2d_csr_arrays", "poisson3d_csr_arrays", "poisson2d",
           "poisson3d", "poisson2d_dia", "poisson3d_dia", "poisson3d_dia27"]


def poisson2d_csr_arrays(nx: int, ny: int, dtype=np.float64):
    """5-point 2-D Laplacian (Dirichlet) as host CSR arrays ``(values,
    col_indices, indptr, n)``, node (i, j) → i·ny + j; diagonal 4,
    off-diagonals -1.  Indices are int32, as the JAX package builds them."""
    n = nx * ny
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    idx = (i * ny + j)

    rows, cols, vals = [], [], []

    def add(mask, r, c, v):
        rows.append(r[mask].ravel())
        cols.append(c[mask].ravel())
        vals.append(np.full(int(mask.sum()), v, dtype=dtype))

    full = np.ones((nx, ny), bool)
    add(full, idx, idx, 4.0)
    west = np.broadcast_to(j > 0, (nx, ny))
    add(west, np.broadcast_to(idx, (nx, ny)), idx - 1, -1.0)
    east = np.broadcast_to(j < ny - 1, (nx, ny))
    add(east, np.broadcast_to(idx, (nx, ny)), idx + 1, -1.0)
    north = np.broadcast_to(i > 0, (nx, ny))
    add(north, np.broadcast_to(idx, (nx, ny)), idx - ny, -1.0)
    south = np.broadcast_to(i < nx - 1, (nx, ny))
    add(south, np.broadcast_to(idx, (nx, ny)), idx + ny, -1.0)

    return _triplets_to_csr(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals), n)


def poisson3d_csr_arrays(nx: int, ny: int, nz: int, dtype=np.float64):
    """7-point 3-D Laplacian (Dirichlet) as host CSR arrays, node (i, j,
    k) → (i·ny + j)·nz + k; diagonal 6, off-diagonals -1."""
    n = nx * ny * nz
    i = np.arange(nx)[:, None, None]
    j = np.arange(ny)[None, :, None]
    k = np.arange(nz)[None, None, :]
    idx = (i * ny + j) * nz + k
    shape = (nx, ny, nz)

    rows, cols, vals = [], [], []

    def add(mask, c_off, v):
        m = np.broadcast_to(mask, shape)
        r = np.broadcast_to(idx, shape)
        rows.append(r[m].ravel())
        cols.append((r + c_off)[m].ravel())
        vals.append(np.full(int(m.sum()), v, dtype=dtype))

    add(np.ones(shape, bool), 0, 6.0)
    add(k > 0, -1, -1.0)
    add(k < nz - 1, +1, -1.0)
    add(j > 0, -nz, -1.0)
    add(j < ny - 1, +nz, -1.0)
    add(i > 0, -ny * nz, -1.0)
    add(i < nx - 1, +ny * nz, -1.0)

    return _triplets_to_csr(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals), n)


def _triplets_to_csr(rows, cols, vals, n):
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int64).astype(np.int32)
    return vals, cols.astype(np.int32), indptr, n


def poisson2d(nx: int, ny: int, dtype=np.float64, device="cuda") -> CSRMatrix:
    """2-D Poisson as a :class:`CSRMatrix` on ``device``."""
    vals, cols, indptr, n = poisson2d_csr_arrays(nx, ny, dtype)
    return CSRMatrix.from_arrays(vals, cols, indptr, (n, n), device=device)


def poisson3d(nx: int, ny: int, nz: int, dtype=np.float64,
              device="cuda") -> CSRMatrix:
    """3-D Poisson as a :class:`CSRMatrix` on ``device``."""
    vals, cols, indptr, n = poisson3d_csr_arrays(nx, ny, nz, dtype)
    return CSRMatrix.from_arrays(vals, cols, indptr, (n, n), device=device)


def poisson2d_dia(nx: int, ny: int, dtype=np.float64,
                  device="cuda") -> DIAMatrix:
    """2-D 5-point Laplacian (Dirichlet), node (i, j) → i·ny + j.  No
    ``grid`` is set, as in the JAX package; pass ``grid=(nx, 1, ny)`` to
    reach the kernels."""
    dev = resolve_device(device)
    n = nx * ny
    j = np.tile(np.arange(ny), nx)
    i = np.repeat(np.arange(nx), ny)
    data = np.zeros((5, n), dtype=dtype)
    data[0] = np.where(i > 0, -1.0, 0.0)          # A[r, r-ny]
    data[1] = np.where(j > 0, -1.0, 0.0)          # A[r, r-1]
    data[2] = 4.0                                  # A[r, r]
    data[3] = np.where(j < ny - 1, -1.0, 0.0)     # A[r, r+1]
    data[4] = np.where(i < nx - 1, -1.0, 0.0)     # A[r, r+ny]
    return DIAMatrix(data=torch.from_numpy(data).to(dev),
                     offsets=(-ny, -1, 0, 1, ny), shape=(n, n))


def poisson3d_dia(nx: int, ny: int, nz: int, dtype=np.float64,
                  device="cuda") -> DIAMatrix:
    """3-D 7-point Laplacian (Dirichlet), node (i, j, k) → (i·ny + j)·nz +
    k, with ``grid`` set."""
    dev = resolve_device(device)
    n = nx * ny * nz
    flat = np.arange(n)
    k = flat % nz
    j = (flat // nz) % ny
    i = flat // (ny * nz)
    data = np.zeros((7, n), dtype=dtype)
    data[0] = np.where(i > 0, -1.0, 0.0)
    data[1] = np.where(j > 0, -1.0, 0.0)
    data[2] = np.where(k > 0, -1.0, 0.0)
    data[3] = 6.0
    data[4] = np.where(k < nz - 1, -1.0, 0.0)
    data[5] = np.where(j < ny - 1, -1.0, 0.0)
    data[6] = np.where(i < nx - 1, -1.0, 0.0)
    return DIAMatrix(data=torch.from_numpy(data).to(dev),
                     offsets=(-ny * nz, -nz, -1, 0, 1, nz, ny * nz),
                     shape=(n, n), grid=(nx, ny, nz))


def poisson3d_dia27(nx: int, ny: int, nz: int, *, variable: bool = False,
                    seed: int = 0, dtype=np.float32,
                    device="cuda") -> DIAMatrix:
    """Wrap-free SPD 27-point banded operator in DIA form.

    ``variable=True`` draws each coupling from U[0.2, 1) (numpy, ``seed``);
    the diagonal is made strictly dominant, every grid-boundary-crossing
    slot is zero and the data is entrywise symmetric, so the kernels take
    it in their symmetric mode (13 planes and a unit diagonal after
    Jacobi scaling).
    """
    dev = resolve_device(device)
    n = nx * ny * nz
    flat = np.arange(n)
    k = flat % nz
    j = (flat // nz) % ny
    i = flat // (ny * nz)
    rng = np.random.default_rng(seed)
    # Positive-offset taps in lexicographic order; negatives mirrored.
    pos = [(dx, dy, dk) for dx in (0, 1) for dy in (-1, 0, 1)
           for dk in (-1, 0, 1) if (dx, dy, dk) > (0, 0, 0)]
    offs_pos = [dx * ny * nz + dy * nz + dk for (dx, dy, dk) in pos]
    offsets = sorted([-o for o in offs_pos] + [0] + offs_pos)
    data = np.zeros((len(offsets), n), dtype=dtype)
    row = {o: r for r, o in enumerate(offsets)}
    diag = np.full(n, 0.05, dtype=np.float64)
    for (dx, dy, dk), off in zip(pos, offs_pos):
        ok = ((k + dk >= 0) & (k + dk < nz) & (j + dy >= 0)
              & (j + dy < ny) & (i + dx < nx))
        mag = rng.uniform(0.2, 1.0, n) if variable else 1.0
        v = np.where(ok, -mag, 0.0)
        data[row[off]] = v
        data[row[-off]][off:] = v[:-off]          # symmetric mirror
        diag += np.abs(v)
        diag[off:] += np.abs(v[:-off])
    data[row[0]] = diag.astype(dtype)
    return DIAMatrix(data=torch.from_numpy(data).to(dev),
                     offsets=tuple(offsets),
                     shape=(n, n), grid=(nx, ny, nz))

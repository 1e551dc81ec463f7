"""Matrix-free constant-coefficient stencil operators (PyTorch).

Counterpart of :mod:`cgx.sparse.stencil`.  The operators store nothing but
the grid shape and the coefficients: the matrix action is a handful of
shifted multiply-adds with zero fill at the Dirichlet boundary, so an SpMV
reads x and writes y (about 8 bytes per row in fp32).

The classes are frozen dataclasses that hold no tensors.  ``matvec`` is the
plain PyTorch version on any device.  The JAX package's ``matvec_padded``
and its ``backend``/``with_backend`` switch are not ported: they choose
between XLA and Pallas, and the port has one path per device.
:func:`cgx_torch.ops.spmv.spmv` sends a ``Stencil3D`` on a CUDA tensor
through the hand-written kernel (:mod:`cgx_torch.kernels.stencil`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["Stencil2D", "Stencil3D", "GeneralStencil3D", "poisson2d_stencil",
           "poisson3d_stencil", "poisson3d_27point"]


def _shift(g: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """``out[..i..] = g[..i+off..]`` along ``axis`` with zero fill."""
    if off == 0:
        return g
    out = torch.zeros_like(g)
    n = g.shape[axis]
    if abs(off) >= n:
        return out
    if off > 0:
        out.narrow(axis, 0, n - off).copy_(g.narrow(axis, off, n - off))
    else:
        out.narrow(axis, -off, n + off).copy_(g.narrow(axis, 0, n + off))
    return out


@dataclass(frozen=True)
class Stencil2D:
    """5-point constant stencil on an ``nx × ny`` grid (Dirichlet).

    ``A[r, r] = c_center``; ``A[r, r±1] = c_y`` (within a grid row);
    ``A[r, r±ny] = c_x``.  Row-major numbering: node (i, j) → i·ny + j.
    """

    nx: int
    ny: int
    c_center: float
    c_x: float
    c_y: float
    dtype_name: str = "float32"

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.nx * self.ny
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    def diagonal(self, device=None) -> torch.Tensor:
        return torch.full((self.nx * self.ny,), self.c_center,
                          dtype=self.dtype, device=device)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(self.nx, self.ny)
        y = self.c_center * g
        y = y + self.c_y * _shift(g, 1, +1) + self.c_y * _shift(g, 1, -1)
        y = y + self.c_x * _shift(g, 0, +1) + self.c_x * _shift(g, 0, -1)
        return y.reshape(-1)


@dataclass(frozen=True)
class Stencil3D:
    """7-point constant stencil on an ``nx × ny × nz`` grid (Dirichlet).

    Node (i, j, k) → (i·ny + j)·nz + k; couplings ``c_x/c_y/c_z`` along the
    three axes, ``c_center`` on the diagonal.
    """

    nx: int
    ny: int
    nz: int
    c_center: float
    c_x: float
    c_y: float
    c_z: float
    dtype_name: str = "float32"

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.nx * self.ny * self.nz
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    def diagonal(self, device=None) -> torch.Tensor:
        return torch.full((self.nx * self.ny * self.nz,), self.c_center,
                          dtype=self.dtype, device=device)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(self.nx, self.ny, self.nz)
        y = self.c_center * g
        y = y + self.c_z * _shift(g, 2, +1) + self.c_z * _shift(g, 2, -1)
        y = y + self.c_y * _shift(g, 1, +1) + self.c_y * _shift(g, 1, -1)
        y = y + self.c_x * _shift(g, 0, +1) + self.c_x * _shift(g, 0, -1)
        return y.reshape(-1)


@dataclass(frozen=True)
class GeneralStencil3D:
    """Arbitrary constant-coefficient stencil on an ``nx × ny × nz`` grid
    (Dirichlet): ``A[(i,j,k), (i+dx, j+dy, k+dz)] = coeffs[t]`` for each tap
    ``taps[t] = (dx, dy, dz)``.  Covers 27-point (and any fixed-offset)
    patterns the 7-point :class:`Stencil3D` cannot express.
    """

    nx: int
    ny: int
    nz: int
    taps: Tuple[Tuple[int, int, int], ...]
    coeffs: Tuple[float, ...]
    dtype_name: str = "float32"

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.nx * self.ny * self.nz
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    def diagonal(self, device=None) -> torch.Tensor:
        c0 = 0.0
        for t, tap in enumerate(self.taps):
            if tuple(tap) == (0, 0, 0):
                c0 = self.coeffs[t]
        return torch.full((self.nx * self.ny * self.nz,), c0,
                          dtype=self.dtype, device=device)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(self.nx, self.ny, self.nz)
        y = torch.zeros_like(g)
        for (dx, dy, dz), c in zip(self.taps, self.coeffs):
            s = _shift(_shift(_shift(g, 0, dx), 1, dy), 2, dz)
            y = y + c * s
        return y.reshape(-1)


def poisson3d_27point(nx: int, ny: int, nz: int) -> GeneralStencil3D:
    """27-point Laplacian-type operator: neighbour weights −2/−1/−½ by
    face/edge/corner adjacency, center 28."""
    taps = []
    coeffs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nnz_axes = (dx != 0) + (dy != 0) + (dz != 0)
                taps.append((dx, dy, dz))
                coeffs.append(28.0 if nnz_axes == 0
                              else -float(2 ** (3 - nnz_axes) / 2))
    return GeneralStencil3D(nx=nx, ny=ny, nz=nz, taps=tuple(taps),
                            coeffs=tuple(coeffs))


def poisson2d_stencil(nx: int, ny: int) -> Stencil2D:
    """Matrix-free 2D 5-point Laplacian."""
    return Stencil2D(nx=nx, ny=ny, c_center=4.0, c_x=-1.0, c_y=-1.0)


def poisson3d_stencil(nx: int, ny: int, nz: int) -> Stencil3D:
    """Matrix-free 3D 7-point Laplacian."""
    return Stencil3D(nx=nx, ny=ny, nz=nz, c_center=6.0, c_x=-1.0, c_y=-1.0,
                     c_z=-1.0)

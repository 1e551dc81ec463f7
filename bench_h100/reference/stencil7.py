"""The constant 7-point stencil, rebuilt from the configuration alone."""
from __future__ import annotations

import torch


def operator(data: dict):
    """``(matvec, diagonal)`` of ``data`` (``grid``, ``center``,
    ``coupling``): ``y = center·x + coupling·Σ neighbours`` on the grid,
    Dirichlet (no neighbour past the edge).  ``matvec`` takes ``(n, k)``."""
    nx, ny, nz = data["grid"]
    c0, c1 = float(data["center"]), float(data["coupling"])

    def matvec(x: torch.Tensor) -> torch.Tensor:
        k = x.shape[1]
        g = x.reshape(nx, ny, nz, k)
        y = c0 * g
        y[1:] += c1 * g[:-1]
        y[:-1] += c1 * g[1:]
        y[:, 1:] += c1 * g[:, :-1]
        y[:, :-1] += c1 * g[:, 1:]
        y[:, :, 1:] += c1 * g[:, :, :-1]
        y[:, :, :-1] += c1 * g[:, :, 1:]
        return y.reshape(-1, k)

    return matvec, None

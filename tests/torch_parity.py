"""Shared helpers for the cgx_torch parity tests (not collected itself).

The same inputs, made with numpy from a fixed seed, go through the JAX
package and the port; both sides meet as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

# The suite runs under several xdist workers: keep each one's torch small.
torch.set_num_threads(2)


def seeded(n: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def t(v: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(v, copy=True)).to(device)


def n_(v) -> np.ndarray:
    """numpy copy of a torch tensor or a JAX array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def scaled_dia_data(nx: int, ny: int, nz: int, seed: int = 0):
    """Variable-coefficient SPD 7-point operator D·A·D (A the 3-D Poisson
    matrix, D ~ U[0.5, 2) from ``seed``) as fp64 numpy ``(data, offsets,
    shape)``, built as the JAX package's tests build it."""
    from cgx_torch.io.poisson import poisson3d_dia

    a = poisson3d_dia(nx, ny, nz, device="cpu")
    n = a.shape[0]
    d = np.random.default_rng(seed).uniform(0.5, 2.0, n)
    data = a.data.numpy().copy()
    for k, off in enumerate(a.offsets):
        tgt = np.arange(n) + off
        ok = (tgt >= 0) & (tgt < n)
        data[k, ok] *= d[ok] * d[tgt[ok]]
    return data, a.offsets, a.shape


def wide_reach_dia(nx: int, ny: int, nz: int, reach: int, seed: int = 0):
    """An SPD operator whose taps reach ``reach`` lines in y: D·A·D with A
    the 3-D Poisson matrix plus −½ between nodes ``reach`` lines apart (its
    diagonal 7, zero where the partner leaves the grid) and D ~ U[0.5, 2)
    from ``seed``, as a :class:`cgx_torch.DIAMatrix` on the CPU with its
    grid."""
    import cgx_torch
    from cgx_torch.io.poisson import poisson3d_dia

    a = poisson3d_dia(nx, ny, nz, device="cpu")
    n = a.shape[0]
    offs = tuple(a.offsets) + (reach * nz, -reach * nz)
    data = np.zeros((len(offs), n))
    data[:len(a.offsets)] = a.data.numpy()
    data[offs.index(0)] += 1.0
    j = (np.arange(n) // nz) % ny
    data[-2][j + reach < ny] = -0.5
    data[-1][j - reach >= 0] = -0.5
    d = np.random.default_rng(seed).uniform(0.5, 2.0, n)
    for k, off in enumerate(offs):
        tgt = np.arange(n) + off
        ok = (tgt >= 0) & (tgt < n)
        data[k, ok] *= d[ok] * d[tgt[ok]]
    return cgx_torch.DIAMatrix(data=torch.from_numpy(data.astype(np.float32)),
                               offsets=offs, shape=a.shape,
                               grid=(nx, ny, nz))


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: the port's kernels run only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda", 0)

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


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: the port's kernels run only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda", 0)

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


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: the port's kernels run only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda", 0)

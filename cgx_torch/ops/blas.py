"""Dense vector ops: dots, norms, axpy (PyTorch).

Counterpart of :mod:`cgx.ops.blas`.  Reductions are single-device for now:
the JAX package's ``axis_name`` (a global ``psum`` under ``shard_map``)
becomes a process group when distribution is ported.  Results stay on the
input's device as 0-d tensors; nothing here synchronises with the host.
"""
from __future__ import annotations

import torch

__all__ = ["dot", "dot_compensated", "norm_sq", "norm", "axpy",
           "safe_recip"]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product ``aᵀb``."""
    if a.shape != b.shape:
        raise ValueError(f"dot: shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return torch.dot(a.reshape(-1), b.reshape(-1))


def dot_compensated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product with fp32 products + Kahan-compensated chunked sum.

    Products are upcast to fp32; 256 lanes of partial sums each carry a
    running compensation term (2Sum), then the survivors are summed.
    About 1 ulp fp32 accuracy independent of n.  Returns fp32.
    """
    if a.shape != b.shape:
        raise ValueError(f"dot: shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    prod = a.reshape(-1).to(torch.float32) * b.reshape(-1).to(torch.float32)
    c_lanes = 256
    pad = (-prod.shape[0]) % c_lanes
    g = torch.nn.functional.pad(prod, (0, pad)).reshape(-1, c_lanes)
    s = torch.zeros(c_lanes, dtype=torch.float32, device=prod.device)
    comp = torch.zeros_like(s)
    for row in g:
        y = row - comp
        t = s + y
        comp = (t - s) - y
        s = t
    return torch.sum(s - comp)


def norm_sq(a: torch.Tensor) -> torch.Tensor:
    """Squared 2-norm ``‖a‖²``."""
    return dot(a, a)


def norm(a: torch.Tensor) -> torch.Tensor:
    """2-norm ``‖a‖``."""
    return torch.sqrt(norm_sq(a))


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``alpha * x + y``."""
    return alpha * x + y


def safe_recip(d: torch.Tensor) -> torch.Tensor:
    """Elementwise ``1/d`` with zeros mapped to zero (not inf): the shared
    zero-diagonal policy for Jacobi-type preconditioners."""
    nz = d != 0
    return torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.zeros_like(d))

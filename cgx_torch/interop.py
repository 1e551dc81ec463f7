"""Carry operators, vectors and results between cgx and cgx_torch.

Everything crosses as numpy arrays or plain fields, so this module imports
neither JAX nor ``cgx``: a ``cgx`` operator is read by its fields.
"""
from __future__ import annotations

import numpy as np
import torch

from cgx_torch.solve.cg import CGResult
from cgx_torch.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D

__all__ = ["operator_from_cgx", "tensor_from_numpy", "result_to_numpy"]


def operator_from_cgx(a):
    """The port's operator for a ``cgx`` ``Stencil2D``/``Stencil3D``/
    ``GeneralStencil3D`` (duck-typed by class name and fields)."""
    kind = type(a).__name__
    dtype_name = str(getattr(a, "dtype_name", "float32"))
    if kind == "Stencil3D":
        return Stencil3D(nx=int(a.nx), ny=int(a.ny), nz=int(a.nz),
                         c_center=float(a.c_center), c_x=float(a.c_x),
                         c_y=float(a.c_y), c_z=float(a.c_z),
                         dtype_name=dtype_name)
    if kind == "Stencil2D":
        return Stencil2D(nx=int(a.nx), ny=int(a.ny),
                         c_center=float(a.c_center), c_x=float(a.c_x),
                         c_y=float(a.c_y), dtype_name=dtype_name)
    if kind == "GeneralStencil3D":
        return GeneralStencil3D(
            nx=int(a.nx), ny=int(a.ny), nz=int(a.nz),
            taps=tuple(tuple(int(d) for d in t) for t in a.taps),
            coeffs=tuple(float(c) for c in a.coeffs),
            dtype_name=dtype_name)
    raise TypeError(f"operator_from_cgx: unsupported operator {kind!r}")


def tensor_from_numpy(v, device="cpu") -> torch.Tensor:
    """A copy of an array (numpy, or anything ``np.asarray`` takes, such as
    a JAX array) as a tensor on ``device``."""
    return torch.from_numpy(np.array(v, copy=True)).to(device)


def result_to_numpy(res: CGResult) -> dict:
    """A :class:`CGResult`'s fields as numpy arrays."""
    return {
        "x": res.x.detach().cpu().numpy(),
        "iterations": int(res.iterations),
        "residual_norm_sq": res.residual_norm_sq.detach().cpu().numpy(),
        "converged": bool(res.converged),
        "history": res.history.detach().cpu().numpy(),
    }

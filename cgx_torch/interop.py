"""Carry operators, preconditioners, vectors and results between cgx and
cgx_torch.

Everything crosses as numpy arrays or plain fields, so this module imports
neither JAX nor ``cgx``: a ``cgx`` object is read by its class name and
fields.  The coefficient data of a ``DIAMatrix`` or ``CSRMatrix`` and the
``inv_diag`` of a ``JacobiPrecond`` are copied, so both packages solve the
same system from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from cgx_torch.solve.cg import CGResult
from cgx_torch.solve.precond import JacobiPrecond
from cgx_torch.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D
from cgx_torch.sparse.types import CSRMatrix, DIAMatrix

__all__ = ["operator_from_cgx", "precond_from_cgx", "tensor_from_numpy",
           "result_to_numpy"]


def operator_from_cgx(a):
    """The port's operator for a ``cgx`` ``Stencil2D``/``Stencil3D``/
    ``GeneralStencil3D``/``DIAMatrix``/``CSRMatrix`` (duck-typed by class
    name and fields; a port operator is read the same way).  Stored data
    lands on the CPU."""
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
    if kind == "DIAMatrix":
        grid = getattr(a, "grid", None)
        return DIAMatrix(data=tensor_from_numpy(a.data),
                         offsets=tuple(int(o) for o in a.offsets),
                         shape=(int(a.shape[0]), int(a.shape[1])),
                         grid=None if grid is None
                         else tuple(int(g) for g in grid))
    if kind == "CSRMatrix":
        return CSRMatrix.from_arrays(_numpy(a.values), _numpy(a.col_indices),
                                     _numpy(a.indptr), a.shape)
    raise TypeError(f"operator_from_cgx: unsupported operator {kind!r}")


def precond_from_cgx(m) -> JacobiPrecond:
    """The port's preconditioner for a ``cgx`` ``JacobiPrecond`` (its
    ``inv_diag`` copied to the CPU)."""
    kind = type(m).__name__
    if kind != "JacobiPrecond":
        raise TypeError(f"precond_from_cgx: unsupported preconditioner "
                        f"{kind!r}")
    return JacobiPrecond(inv_diag=tensor_from_numpy(m.inv_diag))


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def tensor_from_numpy(v, device="cpu") -> torch.Tensor:
    """A copy of an array (numpy, a tensor, or anything ``np.asarray``
    takes, such as a JAX array) as a tensor on ``device``."""
    return torch.from_numpy(np.array(_numpy(v), copy=True)).to(device)


def result_to_numpy(res: CGResult) -> dict:
    """A :class:`CGResult`'s fields as numpy arrays."""
    return {
        "x": res.x.detach().cpu().numpy(),
        "iterations": int(res.iterations),
        "residual_norm_sq": res.residual_norm_sq.detach().cpu().numpy(),
        "converged": bool(res.converged),
        "history": res.history.detach().cpu().numpy(),
    }

"""Solver auto-selection (PyTorch).

Counterpart of :mod:`cgx.solve.auto`, for a single right-hand side over
the matrix-free stencils.  The backend names stay those of the JAX
package, so callers and checkpoint files keep working:

* on CUDA, a stencil the whole-solve kernel supports, with no
  preconditioner and at least ``RESIDENT_MIN_ROWS`` rows, routes to
  ``"resident_stencil"`` (:mod:`cgx_torch.kernels.fused_resident`);
* everything else routes to ``"xla"``, which here means the port's own
  :func:`~cgx_torch.solve.cg.cg_solve` loop.  Where the JAX package would
  return ``"padded"`` (a workaround for XLA's tile padding, not ported)
  the port returns ``"xla"``; ``backend="padded"`` is accepted as an alias.

Backends not ported yet raise ``NotImplementedError``; nothing is
re-routed quietly.
"""
from __future__ import annotations

from typing import Optional

import torch

from cgx_torch.kernels.fused_resident import (resident_stencil_cg,
                                              resident_supported)
from cgx_torch.solve.cg import CGResult, cg_solve

__all__ = ["auto_solve", "select_backend", "RESIDENT_MIN_ROWS",
           "FUSED_MIN_ROWS"]

# Carried over from the JAX package, where both were measured on a TPU
# v5e; neither has been measured on the H100 yet.
RESIDENT_MIN_ROWS = 200_000
FUSED_MIN_ROWS = 3_000_000

# Backends of the JAX package that the port does not have yet, with the
# ROADMAP queue-A item that brings each.
_NOT_PORTED = {
    "resident_dia": "ROADMAP queue A item 8 (DIA prep) and K2's planes mode",
    "sr_stencil": "ROADMAP kernel K4",
    "sr_dia": "ROADMAP kernel K4",
    "fused_stencil": "ROADMAP queue A item 8 (kernel K3)",
    "fused_dia": "ROADMAP queue A item 8 (kernel K3)",
    "wbell": "ROADMAP queue A item 10 (kernels K7/K8)",
}


def select_backend(a, b: torch.Tensor, preconditioner=None) -> str:
    """The backend :func:`auto_solve` would route this problem to:
    ``"resident_stencil"`` or ``"xla"``.  The device is ``b.device``."""
    if (b.device.type == "cuda" and preconditioner is None
            and b.shape[0] >= RESIDENT_MIN_ROWS
            and resident_supported(a, b.dtype)):
        return "resident_stencil"
    return "xla"


def auto_solve(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    track_history: bool = False,
    backend: Optional[str] = None,
    mixed_precision: bool = False,
) -> CGResult:
    """:func:`~cgx_torch.solve.cg.cg_solve` semantics with backend
    auto-selection.  ``backend`` overrides the routing."""
    if b.dim() == 2:
        raise NotImplementedError(
            "auto_solve: multi-RHS (2-D b) is not ported yet "
            "(ROADMAP queue A item 8, cg_solve_multi)")
    if mixed_precision:
        raise NotImplementedError(
            "auto_solve: mixed_precision is not ported yet "
            "(ROADMAP queue A item 11, ir_cg_solve)")
    if backend is None:
        backend = select_backend(a, b, preconditioner)
    n = b.shape[0]
    if backend == "resident_stencil" and track_history:
        # The whole-solve kernel keeps no per-iteration history; the JAX
        # package falls back to the two-pass engine (large n) or the loop.
        backend = "fused_stencil" if n >= FUSED_MIN_ROWS else "xla"
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"auto_solve: backend {backend!r} is not ported yet "
            f"({_NOT_PORTED[backend]})")
    if backend == "resident_stencil":
        if preconditioner is not None:
            raise ValueError("resident_stencil: preconditioner must be None")
        mi = int(maxiter) if maxiter is not None else n
        return resident_stencil_cg(a, b, x0, tol=tol, atol=atol, maxiter=mi)
    if backend not in ("xla", "padded"):
        raise ValueError(f"unknown backend {backend!r}")
    return cg_solve(a, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                    preconditioner=preconditioner,
                    track_history=track_history)

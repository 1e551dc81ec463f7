"""Conjugate-gradient solver (PyTorch).

Counterpart of :mod:`cgx.solve.cg`: the same textbook Hestenes–Stiefel
(P)CG recurrence with the ``rᵀr`` reuse, the same convergence test
(``‖r‖² ≤ max(tol²·‖b‖², atol²)``, capped at ``maxiter``) and the same
state.  ``tol=0`` with ``atol=0`` keeps the reference's fixed-count
trajectory (the C program runs ``max_iter + 1`` updates, so pass
``maxiter=max_iter + 1``).

The JAX package runs the loop as one ``lax.while_loop`` on the device.
Here it is a Python ``while`` over the same ``cond``/``body``: each test of
``cond`` reads one boolean back from the device.  The whole-solve CUDA
kernel (:mod:`cgx_torch.kernels.fused_resident`) is the path that keeps
the loop on the device.  ``cg_solve_single_reduction`` and
``cg_solve_pipelined`` are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional, Union

import torch

from cgx_torch.ops import blas
from cgx_torch.ops.spmv import spmv

__all__ = ["CGResult", "CGState", "cg_solve", "cg_init", "cg_chunk",
           "as_matvec"]

MatVec = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class CGResult:
    """Solver output; every field is a tensor on the solve's device."""

    x: torch.Tensor                 # solution iterate
    iterations: torch.Tensor        # int32 — CG iterations performed
    residual_norm_sq: torch.Tensor  # ‖r‖² of the recurrence at exit
    converged: torch.Tensor         # bool — hit the tolerance before maxiter
    # ‖r_k‖² for k = 0..maxiter (padded with the last value after exit);
    # only populated when track_history=True, else a size-0 tensor.
    history: torch.Tensor = field(default_factory=lambda: torch.zeros(0))

    @property
    def residual_norm(self) -> torch.Tensor:
        return torch.sqrt(self.residual_norm_sq)


@dataclass(frozen=True)
class CGState:
    """Full solver state — O(n) and sufficient to resume a solve exactly
    through :func:`cg_chunk`."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor
    k: torch.Tensor
    history: torch.Tensor


def as_matvec(a: Union[MatVec, object]) -> MatVec:
    """Normalise an operator or a callable into a matvec closure."""
    if callable(a):
        return a
    return partial(spmv, a)


def _as_apply(preconditioner):
    if preconditioner is None:
        return None
    if hasattr(preconditioner, "apply"):
        return preconditioner.apply
    return preconditioner


def _tol_sq(tol: float, atol: float, b: torch.Tensor) -> torch.Tensor:
    bb = blas.norm_sq(b)
    t = torch.tensor(tol, dtype=b.dtype, device=b.device)
    at = torch.tensor(atol, dtype=b.dtype, device=b.device)
    return torch.maximum(t ** 2 * bb, at ** 2)


def cg_solve(
    a: Union[MatVec, object],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    track_history: bool = False,
) -> CGResult:
    """Solve ``A x = b`` for SPD ``A`` by (preconditioned) CG.

    Args:
      a: a cgx_torch operator or a matvec callable.
      b: right-hand side (1-D).
      x0: initial iterate; defaults to zeros.
      tol: relative tolerance — exit when ``‖r‖² ≤ tol²·‖b‖²``.  ``tol=0``
        with ``atol=0`` gives fixed-iteration behaviour (reference parity).
      atol: absolute tolerance floor on ``‖r‖``.
      maxiter: iteration cap (defaults to the problem size).
      preconditioner: ``None`` | matvec callable | object with ``.apply``.
      track_history: record ``‖r_k‖²`` per iteration into
        ``CGResult.history`` (length ``maxiter + 1``).
    """
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    maxiter = int(b.shape[0] if maxiter is None else maxiter)
    state = cg_init(matvec, b, x0, preconditioner=apply_m,
                    history_len=maxiter + 1 if track_history else 0)
    tol_sq = _tol_sq(tol, atol, b)
    cond, body = _make_cond_body(matvec, apply_m, maxiter, tol_sq,
                                 track_history)
    while cond(state):
        state = body(state)

    history = state.history
    if track_history:
        # Pad post-exit slots with the final residual so plots stay flat.
        idx = torch.arange(maxiter + 1, device=b.device)
        history = torch.where(idx <= state.k, history, state.rr)
    return CGResult(x=state.x, iterations=state.k,
                    residual_norm_sq=state.rr,
                    converged=state.rr <= tol_sq, history=history)


def cg_init(a, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
            preconditioner=None, history_len: int = 0) -> CGState:
    """Initial :class:`CGState` for ``A x = b`` (x₀ defaults to zeros)."""
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    z0 = apply_m(r0) if apply_m is not None else r0
    rz0 = blas.dot(r0, z0)
    rr0 = blas.dot(r0, r0) if apply_m is not None else rz0
    hist0 = torch.zeros(history_len, dtype=b.dtype, device=b.device)
    if history_len:
        hist0[0] = rr0
    return CGState(x=x0, r=r0, z=z0, p=z0, rz=rz0, rr=rr0,
                   k=torch.zeros((), dtype=torch.int32, device=b.device),
                   history=hist0)


def _make_cond_body(matvec, apply_m, maxiter, tol_sq, track_history):
    def cond(s: CGState) -> bool:
        return bool((s.k < maxiter) & (s.rr > tol_sq))

    def body(s: CGState) -> CGState:
        q = matvec(s.p)
        pq = blas.dot(s.p, q)
        alpha = s.rz / pq
        x = s.x + alpha * s.p
        r = s.r - alpha * q
        z = apply_m(r) if apply_m is not None else r
        rz = blas.dot(r, z)
        rr = blas.dot(r, r) if apply_m is not None else rz
        beta = rz / s.rz
        p = z + beta * s.p
        hist = s.history
        if track_history:
            # Saturate at the last slot (cg_chunk may run past the buffer).
            idx = torch.clamp(s.k + 1, max=hist.shape[0] - 1).long()
            hist = hist.index_put((idx.reshape(1),), rr.reshape(1))
        return CGState(x=x, r=r, z=z, p=p, rz=rz, rr=rr, k=s.k + 1,
                       history=hist)

    return cond, body


def cg_chunk(a, state: CGState, iters: int, *,
             b: Optional[torch.Tensor] = None, tol: float = 0.0,
             atol: float = 0.0, preconditioner=None) -> CGState:
    """Advance a :class:`CGState` by up to ``iters`` CG iterations.

    Run a chunk, keep the returned state, repeat: the trajectory is the
    one of an uninterrupted :func:`cg_solve`.  Pass ``b`` with a nonzero
    ``tol`` to stop early inside the chunk.
    """
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    if b is not None:
        tol_sq = _tol_sq(tol, atol, b)
    else:
        tol_sq = torch.tensor(atol, dtype=state.r.dtype,
                              device=state.r.device) ** 2
    upto = state.k + iters
    track = state.history.shape[0] > 0
    _, body = _make_cond_body(matvec, apply_m, 0, tol_sq, track)
    while bool((state.k < upto) & (state.rr > tol_sq)):
        state = body(state)
    return state

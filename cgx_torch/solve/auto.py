"""Solver auto-selection (PyTorch).

Counterpart of :mod:`cgx.solve.auto` over the matrix-free stencils and
the stored formats.  The backend names stay
those of the JAX package, so callers and checkpoint files keep working.
A 2-D ``b`` (``(n, k)``) goes to
:func:`~cgx_torch.solve.block.cg_solve_multi`, which routes itself (K5,
K3 per column, or the batched loop), except over a ``WBELLMatrix``.
``on_tpu`` reads as "``b`` is a CUDA tensor":

* a stencil the whole-solve kernel supports, with no preconditioner, or a
  wrap-free DIA operator the engines take, with no preconditioner or a
  :class:`~cgx_torch.solve.precond.JacobiPrecond`, at least
  ``RESIDENT_MIN_ROWS`` rows, routes to ``"resident_stencil"`` or
  ``"resident_dia"`` (kernel K2, :mod:`cgx_torch.kernels.fused_resident`);
* a :class:`~cgx_torch.sparse.wbell.WBELLMatrix` routes to ``"wbell"``
  on any device: the solve runs in its internal layout over K7
  (:func:`~cgx_torch.solve.wbell.wbell_cg_solve`), and a 2-D ``b`` goes to
  :func:`~cgx_torch.solve.wbell.wbell_cg_solve_multi` (K8);
* everything else (CSR, COO, BSR, ELL, and what the kernels do not take)
  routes to ``"xla"``, which here means the port's own
  :func:`~cgx_torch.solve.cg.cg_solve` loop over
  :func:`~cgx_torch.ops.spmv.spmv` (a 2-D ``b``: the batched loop over
  ``spmm``).  Where the JAX package would
  return ``"padded"`` (a workaround for XLA's tile padding, not ported)
  the port returns ``"xla"``; ``backend="padded"`` is accepted as an alias.

K2 has no VMEM cap on the card, so the ``resident_*`` routes cover every
size and :func:`select_backend` never returns ``"fused_*"`` (nor the
semi-resident ``"sr_*"``).  The two-pass engine (kernel K3) is reached
with ``track_history=True`` — the whole-solve kernel keeps no history, so
a ``resident_*`` or ``sr_*`` route with at least ``FUSED_MIN_ROWS`` rows
goes to ``"fused_stencil"``/``"fused_dia"`` (fewer rows: the loop), as in
the JAX package — or by naming the backend.

``mixed_precision=True`` takes :func:`~cgx_torch.solve.ir.ir_cg_solve`
where the JAX package does: no history, at least ``FUSED_MIN_ROWS`` rows
and a fused, semi-resident or resident route.  A DIA operator whose
:func:`~cgx_torch.kernels.fused_dia_cg.bf16_plane_speedup` is at least
1.15 runs the inner solves with bf16 planes and fp32 vectors, anything
else with bf16 vectors.  Otherwise the solve routes as without it.

Backends not ported yet raise ``NotImplementedError``; nothing is
re-routed quietly.
"""
from __future__ import annotations

from typing import Optional

import torch

from cgx_torch.kernels import fused_cg
from cgx_torch.kernels.fused_cg import fused_stencil_cg
from cgx_torch.kernels.fused_dia_cg import (bf16_plane_speedup,
                                            fused_dia_cg, supports_dia,
                                            wrap_entries_zero_or_none)
from cgx_torch.kernels.fused_resident import (resident_dia_cg,
                                              resident_stencil_cg,
                                              resident_supported)
from cgx_torch.solve.block import FUSED_MIN_ROWS, cg_solve_multi
from cgx_torch.solve.cg import CGResult, cg_solve
from cgx_torch.solve.ir import ir_cg_solve
from cgx_torch.solve.precond import JacobiPrecond, PolynomialPrecond
from cgx_torch.solve.wbell import (WBellBlockJacobiPrecond, wbell_cg_solve,
                                   wbell_cg_solve_multi)
from cgx_torch.sparse.types import DIAMatrix
from cgx_torch.sparse.wbell import WBELLMatrix

__all__ = ["auto_solve", "select_backend", "RESIDENT_MIN_ROWS",
           "FUSED_MIN_ROWS"]

# Carried over from the JAX package, where it was measured on a TPU v5e;
# not measured on the H100 yet.  FUSED_MIN_ROWS is defined in
# cgx_torch.solve.block, whose multi-RHS routes read it too.
RESIDENT_MIN_ROWS = 200_000
# The mixed-precision mode cut on bf16_plane_speedup's prediction: the JAX
# package's, from the TPU's footprint model; not measured on the H100.
BF16_PLANE_MIN_SPEEDUP = 1.15

# The routes on which mixed_precision=True takes ir_cg_solve.
_IR_ROUTES = ("fused_stencil", "fused_dia", "sr_stencil", "sr_dia",
              "resident_stencil", "resident_dia")

# Backends of the JAX package that the port does not have yet, with the
# ROADMAP item that brings each.
_NOT_PORTED = {
    "sr_stencil": "ROADMAP kernel K4",
    "sr_dia": "ROADMAP kernel K4",
}


def select_backend(a, b: torch.Tensor, preconditioner=None) -> str:
    """The backend :func:`auto_solve` would route this problem to:
    ``"wbell"``, ``"resident_stencil"``, ``"resident_dia"`` or ``"xla"``.
    The device is ``b.device``; the DIA checks run on the data's device."""
    if isinstance(a, WBELLMatrix):
        return "wbell"
    n = b.shape[0]
    on_cuda = b.device.type == "cuda"
    jac = isinstance(preconditioner, JacobiPrecond)
    stencil_ok = (on_cuda and preconditioner is None
                  and fused_cg.supports(a))
    # The DIA route also needs zero entries at every x-plane-crossing
    # slot (fused_dia_cg.wrap_entries_zero); the check reads the data.
    dia_ok = (on_cuda and (preconditioner is None or jac)
              and n >= RESIDENT_MIN_ROWS and b.dtype == torch.float32
              and supports_dia(a) and wrap_entries_zero_or_none(a) is True)
    if (stencil_ok or dia_ok) and n >= RESIDENT_MIN_ROWS \
            and resident_supported(a, b.dtype):
        return "resident_stencil" if stencil_ok else "resident_dia"
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
    auto-selection.  ``backend`` overrides the routing.

    Over a ``WBELLMatrix`` the preconditioner is None, a
    ``JacobiPrecond``, a ``PolynomialPrecond`` (its ``steps`` and
    ``omega`` over the matrix diagonal), a ``WBellBlockJacobiPrecond``,
    ``"block_jacobi"`` or ``"poly"``; anything else raises ``ValueError``.
    """
    if b.dim() == 2:
        if isinstance(a, WBELLMatrix):
            return _wbell_solve(wbell_cg_solve_multi, a, b, x0,
                                preconditioner, dict(tol=tol, atol=atol,
                                                     maxiter=maxiter))
        # The batched solver routes itself (K5, K3 per column, or the
        # loop); the options it cannot honour are refused, not dropped.
        if track_history:
            raise ValueError("track_history is not supported for "
                             "multi-RHS (2-D b) solves")
        if mixed_precision:
            raise ValueError("mixed_precision is single-RHS only; for "
                             "multi-RHS use fused_dia_cg_multi("
                             "plane_dtype=bfloat16) directly")
        mb = "auto"
        if backend is not None:
            mb = "xla" if backend in ("xla", "padded") else "fused"
        return cg_solve_multi(a, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                              preconditioner=preconditioner, backend=mb)
    if backend is None:
        backend = select_backend(a, b, preconditioner)
    if backend == "wbell":
        if not isinstance(a, WBELLMatrix):
            raise ValueError("backend 'wbell' needs a WBELLMatrix "
                             "(wbell_from_csr or auto_format)")
        return _wbell_solve(wbell_cg_solve, a, b, x0, preconditioner,
                            dict(tol=tol, atol=atol, maxiter=maxiter,
                                 track_history=track_history))
    n = b.shape[0]
    mi = int(maxiter) if maxiter is not None else n
    if mixed_precision and not track_history and n >= FUSED_MIN_ROWS \
            and backend in _IR_ROUTES:
        # Mode routing by the footprint model: bf16 planes with fp32
        # vectors where the model predicts at least the cut (no vector
        # rounding, so no iteration inflation), bf16 vectors otherwise.
        if isinstance(a, DIAMatrix) and bf16_plane_speedup(
                a, n, b.element_size()) >= BF16_PLANE_MIN_SPEEDUP:
            return ir_cg_solve(a, b, x0, tol=tol, atol=atol, maxiter=mi,
                               inner_dtype=torch.float32,
                               inner_plane_dtype=torch.bfloat16,
                               inner_tol=5e-3,
                               preconditioner=preconditioner)
        return ir_cg_solve(a, b, x0, tol=tol, atol=atol, maxiter=mi,
                           preconditioner=preconditioner)
    if track_history and (backend.startswith("resident")
                          or backend in ("sr_stencil", "sr_dia")):
        # The whole-solve kernels keep no per-iteration history; fall back
        # to the two-pass engine (large n) or the loop, as the JAX package.
        backend = ("fused_" + backend.split("_", 1)[1]
                   if n >= FUSED_MIN_ROWS else "xla")
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"auto_solve: backend {backend!r} is not ported yet "
            f"({_NOT_PORTED[backend]})")
    jac = isinstance(preconditioner, JacobiPrecond)
    inv_diag = preconditioner.inv_diag if jac else None
    if backend in ("resident_stencil", "fused_stencil") \
            and preconditioner is not None:
        raise ValueError(f"{backend}: preconditioner must be None")
    if backend in ("resident_dia", "fused_dia") \
            and preconditioner is not None and not jac:
        raise ValueError(f"{backend}: preconditioner must be None or a "
                         f"JacobiPrecond")
    if backend == "resident_stencil":
        return resident_stencil_cg(a, b, x0, tol=tol, atol=atol, maxiter=mi)
    if backend == "resident_dia":
        return resident_dia_cg(a, b, x0, tol=tol, atol=atol, maxiter=mi,
                               jacobi=jac, inv_diag=inv_diag)
    if backend == "fused_stencil":
        return fused_stencil_cg(a, b, x0, tol=tol, atol=atol, maxiter=mi,
                                track_history=track_history)
    if backend == "fused_dia":
        # The caller's inv_diag is passed through, so a custom diagonal
        # keeps its exact trajectory.
        return fused_dia_cg(a, b, x0, tol=tol, atol=atol, maxiter=mi,
                            jacobi=jac, inv_diag=inv_diag,
                            track_history=track_history)
    if backend not in ("xla", "padded"):
        raise ValueError(f"unknown backend {backend!r}")
    return cg_solve(a, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                    preconditioner=preconditioner,
                    track_history=track_history)


def _wbell_solve(solve, a, b, x0, m, kw) -> CGResult:
    """Route a WBELL solve's preconditioner onto the internal-layout
    family of ``solve`` (:func:`wbell_cg_solve` or
    :func:`wbell_cg_solve_multi`), as the JAX package does."""
    if isinstance(m, PolynomialPrecond):
        # The same polynomial over the matrix diagonal, each sweep one K7.
        return solve(a, b, x0, precond="poly", poly_steps=m.steps,
                     poly_omega=m.omega, **kw)
    if isinstance(m, WBellBlockJacobiPrecond) or (
            isinstance(m, str) and m in ("block_jacobi", "poly")):
        return solve(a, b, x0, precond=m, **kw)
    if m is not None and not isinstance(m, JacobiPrecond):
        raise ValueError(
            "wbell backend supports preconditioner=None, JacobiPrecond, "
            "PolynomialPrecond, 'poly', 'block_jacobi', or "
            "WBellBlockJacobiPrecond — all apply in the internal layout")
    return solve(a, b, x0, jacobi=m is not None,
                 inv_diag=m.inv_diag if m is not None else None, **kw)

"""Preconditioners for PCG (PyTorch).

Counterpart of :mod:`cgx.solve.precond`: :class:`JacobiPrecond` and
:class:`PolynomialPrecond`; ``BlockJacobiPrecond`` waits for a later slice
(ROADMAP queue A item 8).  A preconditioner has ``apply(r) -> z`` with
``z = M⁻¹ r``; :func:`cgx_torch.solve.cg.cg_solve` calls it once per
iteration.  ``auto_solve`` hands a Jacobi ``inv_diag`` to the DIA kernels,
which fold it into a symmetric scaling of the operator, and runs a
polynomial over a ``WBELLMatrix`` in its internal layout
(:func:`cgx_torch.solve.wbell.wbell_poly_apply`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import as_matvec

__all__ = ["JacobiPrecond", "PolynomialPrecond"]


@dataclass(frozen=True, eq=False)
class JacobiPrecond:
    """Diagonal (Jacobi) preconditioner: ``M⁻¹ = diag(A)⁻¹``.

    Zero diagonal entries map to 0, leaving those components untouched.
    """

    inv_diag: torch.Tensor

    @classmethod
    def from_matrix(cls, a) -> "JacobiPrecond":
        return cls(inv_diag=safe_recip(a.diagonal()))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.inv_diag * r


class PolynomialPrecond:
    """m-step damped-Jacobi (truncated Neumann) polynomial preconditioner:
    ``m`` sweeps of ``z ← z + ω D⁻¹ (r − A z)`` from ``z₀ = 0``, a valid
    SPD preconditioner while ``ω < 2 / λ_max(D⁻¹A)``.  Each sweep is one
    SpMV.  It closes over the matvec, so it is built per operator."""

    def __init__(self, matvec, inv_diag: torch.Tensor, steps: int = 3,
                 omega: float = 2.0 / 3.0):
        self.matvec = as_matvec(matvec)
        self.inv_diag = inv_diag
        self.steps = int(steps)
        self.omega = float(omega)

    @classmethod
    def from_matrix(cls, a, steps: int = 3,
                    omega: float = 2.0 / 3.0) -> "PolynomialPrecond":
        return cls(a, safe_recip(a.diagonal()), steps=steps, omega=omega)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        z = self.omega * self.inv_diag * r
        for _ in range(self.steps - 1):
            z = z + self.omega * self.inv_diag * (r - self.matvec(z))
        return z

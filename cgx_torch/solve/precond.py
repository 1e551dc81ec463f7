"""Preconditioners for PCG (PyTorch).

Counterpart of :mod:`cgx.solve.precond`.  Only :class:`JacobiPrecond` is
ported; ``BlockJacobiPrecond`` and ``PolynomialPrecond`` wait for a later
slice (ROADMAP queue A item 8).  A preconditioner has ``apply(r) -> z``
with ``z = M⁻¹ r``; :func:`cgx_torch.solve.cg.cg_solve` calls it once per
iteration, and ``auto_solve`` hands its ``inv_diag`` to the DIA kernels,
which fold it into a symmetric scaling of the operator.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from cgx_torch.ops.blas import safe_recip

__all__ = ["JacobiPrecond"]


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

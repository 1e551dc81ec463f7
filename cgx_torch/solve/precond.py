"""Preconditioners for PCG (PyTorch).

Counterpart of :mod:`cgx.solve.precond`: :class:`JacobiPrecond`,
:class:`BlockJacobiPrecond` and :class:`PolynomialPrecond`.  A
preconditioner has ``apply(r) -> z`` with
``z = M⁻¹ r``; :func:`cgx_torch.solve.cg.cg_solve` calls it once per
iteration.  ``auto_solve`` hands a Jacobi ``inv_diag`` to the DIA kernels,
which fold it into a symmetric scaling of the operator, and runs a
polynomial over a ``WBELLMatrix`` in its internal layout
(:func:`cgx_torch.solve.wbell.wbell_poly_apply`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import as_matvec

__all__ = ["JacobiPrecond", "BlockJacobiPrecond", "PolynomialPrecond"]


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


@dataclass(frozen=True, eq=False)
class BlockJacobiPrecond:
    """Block-Jacobi: ``M⁻¹ = blockdiag(D₁⁻¹, …, D_m⁻¹)``.

    ``inv_blocks`` holds the dense inverses of the ``(bs, bs)`` diagonal
    blocks of A; ``apply`` is a batched ``(bs, bs)`` matvec.
    """

    inv_blocks: torch.Tensor   # (n_blocks, bs, bs)
    blocksize: int

    @classmethod
    def from_matrix(cls, a, blocksize: int) -> "BlockJacobiPrecond":
        """Extract the diagonal blocks of a ``CSRMatrix`` and invert them
        on the host in numpy; the inverses land on the matrix's device."""
        vals = a.values.detach().cpu().numpy()
        cols = a.col_indices.cpu().numpy()
        rows = a.row_indices.cpu().numpy()
        n = a.shape[0]
        bs = int(blocksize)
        nb = -(-n // bs)
        blocks = np.zeros((nb, bs, bs), dtype=vals.dtype)
        on_blockdiag = rows // bs == cols // bs
        blocks[(rows // bs)[on_blockdiag], (rows % bs)[on_blockdiag],
               (cols % bs)[on_blockdiag]] = vals[on_blockdiag]
        # Padding rows (beyond n) get the identity so the inverse exists.
        tail = np.arange(n, nb * bs)
        blocks[tail // bs, tail % bs, tail % bs] = 1.0
        # Empty diagonal slots also get 1 to keep blocks nonsingular.
        idx = np.arange(bs)
        d = blocks[:, idx, idx]
        blocks[:, idx, idx] = np.where(d == 0, 1.0, d)
        inv = np.linalg.inv(blocks)
        return cls(inv_blocks=torch.from_numpy(inv).to(a.values.device),
                   blocksize=bs)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        n = r.shape[0]
        bs = self.blocksize
        nb = self.inv_blocks.shape[0]
        pad = nb * bs - n
        rb = torch.nn.functional.pad(r, (0, pad)).reshape(nb, bs)
        dt = torch.promote_types(self.inv_blocks.dtype, r.dtype)
        zb = torch.einsum("bij,bj->bi", self.inv_blocks.to(dt), rb.to(dt))
        return zb.reshape(-1)[:n].to(r.dtype)


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

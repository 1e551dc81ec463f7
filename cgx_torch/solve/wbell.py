"""CG over the WBELL unstructured-sparsity format (PyTorch).

Counterpart of :mod:`cgx.solve.wbell`.  The whole Krylov iteration runs in
WBELL's internal ``(nt, 8, 128)`` layout: ``b`` goes in and ``x`` comes out
through the layout transform once per solve.  Padding lanes are zero in
``b`` and stay zero under the operator, so they never perturb the dots.

:func:`wbell_cg_solve` runs the port's :func:`~cgx_torch.solve.cg.cg_solve`
loop with K7 as the matvec (one host read per iteration).  The batched
:func:`wbell_cg_solve_multi` is the JAX package's ``lax.while_loop`` as a
Python loop over the same ``cond``/``body``: per-column α and β, finished
columns frozen, one shared SpMM per iteration (K8 by default, K7 with
``tiered=False``), one host read per iteration.  On the card K8 is K7's
row kernel over its tier plan's row layout, whose arrays are K7's, and the
column dots are the single-RHS solve's, so each column follows the
single-RHS trajectory of that column bit for bit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cgx_torch.kernels.wbell import (WBellTierPlan, build_tier_plan,
                                     wbell_spmm, wbell_spmm_tiered,
                                     wbell_spmv)
from cgx_torch.ops import blas
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult, cg_solve
from cgx_torch.sparse.wbell import WBELLMatrix

__all__ = ["wbell_cg_solve", "wbell_cg_solve_multi",
           "WBellBlockJacobiPrecond", "wbell_poly_apply", "batched_cg"]


@dataclass(frozen=True, eq=False)
class WBellBlockJacobiPrecond:
    """Supervariable block-Jacobi in WBELL's internal layout: the exact
    inverses of the densified 8×8 diagonal blocks, applied as ``z[g, :, l]
    = B⁻¹[g, :, :, l] r[g, :, l]``."""

    binv: torch.Tensor          # (nt, 8, 8, 128) fp32

    @classmethod
    def from_wbell(cls, a: WBELLMatrix) -> "WBellBlockJacobiPrecond":
        """Extract the diagonal blocks from the slot planes on the device
        (only the (nt·128, 8, 8) blocks come to the host) and invert them
        in fp64 on the host."""
        lanes = torch.arange(128, device=a.device)
        # Absolute block column and block row of each (plane, lane).
        abs_bc = a.p_ga.long()[:, None] * 128 + a.lc[:, 0, :].long()
        abs_br = a.p_og.long()[:, None] * 128 + lanes[None, :]
        p, l = torch.nonzero(abs_bc == abs_br, as_tuple=True)
        nbr = a.nt * 128
        blocks = torch.zeros((nbr, 8, 8), dtype=a.values.dtype,
                             device=a.device)
        # Zero-valued phantom slots (lc = 0 padding) may alias block
        # column 0: the scatter-ADD makes their contribution exactly zero.
        blocks.index_add_(0, abs_br[p, l], a.values[p, :, :, l])
        blocks = blocks.cpu().double().numpy()
        # Padding block rows are all zero: identity keeps them invertible
        # (and zero in every solve vector); zero diagonal entries get 1.
        zero_rows = ~blocks.any(axis=(1, 2))
        blocks[zero_rows] = np.eye(8)
        d = np.einsum("bii->bi", blocks)
        d[d == 0.0] = 1.0
        binv = np.linalg.inv(blocks)
        binv = binv.reshape(a.nt, 128, 8, 8).transpose(0, 2, 3, 1)
        return cls(binv=torch.from_numpy(binv.astype(np.float32)).to(
            a.device))

    def apply_internal(self, r: torch.Tensor) -> torch.Tensor:
        """(nt, 8, 128) internal-layout apply."""
        return torch.einsum("gijl,gjl->gil", self.binv.to(r.dtype), r)

    apply = apply_internal


def wbell_poly_apply(a: WBELLMatrix, r: torch.Tensor, idi: torch.Tensor,
                     steps: int, omega: float) -> torch.Tensor:
    """m-step damped-Jacobi polynomial in the internal layout, K7 as the
    matvec (:class:`cgx_torch.solve.precond.PolynomialPrecond`'s
    semantics)."""
    z = omega * idi * r
    for _ in range(steps - 1):
        z = z + omega * idi * (r - wbell_spmv(a, z))
    return z


def _precond_parts(a: WBELLMatrix, jacobi, inv_diag, precond, poly_steps):
    """``(idi, binv, steps)`` for the preconditioner arguments, as the JAX
    package parses them."""
    if precond is not None and jacobi:
        raise ValueError("pass either jacobi=True or precond=, not both")
    if isinstance(precond, str) and precond == "poly":
        return safe_recip(a.diag_internal), None, int(poly_steps)
    if isinstance(precond, str) and precond == "block_jacobi":
        return None, WBellBlockJacobiPrecond.from_wbell(a).binv, 0
    if isinstance(precond, WBellBlockJacobiPrecond):
        return None, precond.binv, 0
    if precond is not None:
        raise ValueError(f"unknown wbell precond {precond!r}; expected "
                         "'poly', 'block_jacobi', or a "
                         "WBellBlockJacobiPrecond")
    if jacobi:
        idi = (a.to_internal(inv_diag) if inv_diag is not None
               else safe_recip(a.diag_internal))
        return idi, None, 0
    return None, None, 0


def wbell_cg_solve(
    a: WBELLMatrix,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    jacobi: bool = False,
    inv_diag: Optional[torch.Tensor] = None,
    precond=None,
    poly_steps: int = 3,
    poly_omega: float = 2.0 / 3.0,
    track_history: bool = False,
) -> CGResult:
    """Solve ``A x = b`` by (P)CG through K7.

    ``b``/``x0`` and the returned ``x`` are standard-order ``(n,)``
    vectors.  ``inv_diag`` (standard order) overrides the diagonal for the
    Jacobi scaling.  ``precond``: ``"poly"`` (``poly_steps`` damped-Jacobi
    sweeps, each one K7 launch), ``"block_jacobi"``, a prebuilt
    :class:`WBellBlockJacobiPrecond`, or None; exclusive with ``jacobi``.
    """
    maxiter = b.shape[0] if maxiter is None else maxiter
    bi = a.to_internal(b)
    xi0 = a.to_internal(x0) if x0 is not None else None
    idi, binv, steps = _precond_parts(a, jacobi, inv_diag, precond,
                                      poly_steps)
    if steps:
        def apply_m(r):
            return wbell_poly_apply(a, r, idi, steps, float(poly_omega))
    elif binv is not None:
        apply_m = WBellBlockJacobiPrecond(binv=binv).apply_internal
    elif idi is not None:
        def apply_m(r):
            return r * idi
    else:
        apply_m = None
    res = cg_solve(a, bi, xi0, tol=float(tol), atol=float(atol),
                   maxiter=int(maxiter), preconditioner=apply_m,
                   track_history=track_history)
    return dataclasses.replace(res, x=a.from_internal(res.x))


def wbell_cg_solve_multi(
    a: WBELLMatrix,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    jacobi: bool = False,
    inv_diag: Optional[torch.Tensor] = None,
    precond=None,
    poly_steps: int = 3,
    poly_omega: float = 2.0 / 3.0,
    tiered: Optional[bool] = None,
    tier_plan: Optional[WBellTierPlan] = None,
) -> CGResult:
    """Multi-RHS ``A X = B`` through one shared SpMM per iteration.

    ``b`` is standard-order ``(n, k)``; ``x`` comes back ``(n, k)`` and
    the scalars ``(k,)``, each column with its own convergence schedule
    (finished columns freeze).  Preconditioners as :func:`wbell_cg_solve`.
    The SpMM is K8 over a tier plan whenever ``span <= 16`` (the JAX
    package also asks that the resident kernel fit VMEM; the card has no
    such cap) unless ``tiered=False``; ``tier_plan`` reuses a built plan
    and its row layout (built once per plan, on its device).
    """
    n, k = b.shape
    maxiter = n if maxiter is None else int(maxiter)
    bi = torch.stack([a.to_internal(b[:, j]) for j in range(k)])
    xi0 = (torch.stack([a.to_internal(x0[:, j]) for j in range(k)])
           if x0 is not None else None)
    idi, binv, steps = _precond_parts(a, jacobi, inv_diag, precond,
                                      poly_steps)
    plan = tier_plan
    if plan is None and tiered is not False:
        if a.span <= 16:
            plan = build_tier_plan(a)
        elif tiered:
            raise ValueError("tiered=True needs span <= 16")
    if plan is not None:
        def spmm(x):
            return wbell_spmm_tiered(plan, x)
    else:
        def spmm(x):
            return wbell_spmm(a, x)
    omega = float(poly_omega)
    if steps:
        def apply_m(r):
            z = omega * idi[None] * r
            for _ in range(steps - 1):
                z = z + omega * idi[None] * (r - spmm(z))
            return z
    elif binv is not None:
        def apply_m(r):
            return torch.einsum("gijl,kgjl->kgil", binv.to(r.dtype), r)
    else:
        def apply_m(r):
            return r * idi[None] if idi is not None else r

    res = batched_cg(spmm, bi, xi0, apply_m,
                     idi is not None or binv is not None, tol=tol,
                     atol=atol, maxiter=maxiter)
    xs = torch.stack([a.from_internal(res.x[j]) for j in range(k)], dim=1)
    return dataclasses.replace(res, x=xs)


def batched_cg(spmm, b: torch.Tensor, x0: Optional[torch.Tensor], apply_m,
               precond_on: bool, *, tol: float, atol: float, maxiter: int,
               group=None) -> CGResult:
    """The JAX package's batched ``while_loop`` as a Python loop over
    internal-layout columns ``(k, ...)``: per-column α and β, finished
    columns frozen, one shared ``spmm`` and one host read per iteration.
    With ``group`` (a row-distributed solve, each rank's slabs) the
    column dots of each step are summed over the ranks in one all-reduce
    (two an iteration, one before the loop); without it they are the
    rank's own.  ``x`` comes back in the internal layout."""
    from cgx_torch.dist.halo import sum_over

    def reduced(*cols):
        return sum_over(torch.stack(cols), group).unbind() \
            if group is not None else cols

    f32 = torch.float32
    x = b * 0 if x0 is None else x0
    r = b if x0 is None else b - spmm(x0)
    z = apply_m(r)
    p = z
    rz, rr, bb = reduced(blas.dot_rows(r, z), blas.dot_rows(r, r),
                         blas.dot_rows(b, b))
    if not precond_on:
        rr = rz
    tol_sq = torch.clamp(torch.tensor(tol, dtype=f32) ** 2 * bb,
                         min=float(torch.tensor(atol, dtype=f32) ** 2))
    k = b.shape[0]
    it = torch.zeros(k, dtype=torch.int32, device=b.device)
    one = torch.ones((), dtype=rz.dtype, device=rz.device)
    while True:
        active = (rr > tol_sq) & (it < maxiter)
        if not bool(active.any()):
            break
        q = spmm(p)
        pq, = reduced(blas.dot_rows(p, q))
        alpha = torch.where(active, rz / torch.where(pq != 0, pq, one),
                            torch.zeros_like(pq))
        ax = alpha[:, None, None, None].to(x.dtype)
        x = x + ax * p
        r = r - ax * q
        z = apply_m(r)
        if precond_on:
            rz_new, rr_new = reduced(blas.dot_rows(r, z),
                                     blas.dot_rows(r, r))
        else:
            rz_new, = reduced(blas.dot_rows(r, z))
            rr_new = rz_new
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, one),
                           torch.zeros_like(rz))
        bx = beta[:, None, None, None].to(x.dtype)
        p = torch.where(active[:, None, None, None], z + bx * p, p)
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, rr_new, rr)
        it = it + active.to(torch.int32)
    return CGResult(x=x, iterations=it, residual_norm_sq=rr,
                    converged=rr <= tol_sq,
                    history=torch.zeros(0, dtype=f32, device=b.device))

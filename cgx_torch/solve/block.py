"""Multi-RHS solves: batched CG over a block of right-hand sides (PyTorch).

Counterpart of :mod:`cgx.solve.block`.  :func:`cg_solve_multi` solves
``A X = B`` column by column:

* ``"xla"``, the batched loop: what ``jax.vmap`` of ``cg_solve`` is in the
  JAX package, written out.  One ``spmm`` per iteration, each column with
  its own α, β and exit; a column that has met its tolerance is frozen
  (its state is kept, as the vmapped ``while_loop`` keeps it) and reports
  its own iteration count.  Each column is summed as the single-RHS
  :func:`~cgx_torch.solve.cg.cg_solve` sums it.  One host read per
  iteration.
* ``"fused"``, the engine K5 (:mod:`cgx_torch.kernels.fused_multi`): the
  coefficient planes are read once per iteration for all k columns; the
  iteration count is shared.
* ``"sequential"``: k single-RHS solves through K3, stacked.

``"auto"`` takes the fused routes where the JAX package asks for a TPU:
here when ``B`` is a float32 CUDA tensor of at least ``FUSED_MIN_ROWS``
rows (K5 and K3 take float32 only).  There it picks K3 per column for a
narrow-band DIA operator and K5 otherwise, by the JAX package's rule
(:func:`_narrow_band`), which was measured on the TPU and is not yet
measured on the card.

:func:`block_cg_solve` is true block CG (BFBCG), one Krylov space shared
by the columns.
"""
from __future__ import annotations

from typing import Optional

import torch

from cgx_torch.kernels.fused_cg import fused_stencil_cg, supports
from cgx_torch.kernels.fused_dia_cg import (data_symmetric_or_none,
                                            fused_dia_cg, supports_dia,
                                            wrap_entries_zero_or_none)
from cgx_torch.kernels.fused_multi import (fused_dia_cg_multi,
                                           fused_stencil_cg_multi)
from cgx_torch.ops import blas
from cgx_torch.ops.spmv import spmm
from cgx_torch.solve.cg import CGResult, _as_apply, _tol_sq
from cgx_torch.solve.precond import JacobiPrecond
from cgx_torch.utils.profiling import (ENGINE, PREP, RESULT, ROUTE, annotate,
                                       host_read)

__all__ = ["cg_solve_multi", "block_cg_solve", "FUSED_MIN_ROWS"]

# The fewest rows at which the fused engines (K3, K5) are taken, by
# cg_solve_multi here and by auto_solve's history route.  Carried over from
# the JAX package, where it was measured on a TPU v5e; not measured on the
# H100 yet.
FUSED_MIN_ROWS = 3_000_000


def _fused_multi_backend(a, b, preconditioner):
    """``("stencil"|"dia", jacobi)`` if the fused multi engine can run
    this (operator pattern + preconditioner compatibility), else None."""
    if preconditioner is None and supports(a):
        return ("stencil", False)
    jac = isinstance(preconditioner, JacobiPrecond)
    if ((preconditioner is None or jac) and supports_dia(a)
            and wrap_entries_zero_or_none(a) is True):
        return ("dia", jac)
    return None


def _narrow_band(a) -> bool:
    """Whether a fused-capable DIA operator streams few enough coefficient
    planes that k single-RHS solves through K3 are preferred to K5: fewer
    than 5 planes.  The count is the JAX package's, ``1 + #positive
    offsets`` for symmetric data and every offset otherwise, even where the
    engines keep a unit diagonal as a constant tap, so that both packages
    route an operator the same way.  (The JAX package measured on the TPU:
    7-point, 4 planes, lost 0.93× through the band engine; 27-point, 14,
    won 1.79×.  Not measured on the card.)"""
    offs = tuple(map(int, a.offsets))
    sym = data_symmetric_or_none(a) is True
    n_planes = (1 + sum(1 for o in offs if o > 0)) if sym else len(offs)
    return n_planes < 5


def _column(v: Optional[torch.Tensor], j: int):
    return None if v is None else v[:, j].contiguous()


def _sequential_fused_multi(kind, a, b, x0, *, tol, atol, maxiter,
                            jacobi, preconditioner) -> CGResult:
    """k single-RHS solves through K3, stacked with the axes of
    :func:`cg_solve_multi`.  The DIA symmetry check runs once."""
    if kind == "stencil":
        cols = [fused_stencil_cg(a, _column(b, j), _column(x0, j), tol=tol,
                                 atol=atol, maxiter=maxiter)
                for j in range(b.shape[1])]
    else:
        sym = data_symmetric_or_none(a)
        invd = preconditioner.inv_diag if jacobi else None
        cols = [fused_dia_cg(a, _column(b, j), _column(x0, j), tol=tol,
                             atol=atol, maxiter=maxiter, jacobi=jacobi,
                             inv_diag=invd, assume_symmetric=sym)
                for j in range(b.shape[1])]
    with annotate(RESULT):
        return CGResult(
            x=torch.stack([c.x for c in cols], dim=1),
            iterations=torch.stack([c.iterations for c in cols]),
            residual_norm_sq=torch.stack([c.residual_norm_sq
                                          for c in cols]),
            converged=torch.stack([c.converged for c in cols]),
            history=torch.stack([c.history for c in cols]))


def _columns(fn, v: torch.Tensor) -> torch.Tensor:
    """``fn`` on each row of ``v`` (``(k, n)``), stacked."""
    return torch.stack([fn(v[j]) for j in range(v.shape[0])])


def _batched_cg(a, b, x0, *, tol, atol, maxiter, preconditioner) -> CGResult:
    """The vmapped ``cg_solve``: per-column state ``(k, n)``, each column
    frozen at its own exit."""
    if callable(a):
        def matvec(v):
            return _columns(a, v)
    else:
        def matvec(v):
            return spmm(a, v.T).T.contiguous()
    apply_m = _as_apply(preconditioner)

    def precond(r):
        return _columns(apply_m, r) if apply_m is not None else r

    with annotate(PREP):
        bt = b.T.contiguous()
        k = bt.shape[0]
        if x0 is None:
            x, r = torch.zeros_like(bt), bt
        else:
            x = x0.T.contiguous()
            r = bt - matvec(x)
        z = precond(r)
        p = z
        rz = blas.dot_rows(r, z)
        rr = blas.dot_rows(r, r) if apply_m is not None else rz
        tol_sq = torch.stack([_tol_sq(tol, atol, bt[j]) for j in range(k)])
        it = torch.zeros(k, dtype=torch.int32, device=b.device)
    with annotate(ENGINE):
        while True:
            active = (it < maxiter) & (rr > tol_sq)
            if not host_read(torch.any(active), bool):
                break
            q = matvec(p)
            alpha = (rz / blas.dot_rows(p, q))[:, None]
            x_new = x + alpha * p
            r_new = r - alpha * q
            z_new = precond(r_new)
            rz_new = blas.dot_rows(r_new, z_new)
            rr_new = (blas.dot_rows(r_new, r_new) if apply_m is not None
                      else rz_new)
            p_new = z_new + (rz_new / rz)[:, None] * p
            keep = active[:, None]
            x = torch.where(keep, x_new, x)
            r = torch.where(keep, r_new, r)
            p = torch.where(keep, p_new, p)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            it = it + active.to(torch.int32)
    with annotate(RESULT):
        return CGResult(x=x.T, iterations=it, residual_norm_sq=rr,
                        converged=rr <= tol_sq,
                        history=torch.zeros((k, 0), dtype=b.dtype,
                                            device=b.device))


def cg_solve_multi(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    backend: str = "auto",
) -> CGResult:
    """Solve ``A X = B`` column by column with one batched CG loop.

    ``b``: (n, k) block of right-hand sides.  Returns a :class:`CGResult`
    whose fields carry the batch axis (``x``: (n, k);
    ``iterations``/``converged``/``residual_norm_sq``: (k,)).

    ``backend``: ``"auto"`` (see the module note), ``"xla"`` (the batched
    loop), ``"fused"`` (K5) or ``"sequential"`` (K3 per column).  The
    fused routes take a constant stencil with no preconditioner, or a
    wrap-free DIA operator with none or a ``JacobiPrecond``; naming one for
    another operator raises ``ValueError``.
    """
    if b.dim() != 2:
        raise ValueError(f"cg_solve_multi expects b of shape (n, k), "
                         f"got {tuple(b.shape)}")
    mi = int(maxiter) if maxiter is not None else b.shape[0]
    mode, kind, jac = _multi_route(a, b, preconditioner, backend)
    if mode == "xla":
        return _batched_cg(a, b, x0, tol=tol, atol=atol, maxiter=mi,
                           preconditioner=preconditioner)
    if mode == "sequential":
        return _sequential_fused_multi(
            kind, a, b, x0, tol=tol, atol=atol, maxiter=mi, jacobi=jac,
            preconditioner=preconditioner)
    if kind == "stencil":
        return fused_stencil_cg_multi(a, b, x0, tol=tol, atol=atol,
                                      maxiter=mi)
    return fused_dia_cg_multi(
        a, b, x0, tol=tol, atol=atol, maxiter=mi, jacobi=jac,
        inv_diag=preconditioner.inv_diag if jac else None)


def _multi_route(a, b, preconditioner, backend: str):
    """``(mode, kind, jacobi)``: the route of :func:`cg_solve_multi`,
    ``mode`` one of ``"xla"``, ``"fused"``, ``"sequential"``, and for the
    fused modes the operator kind of :func:`_fused_multi_backend`.  Reads
    only ``b``'s device, dtype and shape (and the DIA data's checks); a
    ``cgx.route`` span."""
    with annotate(ROUTE):
        if backend not in ("auto", "xla", "fused", "sequential"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "xla" or (backend == "auto" and not (
                b.device.type == "cuda" and b.dtype == torch.float32
                and b.shape[0] >= FUSED_MIN_ROWS)):
            return "xla", None, False
        routed = _fused_multi_backend(a, b, preconditioner)
        if routed is None:
            if backend == "auto":
                return "xla", None, False
            raise ValueError(f"backend={backend!r}: operator/"
                             "preconditioner not fused-capable")
        kind, jac = routed
        mode = backend
        if backend == "auto":
            mode = ("sequential" if kind == "dia" and _narrow_band(a)
                    else "fused")
        return mode, kind, jac


def block_cg_solve(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
) -> CGResult:
    """True block CG: the k columns share one Krylov space, so spectrally
    clustered right-hand sides converge in fewer iterations than
    independent per-column recurrences (:func:`cg_solve_multi`).

    Breakdown-free form (BFBCG, Ji & Li 2017): the direction block ``P`` is
    re-orthonormalised by thin QR every iteration, which keeps ``PᵀAP``
    SPD with conditioning bounded by the operator's spectrum.  Per
    iteration: one SpMM, one (n, k) thin QR, and k×k Cholesky solves and
    (k, n)·(n, k) Gram products accumulated in fp32 (fp64 for fp64
    input).  Stops when every column satisfies
    ``‖r_j‖ ≤ max(tol·‖b_j‖, atol)`` or at ``maxiter``; ``iterations`` is
    the shared count as ``(k,)``.
    """
    if b.dim() != 2:
        raise ValueError(f"block_cg_solve expects b of shape (n, k), "
                         f"got {tuple(b.shape)}")
    n, k = b.shape
    maxiter = n if maxiter is None else int(maxiter)
    if callable(a):
        def mv(v):
            return _columns(a, v.T).T
    else:
        def mv(v):
            return spmm(a, v)
    apply_m = _as_apply(preconditioner)

    def precond(r):
        return r if apply_m is None else _columns(apply_m, r.T).T

    f32 = (torch.float32 if b.dtype in (torch.bfloat16, torch.float16,
                                        torch.float32) else b.dtype)
    dev = b.device

    def gram(u, v):
        # (k, k) = uᵀ v, accumulated in f32 (f64 for f64 input).
        return u.to(f32).T @ v.to(f32)

    eye = torch.eye(k, dtype=f32, device=dev)
    rel = 1e-6 if f32 == torch.float32 else 1e-14

    def solve_spd(g, rhs):
        # g = PᵀAP with orthonormal P: SPD, cond(g) ≤ cond(A).  A tiny
        # relative jitter guards the Cholesky against roundoff in the last
        # bits; it does not change the math at convergence.
        eps = torch.trace(g) / k * rel + 1e-30
        low = torch.linalg.cholesky(g + eps * eye)
        return torch.cholesky_solve(rhs, low)

    def orth(u):
        # Thin QR; near-zero columns yield arbitrary but orthonormal
        # replacements (harmless extra search directions).
        return torch.linalg.qr(u.to(f32), mode="reduced").Q

    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x = x0.to(b.dtype)
        r = b - mv(x)
    p = orth(precond(r))
    bb = torch.sum(b.to(f32) ** 2, dim=0)
    tol_sq = torch.clamp(torch.tensor(tol, dtype=f32, device=dev) ** 2 * bb,
                         min=float(torch.tensor(atol, dtype=f32) ** 2))
    rr = torch.sum(r.to(f32) ** 2, dim=0)
    it = 0
    while it < maxiter and bool(torch.any(rr > tol_sq)):
        q = mv(p.to(b.dtype))
        g = gram(p, q)
        alpha = solve_spd(g, gram(p, r))
        x = x + (p @ alpha).to(b.dtype)
        r = r - (q.to(f32) @ alpha).to(b.dtype)
        z = precond(r)
        beta = -solve_spd(g, gram(q, z))
        p = orth(z.to(f32) + p @ beta)
        rr = torch.sum(r.to(f32) ** 2, dim=0)
        it += 1
    return CGResult(x=x,
                    iterations=torch.full((k,), it, dtype=torch.int32,
                                          device=dev),
                    residual_norm_sq=rr.to(b.dtype),
                    converged=rr <= tol_sq,
                    history=torch.zeros(0, dtype=b.dtype, device=dev))

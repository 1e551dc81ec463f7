"""Mixed-precision iterative-refinement CG (PyTorch port).

Counterpart of :mod:`cgx.solve.ir` (``ir_cg_solve``, ``ir_supported``).
The two-pass iteration is bound by bytes, so narrower streams make each
iteration cheaper; CG in bf16 alone stalls near bf16's roundoff, and
iterative refinement keeps full accuracy:

    fp32 outer:  r = b − A·x           (the true residual: one fp32 kernel-A
                                        pass, ``eng32.init(b, x)``)
    narrow inner: solve A·d ≈ r to ``inner_tol`` with the two-pass engine
                 (K3) in a narrow mode: bf16 vectors (the default), or
                 fp32 vectors with bf16 coefficient planes
    fp32 outer:  x ← x + d

The outer loop is a Python loop with one host read per outer cycle (about
three at ``inner_tol`` 1e-2); each inner solve reads the engine's exit
flag once per chunk of iterations, as :meth:`FusedCG.run` does.  Two outer
cycles in a row without progress end the refinement, and a warm-started
fp32 solve finishes whatever is left, as in the JAX package.
:func:`ir_cg_solve_reference` runs the same loop through the engines'
plain versions, on any device.

Two guards the JAX package lacks, both for inner operators whose bf16
planes no longer define an SPD operator.  Under Jacobi scaling a
variable-coefficient 7-point D·A·D becomes A/6, and bf16 rounds every
−1/6 to −0.16699: the spectrum moves down by about 0.00195, past λ_min
(1.3e-4 at 192³), and the inner CG breaks down (NaN) or never reaches
``inner_tol``.  So (1) before refining, one kernel-A pass of each engine
on the grid's smoothest mode compares the Rayleigh quotients; if the
narrow one lost more than half of the fp32 one, the refinement is skipped
and the fp32 finish solves alone; (2) a correction whose true residual is
not finite is dropped and ends the refinement.
"""
from __future__ import annotations

from typing import Optional

import torch

from cgx_torch.kernels import fused_cg
from cgx_torch.kernels.fused_dia_cg import (build_fused_dia, supports_dia,
                                            wrap_entries_zero_or_none)
from cgx_torch.kernels.fused_engine import exact_dot
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult
from cgx_torch.solve.precond import JacobiPrecond

__all__ = ["ir_cg_solve", "ir_cg_solve_reference", "ir_supported"]


def ir_supported(a) -> bool:
    """Whether ``a`` has a two-pass engine route for the narrow inner
    solve (a constant-coefficient stencil, or a wrap-free banded DIA)."""
    if fused_cg.supports(a):
        return True
    return bool(supports_dia(a) and wrap_entries_zero_or_none(a) is True)


def ir_cg_solve(a, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                atol: float = 0.0, maxiter: int = 2000,
                inner_tol: float = 1e-2,
                inner_maxiter: Optional[int] = None, max_outer: int = 40,
                inner_dtype=torch.bfloat16, inner_plane_dtype=None,
                preconditioner=None) -> CGResult:
    """CG by mixed-precision iterative refinement; the JAX package's
    semantics.  ``residual_norm_sq`` is the true fp32 ``‖b − A·x‖²``
    (weighted by ``diag A`` under Jacobi, as the engines' exit test),
    ``iterations`` the total inner iterations, and ``converged`` tests
    ``max(tol²·‖b‖², atol²)``.

    ``inner_dtype``: the inner vectors (bf16, or float32 for a restarted
    fp32 CG); ``inner_plane_dtype``: the inner DIA engine's planes (bf16
    planes with float32 vectors: no per-iteration vector rounding, keep
    ``inner_tol`` at or above the planes' ~4e-3 rounding).
    ``preconditioner``: None or a :class:`JacobiPrecond` (DIA only,
    applied as the inner engine's diagonal scaling).  On a CUDA tensor the
    engines launch K3; on a CPU tensor they take their plain versions.
    """
    return _ir(a, b, x0, tol, atol, maxiter, inner_tol, inner_maxiter,
               max_outer, inner_dtype, inner_plane_dtype, preconditioner,
               plain=False)


def ir_cg_solve_reference(a, b: torch.Tensor, x0=None, *,
                          tol: float = 1e-6, atol: float = 0.0,
                          maxiter: int = 2000, inner_tol: float = 1e-2,
                          inner_maxiter: Optional[int] = None,
                          max_outer: int = 40, inner_dtype=torch.bfloat16,
                          inner_plane_dtype=None,
                          preconditioner=None) -> CGResult:
    """:func:`ir_cg_solve` through the engines' plain versions only (any
    device): the yardstick the card's run is held against."""
    return _ir(a, b, x0, tol, atol, maxiter, inner_tol, inner_maxiter,
               max_outer, inner_dtype, inner_plane_dtype, preconditioner,
               plain=True)


def _ir(a, b, x0, tol, atol, maxiter, inner_tol, inner_maxiter, max_outer,
        inner_dtype, inner_plane_dtype, preconditioner, plain) -> CGResult:
    if inner_maxiter is None:
        inner_maxiter = maxiter
    maxiter = int(maxiter)
    b32 = b.to(torch.float32)
    jac = isinstance(preconditioner, JacobiPrecond)
    if preconditioner is not None and not jac:
        raise ValueError("ir_cg_solve supports preconditioner=None or "
                         "JacobiPrecond (inner diagonal scaling) only")
    inv_diag = preconditioner.inv_diag if jac else None

    if fused_cg.supports(a) and not jac:
        eng = fused_cg.build_fused(a, inner_dtype)
        eng32 = fused_cg.build_fused(a, torch.float32)
        ee = inv_ee = None
    else:
        eng, _, _ = build_fused_dia(a, inner_dtype, jacobi=jac,
                                    inv_diag=inv_diag,
                                    plane_dtype=inner_plane_dtype)
        eng32, e32, _ = build_fused_dia(a, torch.float32, jacobi=jac,
                                        inv_diag=inv_diag)
        # DIA with no preconditioner: no scaling, the stencil branch's code.
        ee = None if e32 is None else e32.to(torch.float32)
        inv_ee = None if ee is None else safe_recip(ee)

    def start(engine, rhs, x=None):
        ka = engine.kernel_a_reference if plain else engine.kernel_a
        return engine._init(rhs, x, 0, ka)

    def advance(engine, st, upto, tol_sq):
        run = engine.run_reference if plain else engine.run
        return run(st, upto, tol_sq)

    def outer_state(x):
        """``(r, rr)``: the true fp32 residual from one fp32 kernel-A pass;
        in the DIA branch ``r`` is scaled (``e·(b − A·x)``, the inner
        engine's right-hand side) and ``rr`` the true-space norm."""
        if ee is None:
            st = start(eng32, b32, x)
        else:
            st = start(eng32, ee * b32, inv_ee * x)
        return st.r, st.rz[1]

    def inner_correction(r32):
        """``d ≈ A⁻¹·r`` from one narrow solve from zero, and its
        iterations."""
        st = start(eng, r32.to(inner_dtype))
        rr = exact_dot(r32, r32) if ee is None else st.rz[1]
        st = advance(eng, st, int(inner_maxiter), inner_tol ** 2 * rr)
        y = st.x.to(torch.float32)
        return (y if ee is None else ee * y), st.k

    def keeps_bottom():
        """Whether the narrow engine keeps at least half of the fp32
        engine's Rayleigh quotient on the grid's smoothest mode (the
        bottom of a Laplacian-like spectrum)."""
        axes = [torch.sin(torch.pi * torch.arange(
            1, m + 1, dtype=torch.float64, device=b.device) / (m + 1))
            for m in (eng.nx, eng.ny, eng.nz)]
        v = torch.einsum("i,j,k->ijk", *axes).reshape(-1).float()
        rq = []
        for engine in (eng, eng32):
            ka = engine.kernel_a_reference if plain else engine.kernel_a
            vn = v.to(engine.dtype)
            rq.append(exact_dot(vn, ka(vn)[0]))
        return bool(rq[0] >= 0.5 * rq[1])

    bb = exact_dot(b32, b32)
    tol_sq = torch.clamp(
        torch.tensor(tol, dtype=torch.float32).square().item() * bb,
        min=torch.tensor(atol, dtype=torch.float32).square().item())
    if x0 is None:
        x = torch.zeros_like(b32)
        r, rr = (b32 if ee is None else ee * b32), bb
    else:
        x = x0.to(torch.float32).clone()
        r, rr = outer_state(x)

    strikes = total = outer = 0
    go = bool(rr > tol_sq)
    if go and eng.planes is not None and eng.plane_dtype != torch.float32:
        go = keeps_bottom()
    while go and outer < max_outer and total < maxiter and strikes < 2:
        d, k_in = inner_correction(r)
        x_new = x + d
        r_new, rr_new = outer_state(x_new)
        better, go, k_in, finite = torch.stack([
            (rr_new < rr).to(torch.int64), (rr_new > tol_sq).to(torch.int64),
            k_in.to(torch.int64), torch.isfinite(rr_new).to(torch.int64)
        ]).tolist()
        total += k_in
        outer += 1
        if not finite:
            # The inner solve broke down (guard 2 of the module note): the
            # same residual would break it again, so keep the last finite
            # x and let the fp32 finish take over.
            break
        # Two-strikes stagnation guard: bf16 recurrence drift makes the
        # occasional cycle non-monotone; bail only after two in a row.
        strikes = 0 if better else strikes + 1
        x, r, rr = x_new, r_new, rr_new

    if not bool(rr <= tol_sq):
        # Refinement stalled above tol (bf16 floor effects can cap the
        # per-cycle contraction): finish with a warm-started fp32 solve, so
        # the solve converges whenever fp32 CG would.
        budget = max(maxiter - total, 0)
        if ee is None:
            st = start(eng32, b32, x)
            st = advance(eng32, st, budget, tol_sq)
            x = st.x
        else:
            st = start(eng32, ee * b32, inv_ee * x)
            st = advance(eng32, st, budget, tol_sq)
            x = ee * st.x
        rr = st.rz[1]
        total += int(st.k)
    return CGResult(x=x.to(b.dtype),
                    iterations=torch.tensor(total, dtype=torch.int32,
                                            device=b.device),
                    residual_norm_sq=rr, converged=rr <= tol_sq,
                    history=torch.zeros(0, device=b.device))

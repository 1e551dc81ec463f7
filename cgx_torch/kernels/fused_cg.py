"""Fused CG for matrix-free constant-coefficient stencils (PyTorch port).

Counterpart of :mod:`cgx.kernels.fused_cg`: ``stencil_taps`` and
``supports`` (engine convention, used by the whole-solve kernel and the
routing), and ``build_fused``/``fused_stencil_cg``, a thin wrapper over the
two-pass engine (:mod:`cgx_torch.kernels.fused_engine`, kernel K3).  The
one-pass engine (``one_pass=True``, kernel K6) is not ported yet.
"""
from __future__ import annotations

from cgx_torch.kernels.fused_engine import FusedCG
from cgx_torch.solve.cg import CGResult
from cgx_torch.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D

__all__ = ["stencil_taps", "supports", "build_fused", "fused_stencil_cg"]


def stencil_taps(s):
    """``(nx, ny, nz, taps, coeffs)`` in engine convention, or None.

    2-D stencils map to engine dims ``(nx, 1, ny)``.
    """
    if isinstance(s, Stencil3D):
        taps = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
                (1, 0, 0), (-1, 0, 0))
        coeffs = (s.c_center, s.c_z, s.c_z, s.c_y, s.c_y, s.c_x, s.c_x)
        return s.nx, s.ny, s.nz, taps, coeffs
    if isinstance(s, Stencil2D):
        taps = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0))
        coeffs = (s.c_center, s.c_y, s.c_y, s.c_x, s.c_x)
        return s.nx, 1, s.ny, taps, coeffs
    if isinstance(s, GeneralStencil3D):
        if any(abs(dx) > 1 for (dx, _, _) in s.taps):
            return None
        taps = tuple((dx, dy, dz) for (dx, dy, dz) in s.taps)
        return s.nx, s.ny, s.nz, taps, tuple(s.coeffs)
    return None


def supports(s) -> bool:
    """Whether the stencil engines can run this operator."""
    spec = stencil_taps(s)
    if spec is None:
        return False
    nx, ny, nz, _, _ = spec
    return 1 <= nx <= 4096 and ny * nz >= 2


def build_fused(s, dtype, *, one_pass: bool = False) -> FusedCG:
    """The two-pass engine for a stencil operator, with ``dtype`` vectors
    (float32, or bfloat16 for K3's bf16-vector mode)."""
    if one_pass:
        raise NotImplementedError(
            "build_fused: one_pass=True is the one-pass engine, kernel K6, "
            "which is not ported yet (ROADMAP queue B, K6)")
    spec = stencil_taps(s)
    if spec is None or not supports(s):
        raise ValueError("fused_stencil_cg: unsupported operator (need a "
                         "Stencil2D/Stencil3D/GeneralStencil3D with "
                         "|dx| <= 1 taps and nx <= 4096)")
    nx, ny, nz, taps, coeffs = spec
    return FusedCG(nx, ny, nz, taps, dtype=dtype, coeffs=coeffs)


def fused_stencil_cg(s, b, x0=None, *, tol: float = 1e-6, atol: float = 0.0,
                     maxiter: int = 1000, track_history: bool = False,
                     one_pass: bool = False) -> CGResult:
    """Plain CG on a constant-coefficient stencil through the two-pass
    engine in ``b``'s dtype (a bfloat16 ``b`` runs the bf16-vector mode);
    semantics of ``cg_solve(s, b, x0, ..., track_history=...)`` (exact
    sums rounded to fp32)."""
    eng = build_fused(s, b.dtype, one_pass=one_pass)
    return eng.solve(b, x0, tol=tol, atol=atol, maxiter=maxiter,
                     track_history=track_history)

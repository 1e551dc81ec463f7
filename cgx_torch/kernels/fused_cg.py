"""Stencil taps in engine convention (PyTorch port).

Counterpart of :mod:`cgx.kernels.fused_cg` lines 30-61: ``stencil_taps``
and ``supports``, which the whole-solve kernel and the routing use.  The
two-pass engine itself (``fused_stencil_cg``) is not ported yet.
"""
from __future__ import annotations

from cgx_torch.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D

__all__ = ["stencil_taps", "supports"]


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

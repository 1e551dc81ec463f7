"""Distributed fused CG: the two-pass engines K3 and K5 across ranks.

Counterpart of :mod:`cgx.dist.fused`.  The ranks hold consecutive x-plane
blocks of the grid; each runs the fused kernels on its own block in their
cross-rank mode (:mod:`cgx_torch.kernels.fused_engine`): before each
kernel A the boundary planes of p travel to the neighbours' ghost planes,
and the iteration's sums are reduced over the ranks in fp64 after each
kernel, two all-reduces of two doubles (of 2·k for k right-hand sides), as
the JAX package's two ``psum``s.  This is the north star's config-5 shape
(a 10 M-row 3-D Poisson across cards).

Every rank calls the solvers with the global operator and right-hand side
(SPMD) and gets back its own rows of the solution (rows ``rank·nxl·ny·nz``
onward, ``nxl`` planes); :func:`cgx_torch.dist.solve.gather_rows` gathers
them.  An ``nx`` that the number of ranks does not divide is padded to
whole planes per rank with fully decoupled pad rows (``A' = blockdiag(A,
c·I)``, :func:`_pad_to_whole_planes`): a zero-padded right-hand side keeps
every pad row at zero through the whole iteration, so the trajectory is
the unpadded one; a rank's rows then include the pad rows past ``n``
(zeros), and ``unpad_vector`` strips them from the gathered vector.
Padded stencils run as DIA operators (the pad boundary makes the planes
non-constant).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cgx_torch.dist.launch import RowMesh
from cgx_torch.dist.solve import local_rows
from cgx_torch.kernels import fused_cg as _fc
from cgx_torch.kernels.fused_dia_cg import (build_fused_dia, dia_engine_spec,
                                            supports_dia,
                                            wrap_entries_zero_or_none)
from cgx_torch.kernels.fused_engine import FusedCG
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult

__all__ = ["dist_fused_cg", "dist_fused_cg_multi", "dist_fused_supported"]


def dist_fused_supported(a, mesh: RowMesh) -> bool:
    """Whether :func:`dist_fused_cg` can run ``a`` on ``mesh`` (an uneven
    ``nx`` goes through the decoupled pad)."""
    if _fc.stencil_taps(a) is not None and _fc.supports(a):
        return True
    if supports_dia(a):
        return wrap_entries_zero_or_none(a) is True
    return False


def _pad_to_whole_planes(a, nd: int):
    """``(a_pad, n, n_pad)``: a DIA operator on the ``(⌈nx/nd⌉·nd, ny,
    nz)`` grid equal to ``blockdiag(A, c·I)``, or None when ``nd`` divides
    ``nx``.  The pad rows carry only a positive diagonal (``c`` the
    stencil's centre, 1 for DIA) and no coupling in any tap, so with a
    zero-padded right-hand side every CG vector's pad block stays zero and
    every dot and update is the unpadded one."""
    from cgx_torch.sparse.types import DIAMatrix

    spec = _fc.stencil_taps(a)
    if spec is not None:
        nx, ny, nz, taps, coeffs = spec
        data_src = None
        dev, dtype = torch.device("cpu"), torch.float64
    else:
        nx, ny, nz, taps = dia_engine_spec(a)
        coeffs = None
        data_src = a.data.detach().cpu().numpy()
        dev, dtype = a.data.device, a.data.dtype
    nx_pad = -(-nx // nd) * nd
    if nx_pad == nx:
        return None
    lnn = ny * nz
    n, n_pad = nx * lnn, nx_pad * lnn
    r = np.arange(n_pad)
    zc, yc, xc = r % nz, (r // nz) % ny, r // lnn
    taps = [tuple(t) for t in taps]
    c_diag = 1.0 if coeffs is None else (
        coeffs[taps.index((0, 0, 0))] if (0, 0, 0) in taps else 1.0)
    np_dtype = np.float64 if data_src is None else data_src.dtype
    offsets, planes = [], []
    for t, (dx, dy, dk) in enumerate(taps):
        col = np.zeros(n_pad, np_dtype)
        if data_src is not None:
            col[:n] = data_src[t]        # real→pad crossings were outside
        else:                            # the matrix before: already 0
            valid = ((xc < nx) & (xc + dx >= 0) & (xc + dx < nx)
                     & (yc + dy >= 0) & (yc + dy < ny)
                     & (zc + dk >= 0) & (zc + dk < nz))
            col[valid] = coeffs[t]
        if (dx, dy, dk) == (0, 0, 0):
            col[n:] = c_diag
        offsets.append(dx * lnn + dy * nz + dk)
        planes.append(col)
    a_pad = DIAMatrix(data=torch.from_numpy(np.stack(planes)).to(
                          device=dev, dtype=dtype),
                      offsets=tuple(offsets), shape=(n_pad, n_pad),
                      grid=(nx_pad, ny, nz))
    return a_pad, n, n_pad


def _pad_rows(v, n_pad: int):
    """``v`` (global, 1-D or ``(n, k)``) zero-padded to ``n_pad`` rows."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v))
    pad = torch.zeros((n_pad - v.shape[0],) + tuple(v.shape[1:]),
                      dtype=v.dtype, device=v.device)
    return torch.cat([v, pad])


def _pad_and_solve(solver, a, b, mesh, *, x0=None, **kw):
    """The uneven-``nx`` route: pad to whole planes per rank with decoupled
    rows, zero-pad ``b`` (and ``x0``), solve; each rank's rows of the padded
    grid come back (pad rows zero)."""
    a_pad, n, n_pad = _pad_to_whole_planes(a, mesh.size)
    return solver(a_pad, _pad_rows(b, n_pad), mesh,
                  x0=None if x0 is None else _pad_rows(x0, n_pad), **kw)


def _local_dtype(b):
    return b.dtype if isinstance(b, torch.Tensor) else \
        torch.from_numpy(np.asarray(b)[:0]).dtype


def dist_fused_cg(
    a,
    b,
    mesh: RowMesh,
    *,
    x0=None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    jacobi: bool = False,
    track_history: bool = False,
    plane_dtype=None,
) -> CGResult:
    """Row-sharded fused CG; semantics of
    :func:`cgx_torch.solve.cg.cg_solve` (``jacobi=True``: Jacobi PCG, DIA
    operators only).  ``plane_dtype``: the DIA planes in this dtype
    (bf16) with ``b``'s vectors, as
    :func:`~cgx_torch.kernels.fused_dia_cg.fused_dia_cg`.  ``b`` and ``x0``
    are global; the result's ``x`` is this rank's rows (its history and
    sums global)."""
    n = a.shape[0]
    maxiter = int(n if maxiter is None else maxiter)
    nd = mesh.size
    kw = dict(tol=tol, atol=atol, maxiter=maxiter, jacobi=jacobi,
              track_history=track_history, plane_dtype=plane_dtype)
    dtype = _local_dtype(b)
    spec = _fc.stencil_taps(a)
    if spec is not None:
        if jacobi:
            raise ValueError("jacobi=True needs a DIA operator (constant-"
                             "diagonal stencils: Jacobi is an exact "
                             "rescaling, plain CG is the PCG path)")
        if not _fc.supports(a):
            raise ValueError("dist_fused_cg: unsupported stencil")
        nx, ny, nz, taps, coeffs = spec
        if nx % nd:
            return _pad_and_solve(dist_fused_cg, a, b, mesh, x0=x0, **kw)
        nl = nx // nd * ny * nz
        eng = FusedCG(nx // nd, ny, nz, taps, dtype=dtype, coeffs=coeffs,
                      group=mesh)
        return eng.solve(local_rows(b, mesh, nl),
                         None if x0 is None else local_rows(x0, mesh, nl),
                         tol=tol, atol=atol, maxiter=maxiter,
                         track_history=track_history)

    if not supports_dia(a):
        raise ValueError("dist_fused_cg: unsupported operator (need a "
                         "fused-capable stencil or a banded DIA)")
    if wrap_entries_zero_or_none(a) is False:
        raise ValueError("dist_fused_cg: DIA data has nonzero x-plane-"
                         "crossing entries; use dist_cg_solve instead")
    nx, ny, nz = dia_engine_spec(a)[:3]
    if nx % nd:
        return _pad_and_solve(dist_fused_cg, a, b, mesh, x0=x0, **kw)
    eng, e, _ = build_fused_dia(a, dtype, jacobi=jacobi,
                                plane_dtype=plane_dtype, group=mesh)
    nl = eng.n
    b_l = local_rows(b, mesh, nl)
    x0_l = None if x0 is None else local_rows(x0, mesh, nl)
    if e is None:
        return eng.solve(b_l, x0_l, tol=tol, atol=atol, maxiter=maxiter,
                         track_history=track_history)
    res = eng.solve(e * b_l, None if x0_l is None else x0_l * safe_recip(e),
                    tol=tol, atol=atol, maxiter=maxiter,
                    track_history=track_history)
    return dataclasses.replace(res, x=e * res.x)


def dist_fused_cg_multi(
    a,
    b,
    mesh: RowMesh,
    *,
    x0=None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    jacobi: bool = False,
    plane_dtype=None,
) -> CGResult:
    """Row-sharded fused multi-RHS CG (K5): ``b`` global ``(n, k)``; the
    per-column sums of each kernel are reduced in one all-reduce, and the
    ghost planes of all columns travel together.  Semantics of
    :func:`~cgx_torch.kernels.fused_multi.fused_stencil_cg_multi` and
    :func:`~cgx_torch.kernels.fused_multi.fused_dia_cg_multi`; the
    result's ``x`` is this rank's rows ``(rows, k)``."""
    from cgx_torch.kernels.fused_dia_cg import dia_prep, dia_shard_engine
    from cgx_torch.kernels.fused_engine import shard_of
    from cgx_torch.kernels.fused_multi import FusedCGMulti

    if len(b.shape) != 2:
        raise ValueError(f"expected b of shape (n, k), got {tuple(b.shape)}")
    n = a.shape[0]
    maxiter = int(n if maxiter is None else maxiter)
    nd = mesh.size
    kw = dict(tol=tol, atol=atol, maxiter=maxiter, jacobi=jacobi,
              plane_dtype=plane_dtype)
    dtype = _local_dtype(b)
    spec = _fc.stencil_taps(a)
    if spec is not None:
        if jacobi:
            raise ValueError("jacobi=True needs a DIA operator")
        if not _fc.supports(a):
            raise ValueError("dist_fused_cg_multi: unsupported stencil")
        nx, ny, nz, taps, coeffs = spec
        if nx % nd:
            return _pad_and_solve(dist_fused_cg_multi, a, b, mesh, x0=x0,
                                  **kw)
        nl = nx // nd * ny * nz
        eng = FusedCGMulti(nx // nd, ny, nz, taps, dtype=dtype,
                           coeffs=coeffs, group=mesh)
        return eng.solve(local_rows(b, mesh, nl).T,
                         None if x0 is None else local_rows(x0, mesh, nl).T,
                         tol=tol, atol=atol, maxiter=maxiter)

    if not supports_dia(a):
        raise ValueError("dist_fused_cg_multi: unsupported operator")
    if wrap_entries_zero_or_none(a) is False:
        raise ValueError("dist_fused_cg_multi: DIA data has nonzero "
                         "x-plane-crossing entries")
    if dia_engine_spec(a)[0] % nd:
        return _pad_and_solve(dist_fused_cg_multi, a, b, mesh, x0=x0, **kw)
    eng, e_l, _ = dia_shard_engine(dia_prep(a, dtype, jacobi=jacobi), dtype,
                                   shard_of(mesh), plane_dtype=plane_dtype,
                                   device=mesh.device, engine=FusedCGMulti)
    nl = eng.n
    b2 = local_rows(b, mesh, nl).T
    x0_2 = None if x0 is None else local_rows(x0, mesh, nl).T
    if e_l is not None:
        b2 = b2 * e_l[None]
        if x0_2 is not None:
            x0_2 = x0_2 * safe_recip(e_l)[None]
    res = eng.solve(b2, x0_2, tol=tol, atol=atol, maxiter=maxiter)
    if e_l is not None:
        res = dataclasses.replace(res, x=res.x * e_l[:, None])
    return res

"""Fused Jacobi-PCG for variable-coefficient DIA operators (PyTorch port).

Counterpart of :mod:`cgx.kernels.fused_dia_cg`: the host preparation that
both DIA kernels share — the tap decomposition, the layout check, the
symmetry check and the symmetric Jacobi scaling ``Ã = E·A·E`` with
``E = diag(√(d⁻¹))`` — and ``build_fused_dia``/``fused_dia_cg`` over the
two-pass engine (K3).  The scaled hot loop is plain CG; the engine sums
the true residual ``Σ r̃²·w`` with ``w = diag A`` so that the exit test
and the history match ``cg_solve(d, b, preconditioner=JacobiPrecond...)``.

The kernels read plane taps on flat vectors; the JAX package reads them in
a lane layout that drops the x-plane-crossing slots.  The two agree, and
agree with ``spmv(d, ·)``, exactly when those slots hold zeros
(:func:`wrap_entries_zero`), so the kernel routes refuse other data.

The checks run with torch on the data's device and read back one boolean
each (the JAX package copies the whole data to the host with numpy).
Torch data is never traced, so the ``*_or_none`` checks never return
None here; the names stay for callers of both packages.

``plane_dtype=torch.bfloat16`` streams the coefficient planes in bf16 while
the vectors keep ``b``'s dtype; the planes are rounded once, after the
symmetric scaling.  :func:`bf16_plane_speedup` is the JAX package's
footprint model that ``auto_solve(mixed_precision=True)`` routes by.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cgx_torch.kernels.fused_engine import FusedCG
from cgx_torch.ops.blas import safe_recip
from cgx_torch.ops.spmv import shifted
from cgx_torch.solve.cg import CGResult
from cgx_torch.sparse.types import DIAMatrix

__all__ = ["fused_dia_cg", "supports_dia", "dia_pattern_dims",
           "dia_engine_spec", "wrap_entries_zero",
           "wrap_entries_zero_or_none", "data_symmetric_or_none",
           "dia_prep", "build_fused_dia", "bf16_plane_speedup"]

# Offset order (-o3, -o2, -1, 0, 1, o2, o3) in engine tap convention.
_DIA_TAPS = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
             (0, 1, 0), (1, 0, 0))


def dia_pattern_dims(d) -> Optional[Tuple[int, int, int]]:
    """(nx, ny, nz) if ``d`` has the 3-D 7-point offset pattern, else None."""
    if not isinstance(d, DIAMatrix):
        return None
    offs = tuple(d.offsets)
    if len(offs) != 7:
        return None
    o3 = offs[6]
    o2 = offs[5]
    if offs != (-o3, -o2, -1, 0, 1, o2, o3):
        return None
    n = d.shape[0]
    if o2 <= 0 or o3 % o2 or n % o3:
        return None
    return (n // o3, o3 // o2, o2)


def dia_engine_spec(d):
    """``(nx, ny, nz, taps)`` decomposing ``d.offsets`` into engine taps
    ``(dx, dy, dk)`` with ``|dx| ≤ 1``, or ``None``.

    The exact 7-point pattern needs no metadata; any other banded set needs
    ``d.grid``.  Each offset takes its minimal-magnitude decomposition
    ``off = dx·ny·nz + dy·nz + dk`` (``|dk| ≤ nz/2``, ``|dy| ≤ ny/2``).
    """
    if not isinstance(d, DIAMatrix):
        return None
    dims = dia_pattern_dims(d)
    if dims is not None:
        return (*dims, list(_DIA_TAPS))
    if d.grid is None:
        return None
    nx, ny, nz = map(int, d.grid)
    if nx * ny * nz != d.shape[0] or min(nx, ny, nz) < 1:
        return None
    taps = []
    for off in map(int, d.offsets):
        dk = off % nz
        if dk > nz // 2:
            dk -= nz
        rem = (off - dk) // nz
        dy = rem % ny
        if dy > ny // 2:
            dy -= ny
        dx = (rem - dy) // ny
        if abs(dx) > 1 or dx * ny * nz + dy * nz + dk != off:
            return None
        taps.append((dx, dy, dk))
    if len(set(taps)) != len(taps):
        return None
    return nx, ny, nz, taps


def supports_dia(d) -> bool:
    """Whether the DIA engines take this operator's offset pattern (the
    JAX package's bounds, kept so both packages accept the same set)."""
    spec = dia_engine_spec(d)
    if spec is None:
        return False
    nx, ny, nz, taps = spec
    reach = max(abs(dy * nz + dk) for (_, dy, dk) in taps)
    return 1 <= nx <= 4096 and reach <= max(128, ny * nz // 2)


def wrap_entries_zero(d) -> bool:
    """True iff the DIA data is zero at every slot whose tap crosses a
    grid boundary in y or z while its flat column stays inside the matrix
    (offset +1 at (x, ny−1, nz−1), −1 at (x, 0, 0), +nz in the j = ny−1
    plane, −nz in j = 0, …).  The kernels need it: there the generic
    shifted SpMV and the JAX package's lane layout disagree."""
    return wrap_entries_zero_or_none(d)


def wrap_entries_zero_or_none(d):
    """:func:`wrap_entries_zero`, computed on the data's device with one
    boolean read back; False when the offsets do not decompose."""
    spec = dia_engine_spec(d)
    if spec is None:
        return False
    nx, ny, nz, taps = spec
    n = d.shape[0]
    data = d.data
    i = torch.arange(n, device=data.device)
    kz = i % nz
    jy = (i // nz) % ny
    bad = torch.zeros((), dtype=torch.bool, device=data.device)
    for t, ((dx, dy, dk), off) in enumerate(zip(taps, map(int, d.offsets))):
        if dy == 0 and dk == 0:
            continue                    # pure x-plane shift: no wrap
        cross = ((jy + dy < 0) | (jy + dy >= ny)
                 | (kz + dk < 0) | (kz + dk >= nz))
        in_range = (i + off >= 0) & (i + off < n)
        bad = bad | torch.any((torch.abs(data[t]) > 0) & cross & in_range)
    return not bool(bad)


def data_symmetric_or_none(d):
    """True iff the DIA data describes a symmetric matrix: the offset set
    is sign-symmetric and ``data[-off][i] == data[+off][i-off]`` for each
    pair, to ``np.allclose(rtol=1e-6, atol=0)``; one boolean read back."""
    offs = tuple(map(int, d.offsets))
    if any(-off not in offs for off in offs):
        return False
    data = d.data
    ok = torch.ones((), dtype=torch.bool, device=data.device)
    for t_pos, off in enumerate(offs):
        if off <= 0:
            continue
        a = data[offs.index(-off)][off:]
        b = data[t_pos][:-off]
        ok = ok & torch.all(torch.abs(a - b) <= 1e-6 * torch.abs(b))
    return bool(ok)


# bf16_plane_speedup's constants are the TPU's (a v5e's ~100 MB of usable
# VMEM, the 8 effective vector streams and the 2.8 residency flip, from the
# JAX package's measurements); none is measured on the H100.  The card's
# own bf16/fp32 plane ratio is measured by chip_smoke.py (phase X5).
_TPU_VMEM_BYTES = 100 << 20
_TPU_VECTOR_STREAMS = 8.0
_TPU_RESIDENCY_FLIP = 2.8


def bf16_plane_speedup(d, n: int, itemsize: int = 4) -> float:
    """Predicted per-iteration speedup of bf16 coefficient planes over
    fp32 planes for this DIA operator: the JAX package's footprint model
    (:func:`cgx.kernels.fused_dia_cg.bf16_plane_speedup`), verbatim, with
    its TPU constants.

    * Residency flip: the fp32 planes and 5 carried vectors spill the
      TPU's VMEM but the bf16 set fits: 2.8.
    * Streaming ratio otherwise: halving the planes saves ``f/2`` of the
      traffic, ``f = planes/(planes + 8)``.

    Symmetric data halves the plane streams.
    """
    k = len(d.offsets)
    n_planes = k - 1            # unit diagonal after symmetric scaling
    if n_planes <= 0:
        return 1.0
    if data_symmetric_or_none(d) is True:
        n_planes //= 2
    f = n_planes / (n_planes + _TPU_VECTOR_STREAMS)
    ratio = 1.0 / (1.0 - f / 2.0)
    vectors = 5 * n * itemsize

    def working_set(plane_isz):
        return n_planes * n * plane_isz + vectors

    if working_set(itemsize) > _TPU_VMEM_BYTES >= working_set(2):
        return _TPU_RESIDENCY_FLIP
    return ratio


def _scaled_planes(d, e: torch.Tensor, dtype) -> torch.Tensor:
    """Symmetrically scaled coefficient planes: data'[t][i] =
    e[i]·data[t][i]·e[i+off] (row-aligned convention)."""
    return torch.stack([e * d.data[t].to(dtype) * shifted(e, off)
                        for t, off in enumerate(d.offsets)])


def dia_prep(d, dtype, *, jacobi: bool = True, inv_diag=None,
             allow_sym: bool = True,
             assume_symmetric: Optional[bool] = None):
    """Engine-independent preparation of a DIA operator:
    ``(nx, ny, nz, taps, coeffs, planes, e, weight, sym)``, on the data's
    device.

    ``e = √(inv_diag)`` is the Jacobi scaling vector (None when not
    preconditioning); the caller solves ``Ã y = e·b`` and recovers
    ``x = e·y``.  When the data is symmetric ``sym=True``: ``taps`` keeps
    the diagonal plus one tap per ``±off`` pair.  When ``diag·inv_diag``
    is 1 the scaled diagonal is kept as the constant tap 1.0 instead of a
    plane.  ``assume_symmetric`` overrides the symmetry check (``False``
    forces the all-planes operator).
    """
    spec = dia_engine_spec(d)
    if spec is None or not supports_dia(d):
        raise ValueError(
            "fused_dia_cg: offsets do not decompose into |dx| <= 1 grid "
            "taps (set DIAMatrix.grid for non-7-point patterns) or the "
            "grid is out of range")
    nx, ny, nz, all_taps = spec
    offs = tuple(map(int, d.offsets))
    diag_idx = offs.index(0) if 0 in offs else None
    dev = d.data.device
    if inv_diag is not None:
        invd = torch.as_tensor(inv_diag, dtype=dtype, device=dev)
    elif jacobi:
        if diag_idx is None:
            raise ValueError("jacobi=True needs a stored main diagonal")
        invd = safe_recip(d.data[diag_idx].to(dtype))
    else:
        invd = None

    if assume_symmetric is None:
        sym = bool(allow_sym and data_symmetric_or_none(d) is True)
    else:
        sym = bool(allow_sym and assume_symmetric)
        if sym and any(-o not in offs for o in offs):
            raise ValueError("assume_symmetric=True but the offset set "
                             "is not sign-symmetric")

    unit_diag = False
    if invd is None:
        planes_full = [d.data[t].to(dtype) for t in range(len(offs))]
        e = weight = None
    else:
        e = torch.sqrt(invd)
        planes_full = list(_scaled_planes(d, e, dtype))
        weight = safe_recip(invd)              # = diag(A): the true ‖r‖²
        if diag_idx is not None:
            diag64 = d.data[diag_idx].to(torch.float64)
            inv64 = (torch.as_tensor(inv_diag, device=dev).to(torch.float64)
                     if inv_diag is not None else safe_recip(diag64))
            unit_diag = torch.allclose(diag64 * inv64,
                                       torch.ones_like(diag64),
                                       rtol=1e-6, atol=1e-6)

    if sym:
        order = ([diag_idx] if diag_idx is not None else []) + \
            [t for t, off in enumerate(offs) if off > 0]
    else:
        order = list(range(len(offs)))
    taps, coeffs, planes_sel = [], [], []
    for t in order:
        taps.append(tuple(all_taps[t]))
        if t == diag_idx and unit_diag:
            coeffs.append(1.0)
        else:
            coeffs.append(None)
            planes_sel.append(planes_full[t])
    planes = (torch.stack(planes_sel) if planes_sel
              else torch.zeros((0, d.shape[0]), dtype=dtype, device=dev))
    return (nx, ny, nz, tuple(taps), tuple(coeffs), planes, e, weight, sym)


def build_fused_dia(d, dtype, *, jacobi: bool = True, inv_diag=None,
                    allow_sym: bool = True, plane_dtype=None,
                    assume_symmetric: Optional[bool] = None):
    """``(engine, e, planes)`` for a DIA operator (see :func:`dia_prep`).
    ``plane_dtype``: the engine holds the scaled planes in this dtype (they
    are rounded after the scaling) while the vectors keep ``dtype``; the
    returned ``planes`` are ``dtype``'s.  The JAX package's
    ``n_shards``/``axis_name`` (distribution) and ``interpret`` have no
    counterpart here."""
    nx, ny, nz, taps, coeffs, planes, e, weight, sym = dia_prep(
        d, dtype, jacobi=jacobi, inv_diag=inv_diag, allow_sym=allow_sym,
        assume_symmetric=assume_symmetric)
    eng = FusedCG(nx, ny, nz, taps, dtype=dtype, coeffs=coeffs,
                  planes=planes, weight=weight, sym=sym,
                  plane_dtype=plane_dtype)
    return eng, e, planes


def fused_dia_cg(d, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                 atol: float = 0.0, maxiter: int = 1000,
                 jacobi: bool = True, inv_diag=None,
                 track_history: bool = False, plane_dtype=None,
                 assume_symmetric: Optional[bool] = None) -> CGResult:
    """Jacobi-PCG (plain CG with ``jacobi=False``) on a DIA operator
    through the two-pass engine; matches ``cg_solve(d, b,
    preconditioner=JacobiPrecond.from_matrix(d))`` to fp32 roundoff.
    ``inv_diag`` overrides the operator's ``1/diag(A)``, so a caller's
    :class:`~cgx_torch.solve.precond.JacobiPrecond` keeps its trajectory.
    ``plane_dtype=torch.bfloat16`` streams bf16 planes: the recurrence
    converges to the solution of the rounded operator, whose true residual
    plateaus near the planes' rounding (``ir_cg_solve`` removes that).
    """
    if wrap_entries_zero_or_none(d) is False:
        raise ValueError(
            "fused_dia_cg: DIA data has nonzero entries at x-plane-"
            "crossing slots (offsets ±1 at the j/k-extremes, ±nz in the "
            "j-boundary planes); the kernels would compute another "
            "operator — use cg_solve instead")
    eng, e, _ = build_fused_dia(d, b.dtype, jacobi=jacobi, inv_diag=inv_diag,
                                plane_dtype=plane_dtype,
                                assume_symmetric=assume_symmetric)
    if e is None:
        return eng.solve(b, x0, tol=tol, atol=atol, maxiter=maxiter,
                         track_history=track_history)
    x0_s = None if x0 is None else x0 * safe_recip(e)
    res = eng.solve(e * b, x0_s, tol=tol, atol=atol, maxiter=maxiter,
                    track_history=track_history)
    return dataclasses.replace(res, x=e * res.x)

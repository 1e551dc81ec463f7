"""K2: whole-solve CG in one launch — CUDA kernel + plain version.

Replaces the Pallas kernel :mod:`cgx.kernels.fused_resident` (``_kernel``),
which runs the whole PCG loop in one ``pallas_call`` with x, r, p resident
in VMEM.  The CUDA source (``cgx_torch/csrc/resident_cg.cu``) is a
cooperative persistent kernel: one launch per solve, the loop, α, β and
the convergence test on the device, three grid-wide barriers per iteration
and no host synchronisation inside the solve.  See the source note for
the design.  It has the Pallas kernel's two modes:

* constant taps (a stencil; ``resident_cg_launches`` counts them);
* planes/weight (``planes`` for the ``None`` coefficient slots, optional
  ``weight`` and ``sym``): the Jacobi-scaled DIA operator of
  :func:`resident_dia_cg` (``resident_dia_launches``).

On the H100 the vectors live in device memory, so no VMEM budget applies:
:func:`resident_supported` checks only the operator's form and that the
row indices fit in int32.  The JAX package's ``VMEM_BUDGET`` and
``resident_vmem_bytes`` are not ported, nor is ``plane_dtype`` (mixed
precision, ROADMAP queue A item 11).

The port works on flat vectors: there is no halo layout, so resume state
is the flat ``(x, r, p, rz, rw)``.  :func:`resident_cg_call` launches the
kernel for CUDA tensors and takes the plain PyTorch version,
:func:`resident_cg_reference`, only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from cgx_torch.kernels.fused_cg import stencil_taps, supports
from cgx_torch.kernels.fused_engine import (plane_tap_arrays, tap_matvec,
                                            threshold)
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult

__all__ = ["resident_cg_call", "resident_cg", "resident_cg_reference",
           "resident_supported", "resident_stencil_cg", "resident_dia_cg",
           "resident_cg_launches", "resident_dia_launches"]

# Kernel launches so far, by mode (a run resets them to show which kernels
# it used).
resident_cg_launches = 0
resident_dia_launches = 0


def _sums(r: torch.Tensor, weight):
    """``(Σ r², Σ r²·w)`` in fp32, as the kernel sums them (``Σ r²``
    twice when unweighted)."""
    r32 = r.to(torch.float32)
    rsq = r32 * r32
    s = torch.sum(rsq)
    if weight is None:
        return s, s
    return s, torch.sum(rsq * weight.to(torch.float32))


def resident_cg_reference(spec, b: torch.Tensor, x0=None, *, planes=None,
                          weight=None, sym: bool = False, tol: float = 1e-6,
                          atol: float = 0.0, maxiter: int = 1000,
                          resume=None):
    """Plain PyTorch version of the kernel: the same textbook recurrence
    (α = rz/pq, β = rz'/rz, fp32 sums) and the same exit test
    (``k < maxiter`` and ``rw > tol_sq``, with ``rw = Σ r²·w`` when
    ``weight`` is given), as a Python loop.

    ``spec`` is ``(nx, ny, nz, taps, coeffs)`` (from
    :func:`~cgx_torch.kernels.fused_cg.stencil_taps`, or from
    :func:`~cgx_torch.kernels.fused_dia_cg.dia_prep` with ``planes`` for
    its ``None`` slots).  Returns ``(x, r, p, k, rz, tol_sq)`` like
    :func:`resident_cg_call`.
    """
    nx, ny, nz, taps, coeffs = spec

    def matvec(v):
        return tap_matvec(nx, ny, nz, taps, coeffs, planes, sym, v)

    dtype = b.dtype
    tol_sq = threshold(b, tol, atol, weight)
    if resume is None:
        x = torch.zeros_like(b) if x0 is None else x0.to(dtype).clone()
        r = b - matvec(x)
        p = r
        rz, rw = _sums(r, weight)
    else:
        x, r, p, rz, rw = resume
        rz = torch.as_tensor(rz, dtype=torch.float32, device=b.device)
        rw = torch.as_tensor(rw, dtype=torch.float32, device=b.device)
    k = 0
    while k < maxiter and bool(rw > tol_sq):
        q = matvec(p)
        pq = torch.sum(p.to(torch.float32) * q.to(torch.float32))
        alpha = (rz / pq).to(dtype)
        x = x + alpha * p
        r = r - alpha * q
        rz_new, rw = _sums(r, weight)
        beta = (rz_new / rz).to(dtype)
        p = r + beta * p
        rz = rz_new
        k += 1
    return (x, r, p, torch.tensor(k, dtype=torch.int32, device=b.device),
            torch.stack([rz, rw]), tol_sq)


def _resident_cuda(spec, b, x0, *, planes, weight, sym, tol, atol, maxiter,
                   resume):
    global resident_cg_launches, resident_dia_launches
    from cgx_torch.kernels import _build
    from cgx_torch.kernels.stencil import check_cuda_vector, tap_arrays

    nx, ny, nz, taps, coeffs = spec
    n = nx * ny * nz
    check_cuda_vector(b, n, "resident_cg")
    if len(taps) > 27:
        raise ValueError("resident_cg: at most 27 taps")
    planes_mode = planes is not None or weight is not None
    n_planes = sum(1 for c in coeffs if c is None)
    if n_planes and (planes is None or tuple(planes.shape) != (n_planes, n)):
        raise ValueError(f"resident_cg: need {n_planes} planes of {n} rows")
    for t, name in ((planes, "planes"), (weight, "weight")):
        if t is not None and (t.device != b.device or t.dtype != b.dtype
                              or not t.is_contiguous()):
            raise ValueError(f"resident_cg: {name} must be a contiguous "
                             f"float32 tensor on {b.device}")
    dev = b.device
    tol_sq = threshold(b, tol, atol, weight)
    if resume is None:
        x = torch.zeros_like(b)
        if x0 is not None:
            check_cuda_vector(x0, n, "resident_cg x0")
            x.copy_(x0)
        r = b.clone()
        p = torch.empty_like(b)
        flag, rz_in = 0, None
    else:
        xs, rs, ps, rz_s, rw_s = resume
        for v, name in ((xs, "x"), (rs, "r"), (ps, "p")):
            check_cuda_vector(v, n, f"resident_cg resume {name}")
        x, r, p = xs.clone(), rs.clone(), ps.clone()
        flag = 1
        rz_in = torch.stack([
            torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
            for v in (rz_s, rw_s)])
    q = torch.empty_like(b)
    k_out = torch.empty(1, dtype=torch.int32, device=dev)
    rz_out = torch.empty(2, dtype=torch.float32, device=dev)
    lib = _build.library()
    maxit = min(int(maxiter), 2 ** 31 - 1)
    rz_ptr = None if rz_in is None else rz_in.data_ptr()
    with torch.cuda.device(dev):
        grid = ctypes.c_int(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if not planes_mode:
            _build.check(lib.cgx_resident_cg_grid(dev.index, len(taps),
                                                  ctypes.byref(grid)),
                         "resident_cg occupancy query")
            partials = torch.empty(2 * grid.value, dtype=torch.float32,
                                   device=dev)
            tap_c, coef_c = tap_arrays(taps, coeffs)
            rc = lib.cgx_resident_cg(
                x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
                partials.data_ptr(), grid.value, nx, ny, nz, len(taps),
                tap_c, coef_c, tol_sq.data_ptr(), maxit, flag, rz_ptr,
                k_out.data_ptr(), rz_out.data_ptr(), stream)
        else:
            _build.check(lib.cgx_resident_dia_cg_grid(
                dev.index, len(taps), int(sym), ctypes.byref(grid)),
                "resident_cg planes-mode occupancy query")
            partials = torch.empty(3 * grid.value, dtype=torch.float32,
                                   device=dev)
            tap_c, coef_c, plane_c = plane_tap_arrays(taps, coeffs)
            rc = lib.cgx_resident_dia_cg(
                x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
                partials.data_ptr(), grid.value, nx, ny, nz, len(taps),
                tap_c, coef_c, plane_c,
                None if planes is None else planes.data_ptr(),
                None if weight is None else weight.data_ptr(), int(sym),
                tol_sq.data_ptr(), maxit, flag, rz_ptr, k_out.data_ptr(),
                rz_out.data_ptr(), stream)
    _build.check(rc, "resident_cg cooperative launch")
    if planes_mode:
        resident_dia_launches += 1
    else:
        resident_cg_launches += 1
    return x, r, p, k_out[0], rz_out, tol_sq


def resident_cg_call(spec, b: torch.Tensor, x0=None, *, planes=None,
                     weight=None, sym: bool = False, tol: float = 1e-6,
                     atol: float = 0.0, maxiter: int = 1000, resume=None):
    """Low-level whole-solve call; returns the carried state
    ``(x, r, p, k, rz, tol_sq)`` with ``rz = (rz, rw)`` so chunked callers
    can feed it back via ``resume``.

    ``planes``: ``(n_planes, n)`` coefficient planes for the ``None``
    slots of ``spec``'s coefficients, in tap order; ``weight``: per-row
    weights of the exit test; ``sym``: apply each plane also at its mirror
    tap.  ``resume``: ``(x, r, p, rz, rw)`` — skips the fresh init
    (r₀ = b − A·x₀, p₀ = r₀) and continues the exact recurrence.  ``b``
    still supplies the convergence threshold.  The caller's ``b``, ``x0``
    and resume tensors are never written.
    """
    if b.device.type == "cpu":
        return resident_cg_reference(spec, b, x0, planes=planes,
                                     weight=weight, sym=sym, tol=tol,
                                     atol=atol, maxiter=maxiter,
                                     resume=resume)
    if b.device.type != "cuda":
        raise ValueError(f"resident_cg: unsupported device {b.device}")
    return _resident_cuda(spec, b, x0, planes=planes, weight=weight, sym=sym,
                          tol=tol, atol=atol, maxiter=maxiter, resume=resume)


def resident_cg(spec, b: torch.Tensor, x0=None, *, planes=None,
                weight=None, sym: bool = False, tol: float = 1e-6,
                atol: float = 0.0, maxiter: int = 1000) -> CGResult:
    """Run the whole-solve kernel; ``b``/``x0``/``weight`` flat ``(n,)``
    (the caller applies any diagonal scaling)."""
    x, _, _, k, rz, tol_sq = resident_cg_call(
        spec, b, x0, planes=planes, weight=weight, sym=sym, tol=tol,
        atol=atol, maxiter=maxiter)
    return CGResult(x=x, iterations=k, residual_norm_sq=rz[1],
                    converged=rz[1] <= tol_sq,
                    history=torch.zeros(0, device=b.device))


def resident_supported(a, dtype=torch.float32) -> bool:
    """Whether :func:`resident_stencil_cg` / :func:`resident_dia_cg` can
    run this operator on the card: fp32, at most 27 kept taps, fewer than
    2³¹ rows, and either a supported constant-coefficient stencil or a
    DIA operator the engines take whose wrap entries are zero."""
    from cgx_torch.kernels.fused_dia_cg import (data_symmetric_or_none,
                                                dia_engine_spec, supports_dia,
                                                wrap_entries_zero_or_none)

    if dtype != torch.float32:
        return False
    spec = stencil_taps(a)
    if spec is not None:
        nx, ny, nz, taps, _ = spec
        return supports(a) and len(taps) <= 27 and nx * ny * nz < 2 ** 31
    if supports_dia(a) and wrap_entries_zero_or_none(a) is True:
        nx, ny, nz, taps = dia_engine_spec(a)
        if len(taps) > 27 and data_symmetric_or_none(a) is True:
            taps = [t for t, off in zip(taps, a.offsets) if off >= 0]
        return len(taps) <= 27 and nx * ny * nz < 2 ** 31
    return False


def resident_stencil_cg(s, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                        atol: float = 0.0,
                        maxiter: int = 1000) -> CGResult:
    """Whole-solve CG on a constant-coefficient stencil; semantics of
    :func:`cgx_torch.solve.cg.cg_solve` (no history)."""
    spec = stencil_taps(s)
    if spec is None or not supports(s):
        raise ValueError("resident_stencil_cg: unsupported operator")
    return resident_cg(spec, b, x0, tol=tol, atol=atol, maxiter=int(maxiter))


def resident_dia_cg(d, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                    atol: float = 0.0, maxiter: int = 1000,
                    jacobi: bool = True, inv_diag=None,
                    plane_dtype=None) -> CGResult:
    """Whole-solve Jacobi-PCG (plain CG with ``jacobi=False``) on a DIA
    operator; semantics of :func:`cgx_torch.kernels.fused_dia_cg.
    fused_dia_cg` without history."""
    from cgx_torch.kernels.fused_dia_cg import (_no_plane_dtype, dia_prep,
                                                wrap_entries_zero_or_none)

    _no_plane_dtype(plane_dtype)
    if wrap_entries_zero_or_none(d) is False:
        raise ValueError(
            "resident_dia_cg: DIA data has nonzero x-plane-crossing "
            "entries — use cg_solve instead")
    nx, ny, nz, taps, coeffs, planes, e, weight, sym = dia_prep(
        d, b.dtype, jacobi=jacobi, inv_diag=inv_diag)
    b_s, x0_s = b, x0
    if e is not None:
        b_s = e * b
        x0_s = None if x0 is None else x0 * safe_recip(e)
    res = resident_cg((nx, ny, nz, taps, coeffs), b_s, x0_s, planes=planes,
                      weight=weight, sym=sym, tol=tol, atol=atol,
                      maxiter=int(maxiter))
    if e is not None:
        res = dataclasses.replace(res, x=e * res.x)
    return res

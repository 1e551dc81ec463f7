"""K2: whole-solve CG in one launch — CUDA kernel + plain version.

Replaces the Pallas kernel :mod:`cgx.kernels.fused_resident` (``_kernel``,
constant-tap mode), which runs the whole PCG loop in one ``pallas_call``
with x, r, p resident in VMEM.  The CUDA source
(``cgx_torch/csrc/resident_cg.cu``) is a cooperative persistent kernel:
one launch per solve, the loop, α, β and the convergence test on the
device, three grid-wide barriers per iteration and no host synchronisation
inside the solve.  See the source note for the design.

On the H100 the vectors live in device memory, so no VMEM budget applies:
:func:`resident_supported` checks only the operator's form and that the
row indices fit in int32.  The JAX package's ``VMEM_BUDGET`` and
``resident_vmem_bytes`` are not ported.  The planes/weight mode
(``resident_dia_cg``) is not ported yet.

The port works on flat vectors: there is no halo layout, so resume state
is the flat ``(x, r, p, rz, rw)``.  :func:`resident_cg_call` launches the
kernel for CUDA tensors and takes the plain PyTorch version,
:func:`resident_cg_reference`, only for CPU tensors.
``resident_cg_launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from cgx_torch.kernels.fused_cg import stencil_taps, supports
from cgx_torch.solve.cg import CGResult
from cgx_torch.sparse.stencil import GeneralStencil3D

__all__ = ["resident_cg_call", "resident_cg", "resident_cg_reference",
           "resident_supported", "resident_stencil_cg",
           "resident_cg_launches"]

# Kernel launches so far (a run resets it to show which kernels it used).
resident_cg_launches = 0


def _tol_sq(b: torch.Tensor, tol: float, atol: float) -> torch.Tensor:
    """``max(tol²·‖b‖², atol²)`` in fp32 on ``b``'s device (no host sync)."""
    bb = torch.sum(b.to(torch.float32) ** 2)
    tol2 = torch.tensor(tol, dtype=torch.float32).square().item()
    atol2 = torch.tensor(atol, dtype=torch.float32).square().item()
    return torch.clamp(bb * tol2, min=atol2)


def _sum_sq(v: torch.Tensor) -> torch.Tensor:
    v32 = v.to(torch.float32)
    return torch.sum(v32 * v32)


def resident_cg_reference(spec, b: torch.Tensor, x0=None, *,
                          tol: float = 1e-6, atol: float = 0.0,
                          maxiter: int = 1000, resume=None):
    """Plain PyTorch version of the kernel: the same textbook recurrence
    (α = rz/pq, β = rz'/rz, fp32 sums) and the same exit test
    (``k < maxiter`` and ``rw > tol_sq``), as a Python loop.

    ``spec`` is ``(nx, ny, nz, taps, coeffs)`` from
    :func:`~cgx_torch.kernels.fused_cg.stencil_taps`.  Returns
    ``(x, r, p, k, rz, tol_sq)`` like :func:`resident_cg_call`.
    """
    nx, ny, nz, taps, coeffs = spec
    matvec = GeneralStencil3D(nx=nx, ny=ny, nz=nz, taps=tuple(taps),
                              coeffs=tuple(coeffs)).matvec
    dtype = b.dtype
    tol_sq = _tol_sq(b, tol, atol)
    if resume is None:
        x = torch.zeros_like(b) if x0 is None else x0.to(dtype).clone()
        r = b - matvec(x)
        p = r
        rz = _sum_sq(r)
        rw = rz
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
        rz_new = _sum_sq(r)
        beta = (rz_new / rz).to(dtype)
        p = r + beta * p
        rz = rw = rz_new
        k += 1
    return (x, r, p, torch.tensor(k, dtype=torch.int32, device=b.device),
            torch.stack([rz, rw]), tol_sq)


def _resident_cuda(spec, b, x0, *, tol, atol, maxiter, resume):
    global resident_cg_launches
    from cgx_torch.kernels import _build
    from cgx_torch.kernels.stencil import check_cuda_vector, tap_arrays

    nx, ny, nz, taps, coeffs = spec
    n = nx * ny * nz
    check_cuda_vector(b, n, "resident_cg")
    if len(taps) > 27:
        raise ValueError("resident_cg: at most 27 taps")
    dev = b.device
    tol_sq = _tol_sq(b, tol, atol)
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
    tap_c, coef_c = tap_arrays(taps, coeffs)
    lib = _build.library()
    with torch.cuda.device(dev):
        grid = ctypes.c_int(0)
        _build.check(lib.cgx_resident_cg_grid(dev.index, len(taps),
                                              ctypes.byref(grid)),
                     "resident_cg occupancy query")
        partials = torch.empty(2 * grid.value, dtype=torch.float32,
                               device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cgx_resident_cg(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
            partials.data_ptr(), grid.value, nx, ny, nz, len(taps), tap_c,
            coef_c, tol_sq.data_ptr(), min(int(maxiter), 2 ** 31 - 1), flag,
            None if rz_in is None else rz_in.data_ptr(), k_out.data_ptr(),
            rz_out.data_ptr(), stream)
    _build.check(rc, "resident_cg cooperative launch")
    resident_cg_launches += 1
    return x, r, p, k_out[0], rz_out, tol_sq


def resident_cg_call(spec, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                     atol: float = 0.0, maxiter: int = 1000, resume=None):
    """Low-level whole-solve call; returns the carried state
    ``(x, r, p, k, rz, tol_sq)`` with ``rz = (rz, rw)`` so chunked callers
    can feed it back via ``resume``.

    ``resume``: ``(x, r, p, rz, rw)`` — skips the fresh init
    (r₀ = b − A·x₀, p₀ = r₀) and continues the exact recurrence.  ``b``
    still supplies the convergence threshold's ‖b‖².  The caller's ``b``,
    ``x0`` and resume tensors are never written.
    """
    if b.device.type == "cpu":
        return resident_cg_reference(spec, b, x0, tol=tol, atol=atol,
                                     maxiter=maxiter, resume=resume)
    if b.device.type != "cuda":
        raise ValueError(f"resident_cg: unsupported device {b.device}")
    return _resident_cuda(spec, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                          resume=resume)


def resident_cg(spec, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                atol: float = 0.0, maxiter: int = 1000) -> CGResult:
    """Run the whole-solve kernel; ``b``/``x0`` flat ``(n,)``."""
    x, _, _, k, rz, tol_sq = resident_cg_call(spec, b, x0, tol=tol,
                                              atol=atol, maxiter=maxiter)
    return CGResult(x=x, iterations=k, residual_norm_sq=rz[1],
                    converged=rz[1] <= tol_sq,
                    history=torch.zeros(0, device=b.device))


def resident_supported(a, dtype=torch.float32) -> bool:
    """Whether :func:`resident_stencil_cg` can run this operator on the
    card: a supported constant-coefficient stencil, fp32, at most 27 taps
    and fewer than 2³¹ rows."""
    spec = stencil_taps(a)
    if spec is None or not supports(a) or dtype != torch.float32:
        return False
    nx, ny, nz, taps, _ = spec
    return len(taps) <= 27 and nx * ny * nz < 2 ** 31


def resident_stencil_cg(s, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                        atol: float = 0.0,
                        maxiter: int = 1000) -> CGResult:
    """Whole-solve CG on a constant-coefficient stencil; semantics of
    :func:`cgx_torch.solve.cg.cg_solve` (no history)."""
    spec = stencil_taps(s)
    if spec is None or not supports(s):
        raise ValueError("resident_stencil_cg: unsupported operator")
    return resident_cg(spec, b, x0, tol=tol, atol=atol, maxiter=int(maxiter))

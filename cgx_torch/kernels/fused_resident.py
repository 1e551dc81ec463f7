"""K2: whole-solve CG in one launch — CUDA kernel + plain version.

Replaces the Pallas kernel :mod:`cgx.kernels.fused_resident` (``_kernel``),
which runs the whole PCG loop in one ``pallas_call`` with x, r, p resident
in VMEM.  The CUDA source (``cgx_torch/csrc/resident_cg.cu``) is a
cooperative persistent kernel: one launch per solve, the loop, α, β and
the convergence test on the device, two grid-wide barriers per iteration
and no host synchronisation inside the solve.  An iteration forms
``p = r + β·p`` inside the next one's product and ping-pongs p between two
buffers (:func:`pingpong_step`; :func:`two_phase_reference` is the same
dataflow in PyTorch); see the source note for the design.  It has the
Pallas kernel's two modes:

* constant taps (a stencil; ``resident_cg_launches`` counts them);
* planes/weight (``planes`` for the ``None`` coefficient slots, optional
  ``weight`` and ``sym``): the Jacobi-scaled DIA operator of
  :func:`resident_dia_cg` (``resident_dia_launches``).  The planes may be
  float32 or bfloat16 (``plane_dtype``; the vectors stay float32): the
  kernel widens each plane value as it loads it, so the bf16 mode equals
  the float32 mode on the planes rounded through bf16, bit for bit, at one
  grid (``grid=``; :func:`resident_grid` gives each instance's own).

On the H100 the vectors live in device memory, so no VMEM budget applies:
:func:`resident_supported` checks only the operator's form and that the
row indices fit in int32.  The JAX package's ``VMEM_BUDGET`` and
``resident_vmem_bytes`` are not ported.

The port works on flat vectors: there is no halo layout, so resume state
is the flat ``(x, r, p, rz, rw)``.  :func:`resident_cg_call` launches the
kernel for CUDA tensors and takes the plain PyTorch version,
:func:`two_phase_reference`, only for CPU tensors; it equals the textbook
recurrence :func:`resident_cg_reference` bit for bit.

The three-phase kernels of the first design stay in the CUDA source as the
same-run "before" (:func:`_three_phase_call`, CUDA only, counted nowhere).
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
from cgx_torch.utils.profiling import (ENGINE, PREP, RESULT, annotate,
                                       host_read)

__all__ = ["resident_cg_call", "resident_cg", "resident_cg_reference",
           "two_phase_reference", "pingpong_step", "pingpong_exit",
           "iteration_streams", "default_grid", "L2_RESIDENT_BLOCKS_PER_SM",
           "resident_supported", "resident_stencil_cg", "resident_dia_cg",
           "resident_grid", "resident_cg_launches", "resident_dia_launches",
           "resident_dia_bf16_launches"]

# Kernel launches so far, by mode (a run resets them to show which kernels
# it used); resident_dia_bf16_launches counts the bf16-plane launches among
# the planes mode's.
resident_cg_launches = 0
resident_dia_launches = 0
resident_dia_bf16_launches = 0


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
    ``weight`` is given), as a Python loop.  bf16 ``planes`` are widened
    to ``b``'s dtype.

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


def pingpong_step(k: int, resume: bool = False):
    """The p buffers of the two-phase kernel's iteration k: ``(read,
    write)``.  Buffer 0 is the state's ``p`` (the one the wrapper returns),
    buffer 1 the second.  Iteration k forms ``p_new`` from buffer ``read``
    and writes it to buffer ``write``; iteration 0 takes ``read`` as it
    stands (``"r"`` in a fresh solve, the given p on resume), the later
    ones form ``r + β·p_old``.  Mirrors ``p_buffer`` in
    ``csrc/resident_cg.cu``."""
    if k == 0:
        return (0 if resume else "r"), 1
    return k & 1, (k + 1) & 1


def pingpong_exit(iterations: int, resume: bool = False):
    """The buffer the kernel forms ``p = r + β·p_old`` from into buffer 0
    after ``iterations`` iterations: ``"r"`` (p = r) or ``None`` (p stays
    as given) after none.  Mirrors ``materialise_p``."""
    if iterations == 0:
        return None if resume else "r"
    return iterations & 1


def iteration_streams(n_planes: float = 0, weighted: bool = False,
                      three_phase: bool = False) -> float:
    """Vector streams of n floats one iteration moves in device memory,
    neighbour and mirror reads counted as cache hits: 10 + planes + w in
    the two-phase kernel (r, p_old in and p_new, q out; x, p_new, r, q in
    and x, r out), 11 + planes + w in the three-phase one.  A bf16 plane
    counts half."""
    return (11 if three_phase else 10) + n_planes + int(weighted)


def two_phase_reference(spec, b: torch.Tensor, x0=None, *, planes=None,
                        weight=None, sym: bool = False, tol: float = 1e-6,
                        atol: float = 0.0, maxiter: int = 1000,
                        resume=None):
    """The two-phase kernel's dataflow in plain PyTorch: p in the two
    buffers of :func:`pingpong_step`, ``p_new = r + β·p_old`` formed at the
    start of an iteration, q stored in phase 1' and read in phase 2', and
    ``p`` formed into buffer 0 at the exit.  Each value
    is the textbook recurrence's, so it equals
    :func:`resident_cg_reference` bit for bit; arguments and result are
    that function's."""
    nx, ny, nz, taps, coeffs = spec

    def matvec(v):
        return tap_matvec(nx, ny, nz, taps, coeffs, planes, sym, v)

    dtype = b.dtype
    with annotate(PREP):
        tol_sq = threshold(b, tol, atol, weight)
        if resume is None:
            x = torch.zeros_like(b) if x0 is None else x0.to(dtype).clone()
            r = b - matvec(x)
            bufs = [None, None]
            rz, rw = _sums(r, weight)
        else:
            x, r, p_in, rz, rw = resume
            bufs = [p_in, None]
            rz = torch.as_tensor(rz, dtype=torch.float32, device=b.device)
            rw = torch.as_tensor(rw, dtype=torch.float32, device=b.device)
    with annotate(ENGINE):
        beta = None
        k = 0
        while k < maxiter and host_read(rw > tol_sq, bool):
            read, write = pingpong_step(k, resume is not None)
            p_old = r if read == "r" else bufs[read]
            p_new = p_old if k == 0 else r + beta * p_old
            bufs[write] = p_new
            q = matvec(p_new)
            pq = torch.sum(p_new.to(torch.float32) * q.to(torch.float32))
            alpha = (rz / pq).to(dtype)
            x = x + alpha * p_new
            r = r - alpha * q
            rz_new, rw = _sums(r, weight)
            beta = (rz_new / rz).to(dtype)
            rz = rz_new
            k += 1
        src = pingpong_exit(k, resume is not None)
        if src == "r":
            bufs[0] = r
        elif src is not None:
            bufs[0] = r + beta * bufs[src]
        return (x, r, bufs[0], torch.tensor(k, dtype=torch.int32,
                                            device=b.device),
                torch.stack([rz, rw]), tol_sq)


def resident_grid(spec, device, *, planes=None, weight=None,
                  sym: bool = False) -> int:
    """The cooperative grid (blocks) of the kernel instance for this
    operator and plane dtype: as many as fit on the card at once, the
    most a solve can launch (:func:`default_grid` picks its default)."""
    return _grid(spec, device, planes, weight, sym, _TWO_PHASE)


# The kernels of csrc/resident_cg.cu (its `variant`): the two-phase kernel,
# and the three-phase one kept as the same-run "before".
_TWO_PHASE, _THREE_PHASE = 0, 1

# Blocks an SM of the constant mode's default grid when its five vectors
# (x, r, both p buffers, q) fit the card's L2: there a block's loads hit the
# L2 and the two barriers and partial folds an iteration weigh more than
# the rows in flight.  On an NVIDIA H100 80GB HBM3 at 700.00 W, 5 of the
# 6 that fit gave 0.803 and 0.794 of the three-phase kernel's time at 96³
# and 128³ against 0.895 and 0.838 with 6; from 144³ on, past the L2, 6
# won (``python3 -m cgx_torch.experiments.resident_grid_sweep``).
L2_RESIDENT_BLOCKS_PER_SM = 5


def default_grid(full: int, n: int, sms: int, l2_bytes: int,
                 planes_mode: bool) -> int:
    """The grid a solve launches with when the caller names none: the
    instance's ``full`` grid, or in the constant mode, when its five
    vectors of ``n`` floats fit ``l2_bytes``,
    :data:`L2_RESIDENT_BLOCKS_PER_SM` blocks on each of ``sms`` SMs (never
    more than ``full``)."""
    if planes_mode or 5 * 4 * n > l2_bytes:
        return full
    return min(full, L2_RESIDENT_BLOCKS_PER_SM * sms)


def _grid(spec, device, planes, weight, sym, variant) -> int:
    from cgx_torch.kernels import _build

    taps = spec[3]
    lib = _build.library()
    grid = ctypes.c_int(0)
    dev = torch.device(device)
    if planes is None and weight is None:
        _build.check(lib.cgx_resident_cg_grid(dev.index, len(taps), variant,
                                              ctypes.byref(grid)),
                     "resident_cg occupancy query")
    else:
        bf16 = int(planes is not None and planes.dtype == torch.bfloat16)
        _build.check(lib.cgx_resident_dia_cg_grid(
            dev.index, len(taps), int(sym), bf16, variant,
            ctypes.byref(grid)), "resident_cg planes-mode occupancy query")
    return grid.value


def _resident_cuda(spec, b, x0, *, planes, weight, sym, tol, atol, maxiter,
                   resume, grid, variant=_TWO_PHASE):
    global resident_cg_launches, resident_dia_launches
    global resident_dia_bf16_launches
    from cgx_torch.kernels import _build
    from cgx_torch.kernels.stencil import check_cuda_vector, tap_arrays

    with annotate(PREP):
        nx, ny, nz, taps, coeffs = spec
        n = nx * ny * nz
        check_cuda_vector(b, n, "resident_cg")
        if len(taps) > 27:
            raise ValueError("resident_cg: at most 27 taps")
        planes_mode = planes is not None or weight is not None
        n_planes = sum(1 for c in coeffs if c is None)
        if n_planes and (planes is None
                         or tuple(planes.shape) != (n_planes, n)):
            raise ValueError(f"resident_cg: need {n_planes} planes of {n} "
                             f"rows")
        for t, name, ok in ((planes, "planes",
                             (torch.float32, torch.bfloat16)),
                            (weight, "weight", (torch.float32,))):
            if t is not None and (t.device != b.device or t.dtype not in ok
                                  or not t.is_contiguous()):
                raise ValueError(f"resident_cg: {name} must be a contiguous "
                                 f"{' or '.join(map(str, ok))} tensor on "
                                 f"{b.device}")
        full = _grid(spec, b.device, planes, weight, sym, variant)
        if grid is None:
            props = torch.cuda.get_device_properties(b.device)
            grid = (full if variant != _TWO_PHASE else default_grid(
                full, n, props.multi_processor_count, props.L2_cache_size,
                planes_mode))
        elif not 1 <= int(grid) <= full:
            raise ValueError(f"resident_cg: grid {grid} outside 1..{full}, "
                             f"the blocks that fit on the card at once")
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
                torch.as_tensor(v, dtype=torch.float32,
                                device=dev).reshape(())
                for v in (rz_s, rw_s)])
        # The two-phase kernel's second p buffer, and q.
        p1 = torch.empty_like(b) if variant == _TWO_PHASE else None
        q = torch.empty_like(b)
        k_out = torch.empty(1, dtype=torch.int32, device=dev)
        rz_out = torch.empty(2, dtype=torch.float32, device=dev)
        lib = _build.library()
        maxit = min(int(maxiter), 2 ** 31 - 1)
        rz_ptr = None if rz_in is None else rz_in.data_ptr()
        p1_ptr = None if p1 is None else p1.data_ptr()
        grid = int(grid)
        if not planes_mode:
            partials = torch.empty(2 * grid, dtype=torch.float32,
                                   device=dev)
            tap_c, coef_c = tap_arrays(taps, coeffs)
        else:
            partials = torch.empty(3 * grid, dtype=torch.float32,
                                   device=dev)
            tap_c, coef_c, plane_c = plane_tap_arrays(taps, coeffs)
        stream = torch.cuda.current_stream(dev).cuda_stream
    with annotate(ENGINE), torch.cuda.device(dev):
        if not planes_mode:
            rc = lib.cgx_resident_cg(
                x.data_ptr(), r.data_ptr(), p.data_ptr(), p1_ptr,
                q.data_ptr(), partials.data_ptr(), grid, nx, ny, nz, len(taps),
                tap_c, coef_c, tol_sq.data_ptr(), maxit, flag, rz_ptr,
                k_out.data_ptr(), rz_out.data_ptr(), variant, stream)
        else:
            rc = lib.cgx_resident_dia_cg(
                x.data_ptr(), r.data_ptr(), p.data_ptr(), p1_ptr,
                q.data_ptr(), partials.data_ptr(), grid, nx, ny, nz, len(taps),
                tap_c, coef_c, plane_c,
                None if planes is None else planes.data_ptr(),
                None if weight is None else weight.data_ptr(), int(sym),
                int(planes is not None and planes.dtype == torch.bfloat16),
                tol_sq.data_ptr(), maxit, flag, rz_ptr, k_out.data_ptr(),
                rz_out.data_ptr(), variant, stream)
        _build.check(rc, "resident_cg cooperative launch")
    if variant == _TWO_PHASE and planes_mode:
        resident_dia_launches += 1
        if planes is not None and planes.dtype == torch.bfloat16:
            resident_dia_bf16_launches += 1
    elif variant == _TWO_PHASE:
        resident_cg_launches += 1
    return x, r, p, k_out[0], rz_out, tol_sq


def resident_cg_call(spec, b: torch.Tensor, x0=None, *, planes=None,
                     weight=None, sym: bool = False, tol: float = 1e-6,
                     atol: float = 0.0, maxiter: int = 1000, resume=None,
                     grid=None):
    """Low-level whole-solve call; returns the carried state
    ``(x, r, p, k, rz, tol_sq)`` with ``rz = (rz, rw)`` so chunked callers
    can feed it back via ``resume``.

    ``planes``: ``(n_planes, n)`` coefficient planes for the ``None``
    slots of ``spec``'s coefficients, in tap order; ``weight``: per-row
    weights of the exit test; ``sym``: apply each plane also at its mirror
    tap.  ``resume``: ``(x, r, p, rz, rw)`` — skips the fresh init
    (r₀ = b − A·x₀, p₀ = r₀) and continues the exact recurrence.  ``b``
    still supplies the convergence threshold.  The caller's ``b``, ``x0``
    and resume tensors are never written.  ``grid``: the kernel's blocks
    (default :func:`default_grid`, at most :func:`resident_grid`); the
    sums, and so the trajectory, depend on it.  A CPU tensor takes the
    plain version and ignores it.
    """
    if b.device.type == "cpu":
        return two_phase_reference(spec, b, x0, planes=planes, weight=weight,
                                   sym=sym, tol=tol, atol=atol,
                                   maxiter=maxiter, resume=resume)
    if b.device.type != "cuda":
        raise ValueError(f"resident_cg: unsupported device {b.device}")
    return _resident_cuda(spec, b, x0, planes=planes, weight=weight, sym=sym,
                          tol=tol, atol=atol, maxiter=maxiter, resume=resume,
                          grid=grid)


def _three_phase_grid(spec, device, *, planes=None, weight=None,
                      sym: bool = False) -> int:
    """:func:`resident_grid` of the three-phase kernel (the "before")."""
    return _grid(spec, device, planes, weight, sym, _THREE_PHASE)


def _three_phase_call(spec, b: torch.Tensor, x0=None, *, planes=None,
                      weight=None, sym: bool = False, tol: float = 1e-6,
                      atol: float = 0.0, maxiter: int = 1000, resume=None,
                      grid=None):
    """:func:`resident_cg_call` through the three-phase kernel of the first
    design: the same-run "before" of the tests and the smoke.  CUDA only;
    no launch counter counts it."""
    if b.device.type != "cuda":
        raise ValueError("the three-phase kernel runs on CUDA tensors only")
    return _resident_cuda(spec, b, x0, planes=planes, weight=weight, sym=sym,
                          tol=tol, atol=atol, maxiter=maxiter, resume=resume,
                          grid=grid, variant=_THREE_PHASE)


def resident_cg(spec, b: torch.Tensor, x0=None, *, planes=None,
                weight=None, sym: bool = False, tol: float = 1e-6,
                atol: float = 0.0, maxiter: int = 1000) -> CGResult:
    """Run the whole-solve kernel; ``b``/``x0``/``weight`` flat ``(n,)``
    (the caller applies any diagonal scaling)."""
    x, _, _, k, rz, tol_sq = resident_cg_call(
        spec, b, x0, planes=planes, weight=weight, sym=sym, tol=tol,
        atol=atol, maxiter=maxiter)
    with annotate(RESULT):
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
    with annotate(PREP):
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
    fused_dia_cg` without history.  ``plane_dtype=torch.bfloat16`` holds
    the scaled planes in bf16 (rounded after the scaling); the vectors
    keep ``b``'s dtype."""
    from cgx_torch.kernels.fused_dia_cg import (dia_prep,
                                                wrap_entries_zero_or_none)

    with annotate(PREP):
        if wrap_entries_zero_or_none(d) is False:
            raise ValueError(
                "resident_dia_cg: DIA data has nonzero x-plane-crossing "
                "entries — use cg_solve instead")
        nx, ny, nz, taps, coeffs, planes, e, weight, sym = dia_prep(
            d, b.dtype, jacobi=jacobi, inv_diag=inv_diag)
        if plane_dtype is not None:
            planes = planes.to(plane_dtype)
        b_s, x0_s = b, x0
        if e is not None:
            b_s = e * b
            x0_s = None if x0 is None else x0 * safe_recip(e)
    res = resident_cg((nx, ny, nz, taps, coeffs), b_s, x0_s, planes=planes,
                      weight=weight, sym=sym, tol=tol, atol=atol,
                      maxiter=int(maxiter))
    if e is None:
        return res
    with annotate(RESULT):
        return dataclasses.replace(res, x=e * res.x)

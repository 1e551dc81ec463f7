"""K4: the semi-resident whole-solve CG — CUDA kernel + plain version.

Counterpart of :mod:`cgx.kernels.fused_semiresident`: the whole PCG solve
in one launch with the two-pass engine's algebra (α from the Gram numbers
``p·Ap`` and ``‖Ap‖²`` of the previous sweep, β from the CA identity
``(α²·qq − rz)/rz``, ``Σr²`` recomputed in the update sweep), over a
constant-coefficient stencil or a Jacobi-scaled DIA operator (coefficient
planes in float32 or bfloat16, ``sym`` mirror taps, the weight ``w`` of
the true-residual exit test).

The residency tiers are the JAX package's names for what the iteration
keeps: ``rpq`` stores ``q = A·p`` (one apply per iteration), ``rp`` and
``p`` never store ``q`` (two applies per iteration: the update sweep
recomputes ``q`` from the old ``p``).  On the TPU a tier is a placement in
VMEM; on the card every vector lives in device memory and the tier plan
asks whether the tier's resident set fits the card's L2
(:data:`SR_L2_BUDGET`): 3, 2 or 1 vectors, plus, for streamed planes, a
window of each plane as long as the operator's reach in both directions
(the mirror taps read a plane again ``off`` rows later).  ``rp`` and
``p`` run the same kernel.  The TPU constants (``SR_VMEM_BUDGET``,
``_MODE_SLOTS``, ``_MODE_SPILL``, the 100 MB plane budget) and the lane
blocks ``bl`` are not ported: the port works on flat vectors, as the
two-pass engine's port does.

The sums are exact (fp64 products and sums, rounded to fp32 once) and the
kernel takes them over the two-pass engine's partition
(:meth:`~cgx_torch.kernels.fused_engine.FusedCG.grids`; see
``cgx_torch/csrc/semiresident.cu``), so on the card it equals
``fused_stencil_cg``/``fused_dia_cg`` (K3) bit for bit for ``x0=None``.
The plain version, :func:`sr_cg_reference`, is the same algebra through
K3's plain kernels, so on the CPU it equals K3's plain solve bit for bit.

The kernel (``sr2_kernel``) folds each sweep's partials once, in the
sweep's last block, carries each row's node and keeps two of a thread's
rows in flight, and holds K3's first kernel A's occupancy; its grid is
:func:`~cgx_torch.kernels.fused_onepass.launch_grid` over K3's grids
(:func:`sr_launch_grid`), a launch knob that changes no bit.  The first
design (``sr_kernel``) stays as the same-run "before"
(:func:`_before_call`, :func:`_before_solve`: CUDA only, counted
nowhere), and is the kernel of the one instance where the redesign
measured slower on the H100 (:func:`_design_for`).

:func:`sr_cg_call` launches the kernel for a CUDA ``b`` and takes the
plain version only for a CPU ``b``.  ``sr_cg_launches`` counts the
redesign's constant-tap launches, ``sr_cg_planes_launches`` its
planes-mode ones, ``sr_cg_first_launches`` the first design's launches
on the package's path (:func:`_design_for`), and ``sr_cg_bf16_launches``
the launches with bf16 planes, of either kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from cgx_torch.kernels.fused_engine import (FusedCG, exact_sums,
                                            plane_tap_arrays)
from cgx_torch.kernels.fused_onepass import launch_grid
from cgx_torch.solve.cg import CGResult
from cgx_torch.utils.profiling import host_read

__all__ = ["SRGeometry", "make_sr_geometry", "sr_mode", "sr_cg",
           "sr_cg_call", "sr_cg_reference", "sr_stencil_cg", "sr_dia_cg",
           "sr_dia_supported", "SR_L2_BUDGET", "STREAMS", "sr_launch_grid",
           "sr_cg_launches", "sr_cg_planes_launches", "sr_cg_first_launches",
           "sr_cg_bf16_launches"]

# Kernel launches so far (a run resets them to show which kernels it used).
sr_cg_launches = 0
sr_cg_planes_launches = 0
sr_cg_first_launches = 0
sr_cg_bf16_launches = 0

# The tier plan's budget: the L2 of an NVIDIA H100 SXM, 50 MiB
# (torch.cuda.get_device_properties(dev).L2_cache_size).
SR_L2_BUDGET = 50 << 20

# Vectors each tier keeps resident.
_MODE_VECTORS = {"rpq": 3, "rp": 2, "p": 1}

# Vector streams of n floats an iteration: rpq reads p (gram) and x, r, p,
# q and writes q, x, r, p; rp and p read p (gram) and x, r, p_old and
# write x, r, p_new (the planes and w apart).
STREAMS = {"rpq": 9, "rp": 7, "p": 7}

# The kernels of semiresident.cu (its `design`): the first design, kept as
# the same-run "before", and the redesign.
_FIRST_DESIGN, _REDESIGN = 0, 1

# Words of the redesign's control block (struct Ctl in semiresident.cu).
_CTL_WORDS = 8

_cached_grid = functools.lru_cache(maxsize=None)(launch_grid)


@dataclass(frozen=True)
class SRGeometry:
    """The operator's grid and taps and the tier (flat vectors)."""

    nx: int
    ny: int
    nz: int
    taps: Tuple[Tuple[int, int, int], ...]
    mode: str               # "rpq" | "rp" | "p"
    n_planes: int = 0       # streamed coefficient planes (variable DIA)
    weighted: bool = False  # the exit test reads Σ r²·w
    sym: bool = False       # planes mirror into their negative taps

    @property
    def n(self) -> int:
        return self.nx * self.ny * self.nz


def _reach(ny: int, nz: int, taps) -> int:
    """Rows between a row and its farthest neighbour."""
    return max([abs((dx * ny + dy) * nz + dk) for (dx, dy, dk) in taps]
               + [1])


def _footprint(mode: str, n: int, reach: int, itemsize: int,
               n_planes: int, plane_isz: int) -> int:
    """Bytes the tier keeps resident: its vectors, and a window of
    ``2·reach`` rows of each streamed plane."""
    return (_MODE_VECTORS[mode] * n * itemsize
            + n_planes * 2 * reach * plane_isz)


def _plan(nx: int, ny: int, nz: int, taps: Sequence[Tuple[int, int, int]],
          itemsize: int, mode: Optional[str], n_planes: int = 0,
          plane_isz: int = 4) -> Optional[str]:
    """The densest tier whose resident set fits :data:`SR_L2_BUDGET`, or
    None.  A forced ``mode`` is returned as it is.  With streamed planes
    only ``rpq`` is planned (``rp`` and ``p`` read the planes twice per
    iteration), as in the JAX package."""
    if mode is not None:
        if mode not in _MODE_VECTORS:
            raise ValueError(f"unknown mode {mode!r}")
        return mode
    n, reach = nx * ny * nz, _reach(ny, nz, taps)
    for m in ("rpq",) if n_planes else ("rpq", "rp", "p"):
        if _footprint(m, n, reach, itemsize, n_planes,
                      plane_isz) <= SR_L2_BUDGET:
            return m
    return None


def sr_mode(nx: int, ny: int, nz: int, taps: Sequence[Tuple[int, int, int]],
            itemsize: int = 4) -> Optional[str]:
    """The densest tier that fits the card's budget, or None (too large
    even for ``p``: use the two-pass engine)."""
    return _plan(nx, ny, nz, taps, itemsize, None)


def make_sr_geometry(nx: int, ny: int, nz: int,
                     taps: Sequence[Tuple[int, int, int]],
                     mode: Optional[str] = None, itemsize: int = 4,
                     n_planes: int = 0, weighted: bool = False,
                     sym: bool = False, plane_isz: int = 4) -> SRGeometry:
    """The geometry for the densest fitting tier, or for ``mode``."""
    taps = tuple(tuple(int(d) for d in t) for t in taps)
    for (dx, dy, dk) in taps:
        if abs(dx) > 1:
            raise ValueError(f"tap {dx, dy, dk}: |dx| must be <= 1")
    mode = _plan(nx, ny, nz, taps, itemsize, mode, n_planes, plane_isz)
    if mode is None:
        raise ValueError("problem too large for any semi-resident tier — "
                         "use the two-pass engine")
    return SRGeometry(nx=int(nx), ny=int(ny), nz=int(nz), taps=taps,
                      mode=mode, n_planes=int(n_planes),
                      weighted=bool(weighted), sym=bool(sym))


def _start(g: SRGeometry, b, coeffs, tol, atol, planes, w, plane_dtype,
           b_norm_sq, resume, x0_l):
    """``(engine, x, r, p, (rz, rw), tol_sq)``: the operator as a two-pass
    engine (its plain kernels and its grids), fresh copies of the start
    state and the exit threshold ``max(tol²·‖b‖², atol²)``."""
    if g.n_planes and (planes is None or planes.shape[0] != g.n_planes):
        raise ValueError(f"geometry expects {g.n_planes} streamed planes")
    if g.weighted and w is None:
        raise ValueError("geometry expects a weight vector")
    eng = FusedCG(g.nx, g.ny, g.nz, g.taps, dtype=b.dtype, coeffs=coeffs,
                  planes=planes if g.n_planes else None,
                  weight=w if g.weighted else None, sym=g.sym,
                  plane_dtype=plane_dtype)
    bb = (torch.sum(b.to(torch.float32) ** 2) if b_norm_sq is None
          else torch.as_tensor(b_norm_sq, dtype=torch.float32,
                               device=b.device))
    tol2 = torch.tensor(tol, dtype=torch.float32).square().item()
    atol_t = torch.as_tensor(atol, dtype=torch.float32, device=b.device)
    tol_sq = torch.maximum(bb * tol2, atol_t * atol_t).reshape(())
    if resume is None:
        # b carries r₀; x0_l is the matching base of x.
        x = torch.zeros_like(b) if x0_l is None else x0_l.to(b.dtype).clone()
        r = b.clone()
        p = b.clone()
        rz = torch.stack(exact_sums(r, eng.weight))
    else:
        xs, rs, ps, rz_s, rw_s = resume
        x, r, p = xs.clone(), rs.clone(), ps.clone()
        rz = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                          device=b.device).reshape(())
                          for v in (rz_s, rw_s)])
    return eng, x, r, p, rz, tol_sq


def sr_cg_reference(g: SRGeometry, b: torch.Tensor, *, coeffs,
                    tol: float = 1e-6, atol=0.0, maxiter: int = 1000,
                    planes=None, w=None, plane_dtype=None, b_norm_sq=None,
                    resume=None, x0_l=None):
    """Plain version of :func:`sr_cg_call`: the same sweeps as a Python
    loop over the two-pass engine's plain kernels (one host read per
    iteration, any device).  ``rpq`` keeps the gram sweep's ``q``; ``rp``
    and ``p`` recompute it in the update."""
    eng, x, r, p, rz, tol_sq = _start(g, b, coeffs, tol, atol, planes, w,
                                      plane_dtype, b_norm_sq, resume, x0_l)
    rz, rw = rz[0], rz[1]
    maxiter = int(maxiter)
    k = 0
    if k < maxiter and host_read(rw > tol_sq, bool):
        q, pq, qq = eng.kernel_a_reference(p)
        while True:
            if g.mode != "rpq":
                q = eng.matvec(p)
            x, r, p, rz, rw = eng.kernel_b_reference(rz, pq, qq, x, r, p, q)
            k += 1
            if not (k < maxiter and host_read(rw > tol_sq, bool)):
                break
            q, pq, qq = eng.kernel_a_reference(p)
    return (x, r, p, torch.tensor(k, dtype=torch.int32, device=b.device),
            torch.stack([rz, rw]), tol_sq)


def _occupancy(lib, dev, g: SRGeometry, eng: FusedCG, design: int) -> int:
    """Blocks of the kernel (``design``) for the operator and tier that fit
    on the card at once."""
    from cgx_torch.kernels import _build

    variable = int(eng.planes is not None)
    bf16 = int(variable and eng.plane_dtype == torch.bfloat16)
    grid = ctypes.c_int(0)
    _build.check(lib.cgx_sr_grid(dev.index, len(g.taps), variable,
                                 int(eng.sym), bf16, int(g.mode != "rpq"),
                                 design, ctypes.byref(grid)),
                 "sr_cg occupancy query")
    return grid.value


def sr_launch_grid(g: SRGeometry, eng: FusedCG, dev, ga: int,
                   gb: int) -> int:
    """The kernel's grid on ``dev`` over K3's grids ``ga`` (the gram sweep)
    and ``gb`` (the update): :func:`launch_grid` within the blocks that fit
    at once."""
    from cgx_torch.kernels import _build

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cap = _occupancy(_build.library(), dev, g, eng, _REDESIGN)
    return _cached_grid(ga, gb, cap, sms)


def _design_for(g: SRGeometry, eng: FusedCG) -> int:
    """The kernel an instance runs: the redesign, but the first design for
    plane operators of at most 7 taps in the rpq tier, where the redesign
    measured 1.012–1.019× the first design's time in four same-run
    comparisons on the H100 (PERF.md §6)."""
    if eng.planes is not None and len(g.taps) <= 7 and g.mode == "rpq":
        return _FIRST_DESIGN
    return _REDESIGN


def _sr_cuda(g: SRGeometry, eng: FusedCG, x, r, p, rz_in, tol_sq, maxiter,
             grids, design):
    global sr_cg_launches, sr_cg_planes_launches, sr_cg_first_launches
    global sr_cg_bf16_launches
    from cgx_torch.kernels import _build
    from cgx_torch.kernels.stencil import check_cuda_vector

    dev = x.device
    for v, name in ((x, "x"), (r, "r"), (p, "p")):
        check_cuda_vector(v, g.n, f"sr_cg {name}")
    for t, name in ((eng.planes, "planes"), (eng.weight, "weight")):
        if t is not None and t.device != dev:
            raise ValueError(f"sr_cg: {name} on {t.device}, b on {dev}")
    if eng.planes is not None and eng.plane_dtype not in (torch.float32,
                                                          torch.bfloat16):
        raise ValueError("sr_cg: the CUDA kernel takes float32 or bfloat16 "
                         f"planes, not {eng.plane_dtype}")
    lib = _build.library()
    ga, gb = eng.grids(dev) if grids is None else map(int, grids)
    count = design is None          # the package's path, not the "before"
    if design is None:
        design = _design_for(g, eng)
    remat = int(g.mode != "rpq")
    variable = int(eng.planes is not None)
    bf16 = int(variable and eng.plane_dtype == torch.bfloat16)
    if design == _REDESIGN:
        grid = sr_launch_grid(g, eng, dev, ga, gb)
        ctl = torch.zeros(_CTL_WORDS, dtype=torch.int32, device=dev)
    else:
        grid, ctl = _occupancy(lib, dev, g, eng, design), None
    part_a = torch.empty(2 * ga, dtype=torch.float64, device=dev)
    part_b = torch.empty(2 * gb, dtype=torch.float64, device=dev)
    p_alt = torch.empty_like(p) if remat else None
    q = None if remat else torch.empty_like(p)
    k_out = torch.empty(1, dtype=torch.int32, device=dev)
    rz_out = torch.empty(2, dtype=torch.float32, device=dev)
    taps_c, coef_c, plane_c = plane_tap_arrays(g.taps, eng.coeffs)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rz_in = rz_in.to(torch.float32).contiguous()
    tol_sq = tol_sq.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        rc = lib.cgx_sr_cg(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), ptr(p_alt), ptr(q),
            ptr(eng.planes), ptr(eng.weight), part_a.data_ptr(), ga,
            part_b.data_ptr(), gb, grid, g.nx, g.ny, g.nz,
            len(g.taps), taps_c, coef_c, plane_c, int(eng.sym), bf16, remat,
            tol_sq.data_ptr(), min(int(maxiter), 2 ** 31 - 1),
            rz_in.data_ptr(), k_out.data_ptr(), rz_out.data_ptr(), ptr(ctl),
            design, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sr_cg cooperative launch")
    if count:
        sr_cg_bf16_launches += bf16
        if design == _FIRST_DESIGN:
            sr_cg_first_launches += 1
        elif variable:
            sr_cg_planes_launches += 1
        else:
            sr_cg_launches += 1
    return x, r, p, k_out[0], rz_out


def sr_cg_call(g: SRGeometry, b: torch.Tensor, *, coeffs,
               tol: float = 1e-6, atol=0.0, maxiter: int = 1000,
               planes=None, w=None, plane_dtype=None, b_norm_sq=None,
               resume=None, x0_l=None, grids=None):
    """Low-level whole-solve call; returns the carried state ``(x, r, p,
    k, rz, tol_sq)`` with ``rz = (rz, rw)``, so a chunked caller can feed
    it back through ``resume``.

    ``b`` carries r₀ (a caller with an initial guess folds it as
    ``r₀ = b − A·x₀`` and passes ``x0_l``, the base of x) and, unless
    ``b_norm_sq`` is given, the threshold's ``‖b‖²``.  ``planes``: the
    ``(n_planes, n)`` planes of the ``None`` slots of ``coeffs``, held in
    ``plane_dtype``; ``w``: the exit test's weights.  ``resume``: ``(x, r,
    p, rz, rw)``, continued exactly (the Gram numbers are recomputed by
    the same sweep).  ``grids``: the two-pass engine's ``(grid_a,
    grid_b)``, the partition of the sums (default
    :meth:`FusedCG.grids`).  The caller's tensors are never written.  A
    CPU ``b`` takes the plain version.
    """
    if b.device.type == "cpu":
        return sr_cg_reference(g, b, coeffs=coeffs, tol=tol, atol=atol,
                               maxiter=maxiter, planes=planes, w=w,
                               plane_dtype=plane_dtype, b_norm_sq=b_norm_sq,
                               resume=resume, x0_l=x0_l)
    if b.device.type != "cuda":
        raise ValueError(f"sr_cg: unsupported device {b.device}")
    return _call(g, b, coeffs, tol, atol, maxiter, planes, w, plane_dtype,
                 b_norm_sq, resume, x0_l, grids, None)


def _call(g, b, coeffs, tol, atol, maxiter, planes, w, plane_dtype,
          b_norm_sq, resume, x0_l, grids, design):
    eng, x, r, p, rz, tol_sq = _start(g, b, coeffs, tol, atol, planes, w,
                                      plane_dtype, b_norm_sq, resume, x0_l)
    x, r, p, k, rz = _sr_cuda(g, eng, x, r, p, rz, tol_sq, maxiter, grids,
                              design)
    return x, r, p, k, rz, tol_sq


def _before_call(g: SRGeometry, b: torch.Tensor, *, coeffs,
                 tol: float = 1e-6, atol=0.0, maxiter: int = 1000,
                 planes=None, w=None, plane_dtype=None, b_norm_sq=None,
                 resume=None, x0_l=None, grids=None):
    """:func:`sr_cg_call` through the first design's kernel (the same-run
    "before" of the tests and the smoke).  CUDA only; no launch counter
    counts it."""
    if b.device.type != "cuda":
        raise ValueError("the first semi-resident kernel runs on CUDA "
                         "tensors only")
    return _call(g, b, coeffs, tol, atol, maxiter, planes, w, plane_dtype,
                 b_norm_sq, resume, x0_l, grids, _FIRST_DESIGN)


def _result(b, out) -> CGResult:
    x, _, _, k, rz, tol_sq = out
    return CGResult(x=x, iterations=k, residual_norm_sq=rz[1],
                    converged=rz[1] <= tol_sq,
                    history=torch.zeros(0, dtype=torch.float32,
                                        device=b.device))


def _before_solve(g: SRGeometry, b: torch.Tensor, **kw) -> CGResult:
    """:func:`sr_cg` through the first design's kernel (CUDA only, counted
    nowhere)."""
    return _result(b, _before_call(g, b, **kw))


def sr_cg(g: SRGeometry, b: torch.Tensor, *, coeffs, tol: float = 1e-6,
          atol=0.0, maxiter: int = 1000, planes=None, w=None,
          plane_dtype=None, b_norm_sq=None, grids=None) -> CGResult:
    """Run the semi-resident solve on flat ``b`` from x₀ = 0 (see
    :func:`sr_cg_call`; callers with an initial guess solve for the
    correction, as :func:`sr_stencil_cg` does)."""
    return _result(b, sr_cg_call(
        g, b, coeffs=coeffs, tol=tol, atol=atol, maxiter=maxiter,
        planes=planes, w=w, plane_dtype=plane_dtype, b_norm_sq=b_norm_sq,
        grids=grids))


def sr_stencil_cg(s, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                  atol: float = 0.0, maxiter: int = 1000,
                  mode: Optional[str] = None) -> CGResult:
    """Semi-resident whole-solve CG on a constant-coefficient stencil;
    ``cg_solve`` semantics (no history).  ``mode`` overrides the planned
    tier.  An initial guess is handled by solving for the correction
    ``A·dx = b − A·x0`` with the threshold still taken against the
    original ‖b‖."""
    from cgx_torch.kernels.fused_cg import stencil_taps, supports
    from cgx_torch.ops.spmv import spmv

    spec = stencil_taps(s)
    if spec is None or not supports(s):
        raise ValueError("sr_stencil_cg: unsupported operator")
    nx, ny, nz, taps, coeffs = spec
    g = make_sr_geometry(nx, ny, nz, taps, mode=mode,
                         itemsize=b.element_size())
    if x0 is not None:
        b_eff = b - spmv(s, x0)
        bb = torch.sum(b.to(torch.float32) ** 2)
        thr = torch.maximum(torch.tensor(tol, dtype=torch.float32,
                                         device=b.device) * torch.sqrt(bb),
                            torch.tensor(atol, dtype=torch.float32,
                                         device=b.device))
        res = sr_cg(g, b_eff, coeffs=coeffs, tol=0.0, atol=thr,
                    maxiter=maxiter)
        return dataclasses.replace(res, x=res.x + x0)
    return sr_cg(g, b, coeffs=coeffs, tol=tol, atol=atol, maxiter=maxiter)


def sr_dia_supported(d, dtype=torch.float32, plane_dtype=None) -> bool:
    """Whether :func:`sr_dia_cg` plans a tier for this DIA operator: the
    engines take its offsets and the ``rpq`` tier, with a window of every
    plane counted, fits the budget.  Conservative on the plane count:
    every kept tap is counted as a plane."""
    from cgx_torch.kernels.fused_dia_cg import (data_symmetric_or_none,
                                                dia_engine_spec, supports_dia)

    spec = dia_engine_spec(d)
    if spec is None or not supports_dia(d):
        return False
    nx, ny, nz, taps = spec
    offs = tuple(map(int, d.offsets))
    sym = data_symmetric_or_none(d) is True
    n_planes = (1 + sum(1 for o in offs if o > 0)) if sym else len(offs)
    isz = torch.empty((), dtype=dtype).element_size()
    p_isz = (isz if plane_dtype is None
             else torch.empty((), dtype=plane_dtype).element_size())
    return _plan(nx, ny, nz, taps, isz, None, n_planes, p_isz) is not None


def sr_dia_cg(d, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
              atol: float = 0.0, maxiter: int = 1000, jacobi: bool = True,
              inv_diag=None, plane_dtype=None, mode: Optional[str] = None,
              assume_symmetric: Optional[bool] = None) -> CGResult:
    """Semi-resident whole-solve Jacobi-PCG (plain CG with
    ``jacobi=False``) on a DIA operator; the operator semantics of
    :func:`~cgx_torch.kernels.fused_dia_cg.fused_dia_cg` (Jacobi as the
    symmetric scaling ``Ã = E·A·E``, the exit test on the weighted true
    residual against the original ‖b‖², wrap-free data), without history.
    Raises when no tier is planned (:func:`sr_dia_supported`) unless
    ``mode`` forces one.  ``plane_dtype=torch.bfloat16`` holds the scaled
    planes in bf16."""
    from cgx_torch.kernels.fused_dia_cg import (dia_prep,
                                                wrap_entries_zero_or_none)
    from cgx_torch.ops.spmv import spmv

    if wrap_entries_zero_or_none(d) is False:
        raise ValueError(
            "sr_dia_cg: DIA data has nonzero entries at x-plane-crossing "
            "slots; the kernel would compute another operator — use "
            "cg_solve instead")
    nx, ny, nz, taps, coeffs, planes, e, weight, sym = dia_prep(
        d, b.dtype, jacobi=jacobi, inv_diag=inv_diag,
        assume_symmetric=assume_symmetric)
    pdt = b.dtype if plane_dtype is None else plane_dtype
    g = make_sr_geometry(nx, ny, nz, taps, mode=mode,
                         n_planes=int(planes.shape[0]),
                         weighted=weight is not None, sym=sym,
                         itemsize=b.element_size(),
                         plane_isz=torch.empty((), dtype=pdt).element_size())
    bb = torch.sum(b.to(torch.float32) ** 2)    # the true ‖b‖², both spaces
    r0 = b if x0 is None else b - spmv(d, x0)
    b_s = r0 if e is None else e * r0
    res = sr_cg(g, b_s, coeffs=coeffs, tol=tol, atol=atol, maxiter=maxiter,
                planes=planes, w=weight, plane_dtype=plane_dtype,
                b_norm_sq=bb)
    x = res.x if e is None else e * res.x
    if x0 is not None:
        x = x + x0
    return dataclasses.replace(res, x=x)

"""K3: the two-pass fused CG engine — CUDA kernels A and B + plain versions.

Counterpart of :mod:`cgx.kernels.fused_engine` (``FusedCG``,
``FusedState``).  Per iteration:

  A. ``q = Ã p`` with the partial sums of ``p·q`` and ``q·q``;
  B. ``α = rz/pq``, ``β = (α²·qq − rz)/rz`` (the communication-avoiding
     identity, so that β is known before the pass), then ``x += αp``,
     ``r −= αq``, ``p = r + βp`` with ``Σr²`` and ``Σr²·w``.

The operator is a list of grid taps ``(dx, dy, dk)`` with ``|dx| ≤ 1``,
each with a constant coefficient (boundary masks from index arithmetic) or
``None`` for a per-row coefficient plane (row-aligned DIA convention, the
boundary zeros in the data); ``sym`` applies each plane also at its
mirror tap.  ``weight`` makes ``Σr²·w`` the exit test (the Jacobi-scaled
DIA solve, ``w = diag A``) while β keeps the solve-space ``Σr²``.

The four sums of an iteration (p·q, q·q, Σr², Σr²·w) are taken exactly,
in the kernels and in the plain version alike: fp64 products of the
(widened) vectors summed in fp64 and rounded to fp32 once (the JAX package
sums in fp32).  The CA identity makes the exit iteration sensitive to 1e-7
errors in those sums; see the note in ``fused_engine.cu``.

Mixed precision: the vectors are float32 or bfloat16 (``dtype``) and the
coefficient planes float32 or bfloat16 (``plane_dtype``, default
``dtype``).  The kernels take fp32/fp32, fp32 vectors with bf16 planes,
and bf16 vectors with bf16 planes or none.  Every value is widened to
fp32, kernel A sums a row in fp32 and rounds q once, kernel B rounds α and
β to ``dtype`` and then each updated entry once; the plain versions round
at the same places, so a bf16 mode equals its plain version bit for bit on
the card.  The JAX package rounds every bf16 term instead, so the two
packages agree to a bf16 tolerance.

The port works on flat vectors, as the whole-solve kernel does.  The
JAX package's TPU placement — ``Geometry``/``make_geometry`` (lane blocks,
VMEM windows, ``double_buffer``, halo rows) and ``to_layout`` — is not
ported: the CUDA kernels (``cgx_torch/csrc/fused_engine.cu``) run a flat
grid-stride loop.  Neither are ``state_to_flat``/``state_from_flat`` (the
checkpoint slice, ROADMAP queue A item 11) or ``axis_name``
(distribution).

On a CUDA tensor :meth:`FusedCG.run` launches kernel A and kernel B once
per iteration from a Python loop.  The exit decision, α, β and the history
slot stay on the device (see the source note); the host reads one flag per
chunk of :data:`CHUNK` iterations, and the launches past the exit return at
once.  On a CPU tensor it takes the plain version, :meth:`FusedCG.
run_reference`, which a CUDA tensor can also be given explicitly.
``fused_a_launches`` and ``fused_b_launches`` count the kernels' launches,
``fused_a_bf16_launches``, ``fused_b_bf16_launches`` and
``fused_a_bf16_planes_launches`` those of the narrow modes among them.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from cgx_torch.kernels import _build
from cgx_torch.ops.spmv import shifted
from cgx_torch.solve.cg import CGResult
from cgx_torch.sparse.stencil import _shift

__all__ = ["FusedCG", "FusedState", "tap_matvec", "threshold",
           "plane_tap_arrays", "fused_a_launches", "fused_b_launches",
           "fused_a_bf16_launches", "fused_b_bf16_launches",
           "fused_a_bf16_planes_launches", "CHUNK"]

# Kernel launches so far, every mode (a run resets them to show which
# kernels it used), and those of the narrow modes: bf16 vectors (kernels A
# and B), and fp32 vectors with bf16 planes (kernel A; its B is fp32's).
fused_a_launches = 0
fused_b_launches = 0
fused_a_bf16_launches = 0
fused_b_bf16_launches = 0
fused_a_bf16_planes_launches = 0

# Iterations launched between two reads of the device's exit flag.
CHUNK = 32

# Words of the device control block (the struct Ctl in fused_engine.cu).
_RZ, _RW, _K, _PENDING, _DONE, _TOL, _MAXIT, _HLEN, _N_RZ, _N_DONE = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 11)


def tap_matvec(nx: int, ny: int, nz: int, taps, coeffs, planes, sym: bool,
               v: torch.Tensor) -> torch.Tensor:
    """Plain ``y = Ã·v`` for engine taps, rounded as the kernels round it.

    A constant tap is ``c·v[neighbour]`` inside the grid, 0 outside; a
    plane tap is ``plane[i]·v[i+off]`` with flat zero fill, plus the mirror
    ``plane[i−off]·v[i−off]`` when ``sym`` (``off`` = dx·ny·nz + dy·nz +
    dk).  Terms are added in tap order, in ``v``'s dtype; narrower planes
    are widened to it first.
    """
    g = v.reshape(nx, ny, nz)
    y = None
    pi = 0
    for (dx, dy, dk), c in zip(taps, coeffs):
        if c is not None:
            term = c * _shift(_shift(_shift(g, 0, dx), 1, dy), 2,
                              dk).reshape(-1)
        else:
            w = planes[pi].to(v.dtype)
            pi += 1
            off = (dx * ny + dy) * nz + dk
            term = w * shifted(v, off)
            if sym and off != 0:
                term = term + shifted(w * v, -off)
        y = term if y is None else y + term
    return y


def threshold(b: torch.Tensor, tol: float, atol: float,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``max(tol²·Σ b²·w, atol²)`` in fp32 on ``b``'s device (``w = 1``
    when ``weight`` is None); no host synchronisation."""
    bsq = b.to(torch.float32) ** 2
    if weight is not None:
        bsq = bsq * weight.to(torch.float32)
    tol2 = torch.tensor(tol, dtype=torch.float32).square().item()
    atol2 = torch.tensor(atol, dtype=torch.float32).square().item()
    return torch.clamp(torch.sum(bsq) * tol2, min=atol2)


def exact_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Σ u·v`` of fp32 vectors taken exactly: fp64 products (exact for
    fp32 factors) summed in fp64, rounded to fp32 once."""
    return torch.sum(u.to(torch.float64) * v.to(torch.float64)).float()


def exact_sums(r: torch.Tensor, weight: Optional[torch.Tensor]):
    """``(Σ r², Σ r²·w)`` as :func:`exact_dot` takes them."""
    r64 = r.to(torch.float64)
    rsq = r64 * r64
    s = torch.sum(rsq).float()
    if weight is None:
        return s, s
    return s, torch.sum(rsq * weight.to(torch.float64)).float()


def plane_tap_arrays(taps, coeffs):
    """ctypes host arrays ``(int[3·T], float[T], int[T])`` for the C entry
    points: the taps, the constant coefficients (0 for a plane tap) and
    each tap's plane index (−1 for a constant tap)."""
    flat = [int(d) for tap in taps for d in tap]
    plane, cf, pi = [], [], 0
    for c in coeffs:
        if c is None:
            plane.append(pi)
            cf.append(0.0)
            pi += 1
        else:
            plane.append(-1)
            cf.append(float(c))
    n = len(coeffs)
    return ((ctypes.c_int * len(flat))(*flat), (ctypes.c_float * n)(*cf),
            (ctypes.c_int * n)(*plane))


@dataclass(frozen=True, eq=False)
class FusedState:
    """Flat CG state of the engine (the chunk unit of init/run/result)."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor       # (2,) fp32: [solve-space Σr̃², weighted Σr̃²·w]
    k: torch.Tensor        # int32
    history: torch.Tensor  # (maxiter+1,) fp32 or (0,)


class FusedCG:
    """The two-pass solver for one operator.

    Args:
      nx, ny, nz: the grid (2-D operators use ``(nx, 1, ny)``).
      taps: ``(dx, dy, dk)`` per tap, ``|dx| ≤ 1``, at most 27.
      dtype: vector dtype, float32 or bfloat16.
      coeffs: per tap a float (constant) or None (plane); default all None.
      planes: ``(n_planes, n)``, the None slots' planes in tap order.
      weight: per-row weights ``(n,)``; the exit test then reads Σr²·w.
      sym: symmetric mode (``taps`` lists the diagonal and one tap per
        ±off pair; each plane is applied twice).  The caller checks that
        the data really is symmetric.
      plane_dtype: the planes' dtype (default ``dtype``): bfloat16 with
        float32 vectors halves the plane bytes.  Rounding the planes is a
        fixed perturbation of the operator (about 4e-3 relative), made
        once here; :func:`cgx_torch.solve.ir.ir_cg_solve` refines it away.
    """

    def __init__(self, nx: int, ny: int, nz: int,
                 taps: Sequence[Tuple[int, int, int]], *,
                 dtype=torch.float32, coeffs=None,
                 planes: Optional[torch.Tensor] = None,
                 weight: Optional[torch.Tensor] = None, sym: bool = False,
                 plane_dtype=None):
        taps = tuple(tuple(int(d) for d in t) for t in taps)
        for (dx, dy, dk) in taps:
            if abs(dx) > 1:
                raise ValueError(f"tap {dx, dy, dk}: |dx| must be <= 1")
        if not 1 <= len(taps) <= 27:
            raise ValueError(f"FusedCG: 1 to 27 taps, got {len(taps)}")
        coeffs = (None,) * len(taps) if coeffs is None else tuple(coeffs)
        if len(coeffs) != len(taps):
            raise ValueError("FusedCG: one coefficient slot per tap")
        n_planes = sum(1 for c in coeffs if c is None)
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.n = self.nx * self.ny * self.nz
        self.taps, self.coeffs, self.dtype = taps, coeffs, dtype
        self.plane_dtype = dtype if plane_dtype is None else plane_dtype
        self.sym = bool(sym and n_planes > 0)
        if n_planes:
            if planes is None or tuple(planes.shape) != (n_planes, self.n):
                raise ValueError(
                    f"need {n_planes} coefficient planes of {self.n} rows "
                    f"for the None tap slots, got "
                    f"{None if planes is None else tuple(planes.shape)}")
            self.planes = planes.to(self.plane_dtype).contiguous()
        else:
            self.planes = None
        self.weight = (None if weight is None
                       else weight.to(dtype).contiguous())

    # -- the operator and the two kernels --------------------------------

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """Plain ``Ã·v``."""
        return tap_matvec(self.nx, self.ny, self.nz, self.taps, self.coeffs,
                          self.planes, self.sym, v)

    def kernel_a_reference(self, p: torch.Tensor):
        """Plain kernel A: ``(q, Σ p·q, Σ q·q)``, sums exact to fp32; the
        row in fp32, ``q`` rounded once to ``p``'s dtype."""
        q = self.matvec(p.float()).to(p.dtype)
        return q, exact_dot(q, p), exact_dot(q, q)

    def kernel_b_reference(self, rz, pq, qq, x, r, p, q):
        """Plain kernel B: ``(x', r', p', Σ r'², Σ r'²·w)``.  α and β are
        rounded to the vector dtype, each update is taken in fp32 and
        rounded once."""
        dt = x.dtype
        alpha32 = rz / pq
        beta = ((alpha32 * alpha32 * qq - rz) / rz).to(dt).float()
        alpha = alpha32.to(dt).float()
        pf = p.float()
        x = (x.float() + alpha * pf).to(dt)
        r_new = (r.float() - alpha * q.float()).to(dt)
        p_new = (r_new.float() + beta * pf).to(dt)
        return (x, r_new, p_new) + exact_sums(r_new, self.weight)

    def kernel_a(self, p: torch.Tensor):
        """Kernel A once: ``(q, Σ p·q, Σ q·q)``.  A CPU tensor takes the
        plain version; on a CUDA tensor the kernel runs and the block
        partials are summed here."""
        if p.device.type == "cpu":
            return self.kernel_a_reference(p)
        lib, ga, _ = self._setup(p)
        q = torch.empty_like(p)
        part_a = torch.empty(2 * ga, dtype=torch.float64, device=p.device)
        with torch.cuda.device(p.device):
            self._launch_a(lib, self._a_args(p, q, part_a, ga, None, 1, None,
                                             None, init=1))
        return (q, torch.sum(part_a[:ga]).float(),
                torch.sum(part_a[ga:]).float())

    def kernel_b(self, rz, pq, qq, x, r, p, q):
        """Kernel B once on copies of ``x, r, p``: ``(x', r', p', Σ r'²,
        Σ r'²·w)``.  A CPU tensor takes the plain version."""
        if x.device.type == "cpu":
            return self.kernel_b_reference(rz, pq, qq, x, r, p, q)
        lib, _, gb = self._setup(x)
        dev = x.device
        x, r, p = x.clone(), r.clone(), p.clone()
        part_a = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                              device=dev).reshape(())
                              for v in (pq, qq)]).double()
        part_b = torch.empty(2 * gb, dtype=torch.float64, device=dev)
        ctl = torch.zeros(16, dtype=torch.int32, device=dev)
        ctl.view(torch.float32)[_N_RZ] = torch.as_tensor(
            rz, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            self._launch_b(lib, self._b_args(x, r, p, q, part_a, 1, part_b,
                                             gb, ctl))
        return (x, r, p, torch.sum(part_b[:gb]).float(),
                torch.sum(part_b[gb:]).float())

    # -- chunked-stepping primitives -------------------------------------

    def init(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
             history_len: int = 0) -> FusedState:
        """Initial state from the solve-space right-hand side; ``x0`` goes
        through kernel A (``r₀ = b − Ã·x₀``)."""
        return self._init(b, x0, history_len, self.kernel_a)

    def _init(self, b, x0, history_len, kernel_a) -> FusedState:
        b = b.to(self.dtype)
        if x0 is None:
            x, r = torch.zeros_like(b), b
        else:
            x = x0.to(self.dtype).clone()
            r = b - kernel_a(x)[0]
        s, sw = exact_sums(r, self.weight)
        hist = torch.zeros(history_len, dtype=torch.float32, device=b.device)
        if history_len:
            hist[0] = sw
        return FusedState(x=x, r=r, p=r, rz=torch.stack([s, sw]),
                          k=torch.zeros((), dtype=torch.int32,
                                        device=b.device), history=hist)

    def run(self, state: FusedState, upto: int, tol_sq) -> FusedState:
        """Advance until ``k == upto`` or the weighted ``Σr²·w ≤ tol_sq``.
        A CPU state takes the plain version."""
        if state.x.device.type == "cpu":
            return self.run_reference(state, upto, tol_sq)
        return self._run_cuda(state, int(upto), tol_sq)

    def run_reference(self, state: FusedState, upto: int,
                      tol_sq) -> FusedState:
        """Plain version of :meth:`run`: the same two passes as a Python
        loop with one host read per iteration (any device)."""
        x, r, p = state.x, state.r, state.p
        rz, rw = state.rz[0], state.rz[1]
        hist = state.history.clone()
        k = int(state.k)
        while k < upto and bool(rw > tol_sq):
            q, pq, qq = self.kernel_a_reference(p)
            x, r, p, rz, rw = self.kernel_b_reference(rz, pq, qq, x, r, p, q)
            k += 1
            if hist.shape[0]:
                hist[min(k, hist.shape[0] - 1)] = rw
        return FusedState(x=x, r=r, p=p, rz=torch.stack([rz, rw]),
                          k=torch.tensor(k, dtype=torch.int32,
                                         device=x.device), history=hist)

    def result(self, state: FusedState, tol_sq,
               maxiter: Optional[int] = None) -> CGResult:
        """Package a :class:`CGResult`; the history is padded after the
        exit with the final value."""
        hist = state.history
        if hist.shape[0] > 0 and maxiter is not None:
            idx = torch.arange(maxiter + 1, device=hist.device)
            hist = torch.where(idx <= state.k, hist, state.rz[1])
        return CGResult(x=state.x, iterations=state.k,
                        residual_norm_sq=state.rz[1],
                        converged=state.rz[1] <= tol_sq, history=hist)

    # -- monolithic solve ---------------------------------------------------

    def solve(self, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
              atol: float = 0.0, maxiter: int = 1000,
              track_history: bool = False) -> CGResult:
        """``cg_solve`` semantics in the solve space (the caller applies
        any scaling)."""
        return self._solve(b, x0, tol, atol, maxiter, track_history,
                           self.kernel_a, self.run)

    def solve_reference(self, b: torch.Tensor, x0=None, *,
                        tol: float = 1e-6, atol: float = 0.0,
                        maxiter: int = 1000,
                        track_history: bool = False) -> CGResult:
        """:meth:`solve` through the plain versions only (any device)."""
        return self._solve(b, x0, tol, atol, maxiter, track_history,
                           self.kernel_a_reference, self.run_reference)

    def _solve(self, b, x0, tol, atol, maxiter, track_history, kernel_a,
               run) -> CGResult:
        maxiter = int(maxiter)
        tol_sq = threshold(b, tol, atol, self.weight)
        st = self._init(b, x0, maxiter + 1 if track_history else 0,
                        kernel_a)
        st = run(st, maxiter, tol_sq)
        return self.result(st, tol_sq, maxiter)

    # -- the CUDA path --------------------------------------------------------

    def _setup(self, v: torch.Tensor):
        """Checks, the library and the grids ``(lib, grid_a, grid_b)``."""
        from cgx_torch.kernels.stencil import check_cuda_vector

        if v.device.type != "cuda":
            raise ValueError(f"FusedCG: unsupported device {v.device}")
        check_cuda_vector(v, self.n, "FusedCG", self.dtype)
        if self.planes is not None and self.plane_dtype not in (
                torch.bfloat16, self.dtype):
            raise ValueError(f"FusedCG: the CUDA kernels take {self.dtype} "
                             f"vectors with {self.dtype} or bfloat16 planes, "
                             f"not {self.plane_dtype} planes")
        for t, name, dt in ((self.planes, "planes", self.plane_dtype),
                            (self.weight, "weight", self.dtype)):
            if t is not None and (t.device != v.device or t.dtype != dt):
                raise ValueError(f"FusedCG: {name} must be {dt} on "
                                 f"{v.device}, got {t.dtype} on {t.device}")
        lib = _build.library()
        ga, gb = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib.cgx_fused_a_grid(
            v.device.index, len(self.taps), int(self.planes is not None),
            int(self.sym), *self._bf16_flags(), ctypes.byref(ga)),
            "fused kernel A occupancy")
        _build.check(lib.cgx_fused_b_grid(
            v.device.index, int(self.weight is not None),
            self._bf16_flags()[0], ctypes.byref(gb)),
            "fused kernel B occupancy")
        return lib, ga.value, gb.value

    def _bf16_flags(self):
        """``(vec_bf16, plane_bf16)`` for the C entry points."""
        return (int(self.dtype == torch.bfloat16),
                int(self.plane_dtype == torch.bfloat16))

    def _a_args(self, p, q, part_a, ga, part_b, gb, ctl, hist, init=0):
        taps_c, coef_c, plane_c = plane_tap_arrays(self.taps, self.coeffs)
        ptr = (lambda t: None if t is None else t.data_ptr())
        return (p.data_ptr(), q.data_ptr(), ptr(self.planes),
                part_a.data_ptr(), ga, ptr(part_b), gb, ptr(ctl), ptr(hist),
                init, self.nx, self.ny, self.nz, len(self.taps), taps_c,
                coef_c, plane_c, int(self.sym), *self._bf16_flags(),
                torch.cuda.current_stream(p.device).cuda_stream)

    def _b_args(self, x, r, p, q, part_a, ga, part_b, gb, ctl):
        return (x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
                None if self.weight is None else self.weight.data_ptr(),
                part_a.data_ptr(), ga, part_b.data_ptr(), gb,
                ctl.data_ptr(), self.n, self._bf16_flags()[0],
                torch.cuda.current_stream(x.device).cuda_stream)

    def _launch_a(self, lib, args) -> None:
        global fused_a_launches, fused_a_bf16_launches
        global fused_a_bf16_planes_launches
        _build.check(lib.cgx_fused_a(*args), "fused kernel A launch")
        fused_a_launches += 1
        vec_bf16, plane_bf16 = self._bf16_flags()
        if vec_bf16:
            fused_a_bf16_launches += 1
        elif plane_bf16 and self.planes is not None:
            fused_a_bf16_planes_launches += 1

    def _launch_b(self, lib, args) -> None:
        global fused_b_launches, fused_b_bf16_launches
        _build.check(lib.cgx_fused_b(*args), "fused kernel B launch")
        fused_b_launches += 1
        if self._bf16_flags()[0]:
            fused_b_bf16_launches += 1

    def _run_cuda(self, state: FusedState, upto: int,
                  tol_sq) -> FusedState:
        from cgx_torch.kernels.stencil import check_cuda_vector

        lib, ga, gb = self._setup(state.x)
        dev = state.x.device
        for v, name in ((state.r, "r"), (state.p, "p")):
            check_cuda_vector(v, self.n, f"FusedCG state {name}", self.dtype)
        x, r, p = state.x.clone(), state.r.clone(), state.p.clone()
        q = torch.empty_like(x)
        part_a = torch.empty(2 * ga, dtype=torch.float64, device=dev)
        part_b = torch.empty(2 * gb, dtype=torch.float64, device=dev)
        hist = state.history.to(torch.float32).clone()
        ctl = torch.zeros(16, dtype=torch.int32, device=dev)
        f = ctl.view(torch.float32)
        f[_RZ:_RW + 1] = state.rz.to(torch.float32)
        ctl[_K] = state.k.to(torch.int32)
        f[_TOL] = torch.as_tensor(tol_sq, dtype=torch.float32, device=dev)
        ctl[_MAXIT] = min(upto, 2 ** 31 - 1)
        ctl[_HLEN] = hist.shape[0]
        args_a = self._a_args(p, q, part_a, ga, part_b, gb, ctl,
                              hist if hist.shape[0] else None)
        args_b = self._b_args(x, r, p, q, part_a, ga, part_b, gb, ctl)
        # At most upto − k + 1 (A, B) pairs: the last A takes the exit.
        budget, launched = max(upto, 0) + 1, 0
        with torch.cuda.device(dev):
            while True:
                chunk = min(CHUNK, budget - launched)
                for _ in range(chunk):
                    self._launch_a(lib, args_a)
                    self._launch_b(lib, args_b)
                launched += chunk
                if int(ctl[_DONE]):
                    break
                if launched >= budget:
                    raise RuntimeError("FusedCG: the kernels did not reach "
                                       "their exit")
        return FusedState(x=x, r=r, p=p, rz=f[_RZ:_RW + 1].clone(),
                          k=ctl[_K].clone(), history=hist)

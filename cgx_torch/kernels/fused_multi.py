"""K5: the two-pass CG engine over k right-hand sides — CUDA kernels A and B,
their plain versions, and the multi-RHS fused solvers.

Counterpart of :mod:`cgx.kernels.fused_multi` (``_solve_multi``,
``fused_stencil_cg_multi``, ``fused_dia_cg_multi``).  Per iteration, for
every column j of the block:

  A. ``q_j = Ã p_j`` with ``Σ p_j·q_j`` and ``Σ q_j·q_j``;
  B. ``live = rz_j > 0 and pq_j > 0``, ``α = live ? rz/pq : 0``,
     ``β = live ? (α²·qq − rz)/rz : 0``, then ``x += αp``, ``r −= αq``,
     ``p = r + βp`` with ``Σ r_j²`` and ``Σ r_j²·w`` (one weight vector for
     all columns).

The iteration count is shared: the loop runs until every column meets its
tolerance (or ``maxiter``), and a column that has converged keeps iterating
with the others; only a column whose ``rz`` or ``pq`` reaches 0 is frozen.
``iterations`` is the shared count broadcast to ``(k,)``; the residuals and
``converged`` are per column.  The sums are taken exactly, as K3 takes them
(:mod:`cgx_torch.kernels.fused_engine`): a column of K5 rounds as K3 rounds
it, so the column that exits last follows its single-RHS solve.

The port keeps the block as k flat columns, ``(k, n)`` contiguous (the JAX
package's ``b.T``).  The band-stacked TPU layout (``_to_layout_multi``, the
``bps`` band tiling, VMEM limits) and ``_exchange_multi`` (distribution)
are not ported; neither is ``plane_dtype`` (ROADMAP queue A item 11).

On a CUDA tensor :meth:`FusedCGMulti.run` launches kernel A and kernel B of
``cgx_torch/csrc/fused_multi.cu`` once per iteration from a Python loop,
with α, β and the shared exit on the device; the host reads one flag per
:data:`~cgx_torch.kernels.fused_engine.CHUNK` iterations.  On a CPU tensor
it takes the plain version, :meth:`FusedCGMulti.run_reference`.
``multi_a_launches`` and ``multi_b_launches`` count the kernels' launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from cgx_torch.kernels import _build
from cgx_torch.kernels.fused_cg import stencil_taps, supports
from cgx_torch.kernels.fused_dia_cg import (_no_plane_dtype, dia_prep,
                                            wrap_entries_zero_or_none)
from cgx_torch.kernels.fused_engine import (CHUNK, FusedCG, exact_sums,
                                            plane_tap_arrays, threshold)
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult

__all__ = ["FusedCGMulti", "FusedMultiState", "thresholds",
           "fused_stencil_cg_multi", "fused_dia_cg_multi",
           "multi_a_launches", "multi_b_launches"]

# Kernel launches so far (a run resets them to show which kernels it used).
multi_a_launches = 0
multi_b_launches = 0

# The device control block (fused_multi.cu): header words, then five float
# arrays of k columns in this order.
_IT, _DONE, _MAXIT, _HEAD = 0, 1, 2, 8
_RZ, _RW, _PQ, _QQ, _TOL = range(5)


def thresholds(b: torch.Tensor, tol: float, atol: float,
               weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per column of ``b`` (``(k, n)``) the single-RHS exit threshold
    :func:`~cgx_torch.kernels.fused_engine.threshold`, ``(k,)`` fp32."""
    return torch.stack([threshold(b[j], tol, atol, weight)
                        for j in range(b.shape[0])])


@dataclass(frozen=True, eq=False)
class FusedMultiState:
    """CG state of the engine for k columns (the chunk unit of
    init/run/result)."""

    x: torch.Tensor    # (k, n)
    r: torch.Tensor    # (k, n)
    p: torch.Tensor    # (k, n)
    rz: torch.Tensor   # (2, k) fp32: [solve-space Σr̃², weighted Σr̃²·w]
    k: torch.Tensor    # int32, shared by the columns


class FusedCGMulti(FusedCG):
    """The two-pass solver for one operator and a block of right-hand
    sides, in the solve space.  Constructed as
    :class:`~cgx_torch.kernels.fused_engine.FusedCG` (taps, constant
    coefficients or planes, ``weight``, ``sym``); ``matvec`` is the plain
    operator on one column.  Blocks are ``(k, n)``: row j is column j."""

    # -- the two kernels -------------------------------------------------

    def kernel_a_reference(self, p: torch.Tensor):
        """Plain kernel A: ``(Q, Σ p·q, Σ q·q)``, the sums ``(k,)`` exact
        to fp32, each column as K3's plain version computes it."""
        cols = [FusedCG.kernel_a_reference(self, p[j])
                for j in range(p.shape[0])]
        return (torch.stack([c[0] for c in cols]),
                torch.stack([c[1] for c in cols]),
                torch.stack([c[2] for c in cols]))

    def kernel_b_reference(self, rz, pq, qq, x, r, p, q):
        """Plain kernel B: ``(X', R', P', Σ r'², Σ r'²·w)``, the sums
        ``(k,)``; a column with ``rz`` or ``pq`` at 0 is frozen."""
        zero = torch.zeros_like(rz)
        one = torch.ones_like(rz)
        live = (rz > 0) & (pq > 0)
        alpha32 = torch.where(live, rz / torch.where(pq > 0, pq, one), zero)
        beta = torch.where(live, (alpha32 * alpha32 * qq - rz)
                           / torch.where(rz > 0, rz, one), zero)
        alpha = alpha32.to(x.dtype)[:, None]
        beta = beta.to(p.dtype)[:, None]
        x = x + alpha * p
        r_new = r - alpha * q
        sums = [exact_sums(r_new[j], self.weight) for j in range(x.shape[0])]
        return (x, r_new, r_new + beta * p,
                torch.stack([s[0] for s in sums]),
                torch.stack([s[1] for s in sums]))

    def kernel_a(self, p: torch.Tensor):
        """Kernel A once: ``(Q, Σ p·q, Σ q·q)``.  A CPU tensor takes the
        plain version; on a CUDA tensor the sums are the kernel's own."""
        if p.device.type == "cpu":
            return self.kernel_a_reference(p)
        lib, ga, _ = self._setup(p)
        q = torch.empty_like(p)
        ctl, f = self._ctl(p.shape[0], p.device)
        part = torch.empty(2 * p.shape[0] * ga, dtype=torch.float64,
                           device=p.device)
        with torch.cuda.device(p.device):
            self._launch_a(lib, self._a_args(p, q, part, ga, ctl))
        return q, self._field(f, _PQ).clone(), self._field(f, _QQ).clone()

    def kernel_b(self, rz, pq, qq, x, r, p, q):
        """Kernel B once on copies of ``X, R, P``: ``(X', R', P', Σ r'²,
        Σ r'²·w)``.  A CPU tensor takes the plain version."""
        if x.device.type == "cpu":
            return self.kernel_b_reference(rz, pq, qq, x, r, p, q)
        lib, _, gb = self._setup(x)
        k, dev = x.shape[0], x.device
        x, r, p = x.clone(), r.clone(), p.clone()
        ctl, f = self._ctl(k, dev)
        for fld, v in ((_RZ, rz), (_PQ, pq), (_QQ, qq)):
            self._field(f, fld).copy_(torch.as_tensor(v, dtype=torch.float32,
                                                      device=dev))
        ctl[_MAXIT] = 2 ** 31 - 1
        part = torch.empty(2 * k * gb, dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            self._launch_b(lib, self._b_args(x, r, p, q, part, gb, ctl))
        return (x, r, p, self._field(f, _RZ).clone(),
                self._field(f, _RW).clone())

    # -- chunked-stepping primitives -------------------------------------

    def init(self, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None) -> FusedMultiState:
        """Initial state from the solve-space block ``b`` (``(k, n)``);
        ``x0`` goes through kernel A (``R₀ = B − Ã·X₀``)."""
        return self._init(b, x0, self.kernel_a)

    def _init(self, b, x0, kernel_a) -> FusedMultiState:
        b = b.to(self.dtype).contiguous()
        if x0 is None:
            x, r = torch.zeros_like(b), b
        else:
            x = x0.to(self.dtype).contiguous().clone()
            r = b - kernel_a(x)[0]
        sums = [exact_sums(r[j], self.weight) for j in range(b.shape[0])]
        rz = torch.stack([torch.stack([s[0] for s in sums]),
                          torch.stack([s[1] for s in sums])])
        return FusedMultiState(x=x, r=r, p=r, rz=rz,
                               k=torch.zeros((), dtype=torch.int32,
                                             device=b.device))

    def run(self, state: FusedMultiState, upto: int,
            tol_sq) -> FusedMultiState:
        """Advance until ``k == upto`` or every column's weighted
        ``Σr²·w ≤ tol_sq`` (``(k,)``).  A CPU state takes the plain
        version."""
        if state.x.device.type == "cpu":
            return self.run_reference(state, upto, tol_sq)
        return self._run_cuda(state, int(upto), tol_sq)

    def run_reference(self, state: FusedMultiState, upto: int,
                      tol_sq) -> FusedMultiState:
        """Plain version of :meth:`run`: the same two passes as a Python
        loop with one host read per iteration (any device)."""
        x, r, p = state.x, state.r, state.p
        rz, rw = state.rz[0], state.rz[1]
        k = int(state.k)
        while k < upto and bool(torch.any(rw > tol_sq)):
            q, pq, qq = self.kernel_a_reference(p)
            x, r, p, rz, rw = self.kernel_b_reference(rz, pq, qq, x, r, p, q)
            k += 1
        return FusedMultiState(x=x, r=r, p=p, rz=torch.stack([rz, rw]),
                               k=torch.tensor(k, dtype=torch.int32,
                                              device=x.device))

    def result(self, state: FusedMultiState, tol_sq) -> CGResult:
        """Package a :class:`CGResult`: ``x`` is ``(n, k)`` (a view of the
        ``(k, n)`` block), ``iterations`` the shared count as ``(k,)``."""
        k = state.x.shape[0]
        return CGResult(x=state.x.T, iterations=state.k.reshape(1).expand(
                            k).clone(),
                        residual_norm_sq=state.rz[1],
                        converged=state.rz[1] <= tol_sq,
                        history=torch.zeros(0, dtype=torch.float32,
                                            device=state.x.device))

    # -- monolithic solve ---------------------------------------------------

    def solve(self, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
              atol: float = 0.0, maxiter: int = 1000) -> CGResult:
        """Batched CG on the solve-space block ``b`` (``(k, n)``; the
        caller applies any scaling)."""
        return self._solve(b, x0, tol, atol, maxiter, self.kernel_a,
                           self.run)

    def solve_reference(self, b: torch.Tensor, x0=None, *,
                        tol: float = 1e-6, atol: float = 0.0,
                        maxiter: int = 1000) -> CGResult:
        """:meth:`solve` through the plain versions only (any device)."""
        return self._solve(b, x0, tol, atol, maxiter,
                           self.kernel_a_reference, self.run_reference)

    def _solve(self, b, x0, tol, atol, maxiter, kernel_a, run) -> CGResult:
        tol_sq = thresholds(b, tol, atol, self.weight)
        st = self._init(b, x0, kernel_a)
        st = run(st, int(maxiter), tol_sq)
        return self.result(st, tol_sq)

    # -- the CUDA path --------------------------------------------------------

    def _setup(self, v: torch.Tensor):
        """Checks, the library and the grids ``(lib, grid_a, grid_b)``."""
        if v.device.type != "cuda":
            raise ValueError(f"FusedCGMulti: unsupported device {v.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"FusedCGMulti: the CUDA kernels take float32, "
                            f"got {v.dtype}")
        if v.dim() != 2 or v.shape[1] != self.n or v.shape[0] < 1:
            raise ValueError(f"FusedCGMulti: expected a block of shape (k, "
                             f"{self.n}), got {tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError("FusedCGMulti: the CUDA kernels need a "
                             "contiguous block")
        if self.n >= 2 ** 31:
            raise ValueError(f"FusedCGMulti: {self.n} rows do not fit int32 "
                             f"row indexing")
        for t, name in ((self.planes, "planes"), (self.weight, "weight")):
            if t is not None and (t.device != v.device
                                  or t.dtype != torch.float32):
                raise ValueError(f"FusedCGMulti: {name} must be float32 on "
                                 f"{v.device}, got {t.dtype} on {t.device}")
        lib = _build.library()
        ga, gb = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib.cgx_multi_a_grid(
            v.device.index, len(self.taps), int(self.planes is not None),
            int(self.sym), ctypes.byref(ga)), "multi kernel A occupancy")
        _build.check(lib.cgx_multi_b_grid(
            v.device.index, int(self.weight is not None), ctypes.byref(gb)),
            "multi kernel B occupancy")
        return lib, ga.value, gb.value

    @staticmethod
    def _ctl(k: int, dev):
        """A zeroed control block for k columns and its float view."""
        ctl = torch.zeros(_HEAD + 5 * k, dtype=torch.int32, device=dev)
        return ctl, ctl.view(torch.float32)

    @staticmethod
    def _field(f: torch.Tensor, fld: int) -> torch.Tensor:
        k = (f.shape[0] - _HEAD) // 5
        return f[_HEAD + fld * k:_HEAD + (fld + 1) * k]

    def _a_args(self, p, q, part, ga, ctl):
        taps_c, coef_c, plane_c = plane_tap_arrays(self.taps, self.coeffs)
        return (p.data_ptr(), q.data_ptr(),
                None if self.planes is None else self.planes.data_ptr(),
                part.data_ptr(), ga, ctl.data_ptr(), p.shape[0], self.nx,
                self.ny, self.nz, len(self.taps), taps_c, coef_c, plane_c,
                int(self.sym), torch.cuda.current_stream(p.device).cuda_stream)

    def _b_args(self, x, r, p, q, part, gb, ctl):
        return (x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
                None if self.weight is None else self.weight.data_ptr(),
                part.data_ptr(), gb, ctl.data_ptr(), x.shape[0], self.n,
                torch.cuda.current_stream(x.device).cuda_stream)

    @staticmethod
    def _launch_a(lib, args) -> None:
        global multi_a_launches
        _build.check(lib.cgx_multi_a(*args), "multi kernel A launch")
        multi_a_launches += 1

    @staticmethod
    def _launch_b(lib, args) -> None:
        global multi_b_launches
        _build.check(lib.cgx_multi_b(*args), "multi kernel B launch")
        multi_b_launches += 1

    def _run_cuda(self, state: FusedMultiState, upto: int,
                  tol_sq) -> FusedMultiState:
        lib, ga, gb = self._setup(state.x)
        k, dev = state.x.shape[0], state.x.device
        for v, name in ((state.r, "r"), (state.p, "p")):
            if v.shape != state.x.shape or not v.is_contiguous():
                raise ValueError(f"FusedCGMulti state {name}: expected a "
                                 f"contiguous block like x")
        x, r, p = state.x.clone(), state.r.clone(), state.p.clone()
        q = torch.empty_like(x)
        part_a = torch.empty(2 * k * ga, dtype=torch.float64, device=dev)
        part_b = torch.empty(2 * k * gb, dtype=torch.float64, device=dev)
        ctl, f = self._ctl(k, dev)
        rz = state.rz.to(torch.float32)
        tol = torch.as_tensor(tol_sq, dtype=torch.float32,
                              device=dev).expand(k)
        self._field(f, _RZ).copy_(rz[0])
        self._field(f, _RW).copy_(rz[1])
        self._field(f, _TOL).copy_(tol)
        upto = min(max(upto, 0), 2 ** 31 - 1)
        ctl[_IT] = state.k.to(torch.int32)
        ctl[_MAXIT] = upto
        # The entry test on the device: no host read before the first chunk.
        ctl[_DONE] = (~((state.k < upto) & torch.any(rz[1] > tol))).to(
            torch.int32)
        args_a = self._a_args(p, q, part_a, ga, ctl)
        args_b = self._b_args(x, r, p, q, part_b, gb, ctl)
        # At most upto − k (A, B) pairs: B counts the last one and exits.
        budget, launched = upto, 0
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
                    raise RuntimeError("FusedCGMulti: the kernels did not "
                                       "reach their exit")
        return FusedMultiState(
            x=x, r=r, p=p,
            rz=torch.stack([self._field(f, _RZ), self._field(f, _RW)]).clone(),
            k=ctl[_IT].clone())


def fused_stencil_cg_multi(s, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                           atol: float = 0.0,
                           maxiter: int = 1000) -> CGResult:
    """Batched fused CG on a constant-coefficient stencil; ``b``: (n, k).

    Semantics of :func:`cgx_torch.solve.block.cg_solve_multi` except that
    the iteration count is shared (the loop runs until every column
    converges; per-column ``converged`` and residuals are reported).
    """
    if b.dim() != 2:
        raise ValueError(f"expected b of shape (n, k), got {tuple(b.shape)}")
    spec = stencil_taps(s)
    if spec is None or not supports(s):
        raise ValueError("unsupported operator for the fused multi path")
    nx, ny, nz, taps, coeffs = spec
    eng = FusedCGMulti(nx, ny, nz, taps, dtype=b.dtype, coeffs=coeffs)
    return eng.solve(b.T, None if x0 is None else x0.T, tol=tol, atol=atol,
                     maxiter=int(maxiter))


def fused_dia_cg_multi(d, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                       atol: float = 0.0, maxiter: int = 1000,
                       jacobi: bool = True, inv_diag=None, plane_dtype=None,
                       assume_symmetric: Optional[bool] = None) -> CGResult:
    """Batched fused Jacobi-PCG (plain CG with ``jacobi=False``) on a banded
    DIA operator; ``b``: (n, k).  The DIA preparation and ``inv_diag`` are
    those of :func:`cgx_torch.kernels.fused_dia_cg.fused_dia_cg`; the
    planes are shared by the columns."""
    _no_plane_dtype(plane_dtype)
    if b.dim() != 2:
        raise ValueError(f"expected b of shape (n, k), got {tuple(b.shape)}")
    if wrap_entries_zero_or_none(d) is False:
        raise ValueError("DIA data has nonzero x-plane-crossing entries")
    nx, ny, nz, taps, coeffs, planes, e, weight, sym = dia_prep(
        d, b.dtype, jacobi=jacobi, inv_diag=inv_diag,
        assume_symmetric=assume_symmetric)
    eng = FusedCGMulti(nx, ny, nz, taps, dtype=b.dtype, coeffs=coeffs,
                       planes=planes, weight=weight, sym=sym)
    b2 = b.T
    x0_2 = None if x0 is None else x0.T
    if e is not None:
        b2 = b2 * e[None]
        if x0_2 is not None:
            x0_2 = x0_2 * safe_recip(e)[None]
    res = eng.solve(b2, x0_2, tol=tol, atol=atol, maxiter=int(maxiter))
    if e is not None:
        res = dataclasses.replace(res, x=res.x * e[:, None])
    return res

"""Checkpoint, resume and elastic recovery for iterative solves (PyTorch).

Counterpart of :mod:`cgx.utils.checkpoint`.  CG is restartable by
construction: the O(n) :class:`~cgx_torch.solve.cg.CGState` is a complete
snapshot, the solver advances in chunks, and every chunk boundary is a
checkpoint.  Snapshots are host ``.npz`` files written atomically (a
temporary file, then ``os.replace``) with the JAX package's field names
and dtypes, so either package resumes the other's files.

bfloat16: the JAX package writes a bf16 field through ``ml_dtypes``,
which ``np.load`` returns as raw 2-byte void (``|V2``); the port reads
such a field as its ``uint16`` bits and views them as bfloat16.  The port
has no ``ml_dtypes`` and writes a bf16 field as fp32.  bf16 → fp32 → bf16
is exact, so nothing is lost either way.

:func:`make_checkpointed_solver` builds the operator's engine once and
returns a reusable solver; :func:`cg_solve_checkpointed` is the one-shot
form.  Four backends, each a kernel path of the port:

* ``"xla"`` — :func:`~cgx_torch.solve.cg.cg_init` /
  :func:`~cgx_torch.solve.cg.cg_chunk` over any operator or
  preconditioner (WBELL's ``("poly", steps, omega)`` spec included);
* ``"fused"`` — the two-pass engine K3 (``FusedCG.run(upto)``);
* ``"resident"`` — the whole-solve kernel K2 through its resume state;
* ``"sr"`` — the semi-resident kernel K4 through its resume state.

On a CPU tensor each engine takes its plain version, as the engines do.
The state between chunks stays in the engine's own form, so a chunked
solve is the monolithic one bit for bit; the snapshot files hold the
unscaled flat state, so a file written by one backend resumes under any
other.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from cgx_torch.io.native_format import _np, _t
from cgx_torch.solve.cg import CGResult, CGState, _tol_sq, cg_chunk, cg_init

__all__ = ["save_state", "load_state", "cg_solve_checkpointed",
           "make_checkpointed_solver", "to_flat", "from_flat"]

_FIELDS = ("x", "r", "z", "p", "rz", "rr", "k", "history")


def save_state(path: str, state) -> None:
    """Atomically snapshot a :class:`CGState` (the port's, or anything with
    its fields) to ``.npz``."""
    arrays = {f: _np(getattr(state, f)) for f in _FIELDS}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str, device="cuda") -> CGState:
    """Load a snapshot (written by either package) into a
    :class:`CGState` on ``device``."""
    from cgx_torch.sparse.types import resolve_device

    dev = resolve_device(device)
    with np.load(path) as z:
        return CGState(**{f: _t(z[f], dev) for f in _FIELDS})


def make_checkpointed_solver(a, *, tol: float = 1e-6, atol: float = 0.0,
                             maxiter: Optional[int] = None,
                             preconditioner=None, chunk: int = 100,
                             backend: str = "xla"
                             ) -> Callable[..., CGResult]:
    """A reusable chunked solver for operator ``a``: ``solve(b, x0=None,
    *, checkpoint_path=None, on_chunk=None)`` with
    :func:`cg_solve_checkpointed`'s semantics.  The engine is built once
    (per vector dtype) and shared across calls.

    ``backend``: ``"xla"`` (any operator and preconditioner), ``"fused"``
    (K3), ``"resident"`` (K2) or ``"sr"`` (K4); the last three take a
    constant-coefficient stencil (no preconditioner) or a wrap-free DIA
    operator (None or Jacobi).  Snapshot files are interchangeable between
    backends.
    """
    if backend == "fused":
        return _make_fused_checkpointed(
            a, tol=tol, atol=atol, maxiter=maxiter,
            preconditioner=preconditioner, chunk=chunk)
    if backend in ("resident", "sr"):
        return _make_whole_solve_checkpointed(
            a, tol=tol, atol=atol, maxiter=maxiter,
            preconditioner=preconditioner, chunk=chunk, kind=backend)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")

    if (isinstance(preconditioner, tuple) and preconditioner
            and preconditioner[0] == "poly"):
        # ("poly", steps, omega): the polynomial apply over WBELL's planes.
        from cgx_torch.ops.blas import safe_recip
        from cgx_torch.solve.wbell import wbell_poly_apply
        from cgx_torch.sparse.wbell import WBELLMatrix

        if not isinstance(a, WBELLMatrix):
            raise ValueError("preconditioner=('poly', ...) is the WBELL "
                             "internal-layout spec; pass a callable or "
                             "PolynomialPrecond for other operators")
        steps = int(preconditioner[1])
        omega = (float(preconditioner[2]) if len(preconditioner) > 2
                 else 2.0 / 3.0)
        idi = safe_recip(a.diag_internal)

        def preconditioner(r):
            return wbell_poly_apply(a, r, idi, steps, omega)

    def solve(b, x0=None, *, checkpoint_path: Optional[str] = None,
              on_chunk: Optional[Callable[[CGState], None]] = None
              ) -> CGResult:
        # The default cap is the CG dimension bound.  b may come in an
        # internal layout (WBELL's (nt, 8, 128)): count its elements.
        mi = int(maxiter) if maxiter is not None else int(b.numel())
        if checkpoint_path and os.path.exists(checkpoint_path):
            state = load_state(checkpoint_path, device=b.device)
        else:
            state = cg_init(a, b, x0, preconditioner=preconditioner)
        tol_sq = _tol_sq(tol, atol, b)

        while int(state.k) < mi and float(state.rr) > float(tol_sq):
            iters = min(chunk, mi - int(state.k))
            state = cg_chunk(a, state, iters, b=b, tol=tol, atol=atol,
                             preconditioner=preconditioner)
            if checkpoint_path:
                save_state(checkpoint_path, state)
            if on_chunk is not None:
                on_chunk(state)

        return CGResult(x=state.x, iterations=state.k,
                        residual_norm_sq=state.rr,
                        converged=state.rr <= tol_sq,
                        history=state.history)

    return solve


def cg_solve_checkpointed(a, b, x0=None, *, tol: float = 1e-6,
                          atol: float = 0.0, maxiter: Optional[int] = None,
                          preconditioner=None, chunk: int = 100,
                          checkpoint_path: Optional[str] = None,
                          on_chunk: Optional[Callable[[CGState],
                                                      None]] = None,
                          backend: str = "xla") -> CGResult:
    """``cg_solve`` semantics with a snapshot every ``chunk`` iterations.

    If ``checkpoint_path`` exists the solve resumes from it (recovery
    after preemption: relaunch with the same arguments).  Chunking only
    moves where the host observes the state, so the trajectory is the
    uninterrupted solve's.  One-shot wrapper over
    :func:`make_checkpointed_solver`.
    """
    solver = make_checkpointed_solver(
        a, tol=tol, atol=atol, maxiter=maxiter,
        preconditioner=preconditioner, chunk=chunk, backend=backend)
    return solver(b, x0, checkpoint_path=checkpoint_path, on_chunk=on_chunk)


def _engine_form(a, preconditioner, backend: str) -> bool:
    """Check that a kernel backend takes ``a`` and ``preconditioner``;
    True for a stencil, False for a DIA operator."""
    from cgx_torch.kernels.fused_cg import supports
    from cgx_torch.kernels.fused_dia_cg import (supports_dia,
                                                wrap_entries_zero_or_none)
    from cgx_torch.solve.precond import JacobiPrecond

    if supports(a):
        if preconditioner is not None:
            raise ValueError(f"{backend} stencil backend: preconditioner "
                             "must be None (constant-diagonal operators: "
                             "Jacobi is an exact rescaling)")
        return True
    if supports_dia(a) and wrap_entries_zero_or_none(a) is True:
        if preconditioner is not None and not isinstance(preconditioner,
                                                         JacobiPrecond):
            raise ValueError(f"{backend} DIA backend supports only Jacobi "
                             "preconditioning")
        return False
    raise ValueError(f"backend={backend!r}: operator is not fused-capable "
                     "(need a supported stencil or wrap-free DIA)")


def _jacobi(preconditioner):
    from cgx_torch.solve.precond import JacobiPrecond

    jac = isinstance(preconditioner, JacobiPrecond)
    return jac, (preconditioner.inv_diag if jac else None)


def to_flat(x, r, p, rz, rr, k, history, e=None) -> CGState:
    """The flat :class:`CGState` of a solve scaled by the Jacobi vector
    ``e`` (or None), in the original problem space: ``x = e·x̃``,
    ``r = r̃/e``, ``p = e·p̃`` and ``z = M⁻¹r = e·r̃``.  The form of every
    backend's snapshot file."""
    from cgx_torch.ops.blas import safe_recip

    if e is not None:
        inv_e = safe_recip(e)
        x, r, p, z = e * x, inv_e * r, e * p, e * r
    else:
        z = r
    return CGState(x=x, r=r, z=z, p=p, rz=rz.to(x.dtype), rr=rr.to(x.dtype),
                   k=torch.as_tensor(k, dtype=torch.int32, device=x.device),
                   history=history.to(x.dtype))


def from_flat(cg: CGState, e=None):
    """Inverse of :func:`to_flat`: ``(x̃, r̃, p̃)``.  The scaling's round
    trip ``e·(x/e)`` may move the last bit of a scaled state."""
    from cgx_torch.ops.blas import safe_recip

    x, r, p = cg.x, cg.r, cg.p
    if e is not None:
        inv_e = safe_recip(e)
        x, r, p = inv_e * x, e * r, inv_e * p
    return x, r, p


def _make_fused_checkpointed(a, *, tol, atol, maxiter, preconditioner,
                             chunk) -> Callable[..., CGResult]:
    """Chunked two-pass engine (K3): ``eng.run`` to each chunk's end, the
    snapshot through :meth:`FusedCG.state_to_flat`."""
    from cgx_torch.kernels.fused_cg import build_fused
    from cgx_torch.kernels.fused_dia_cg import build_fused_dia
    from cgx_torch.kernels.fused_engine import threshold
    from cgx_torch.ops.blas import safe_recip

    is_stencil = _engine_form(a, preconditioner, "fused")
    jac, inv_diag = _jacobi(preconditioner)
    cache = {}

    def built(dtype):
        if dtype not in cache:
            if is_stencil:
                cache[dtype] = (build_fused(a, dtype), None)
            else:
                eng, e, _ = build_fused_dia(a, dtype, jacobi=jac,
                                            inv_diag=inv_diag)
                cache[dtype] = (eng, e)
        return cache[dtype]

    def solve(b, x0=None, *, checkpoint_path: Optional[str] = None,
              on_chunk: Optional[Callable[[CGState], None]] = None
              ) -> CGResult:
        mi = int(maxiter) if maxiter is not None else b.shape[0]
        eng, e = built(b.dtype)
        b_s = e * b if e is not None else b
        x0_s = x0
        if x0 is not None and e is not None:
            x0_s = x0 * safe_recip(e)
        tol_sq = threshold(b_s, tol, atol, eng.weight)

        if checkpoint_path and os.path.exists(checkpoint_path):
            st = eng.state_from_flat(
                load_state(checkpoint_path, device=b.device), e)
        else:
            st = eng.init(b_s, x0_s)

        while int(st.k) < mi and float(st.rz[1]) > float(tol_sq):
            st = eng.run(st, min(int(st.k) + chunk, mi), tol_sq)
            if checkpoint_path or on_chunk is not None:
                flat = eng.state_to_flat(st, e)
                if checkpoint_path:
                    save_state(checkpoint_path, flat)
                if on_chunk is not None:
                    on_chunk(flat)

        res = eng.result(st, tol_sq)
        if e is not None:
            res = dataclasses.replace(res, x=e * res.x)
        return res

    return solve


def _make_whole_solve_checkpointed(a, *, tol, atol, maxiter, preconditioner,
                                   chunk, kind) -> Callable[..., CGResult]:
    """Chunked whole-solve kernels: K2 (``kind="resident"``) or K4
    (``"sr"``).  The kernel's ``maxiter`` becomes the chunk length and
    ``(x, r, p, rz, rw)`` round-trip through its resume inputs; every
    chunk boundary can snapshot the unscaled flat state.  When ``maxiter``
    is already spent, one 0-iteration call reports the true residual (a
    fresh one when no chunk ran, so the all-zero seed cannot fake
    convergence)."""
    from cgx_torch.kernels.fused_cg import stencil_taps
    from cgx_torch.kernels.fused_dia_cg import dia_prep
    from cgx_torch.kernels.fused_resident import resident_cg_call
    from cgx_torch.kernels.fused_semiresident import (make_sr_geometry,
                                                      sr_cg_call)
    from cgx_torch.ops.blas import safe_recip
    from cgx_torch.ops.spmv import spmv

    is_stencil = _engine_form(a, preconditioner, kind)
    jac, inv_diag = _jacobi(preconditioner)
    cache = {}

    def built(dtype):
        if dtype in cache:
            return cache[dtype]
        if is_stencil:
            nx, ny, nz, taps, coeffs = stencil_taps(a)
            planes = weight = e = None
            sym = False
        else:
            nx, ny, nz, taps, coeffs, planes, e, weight, sym = dia_prep(
                a, dtype, jacobi=jac, inv_diag=inv_diag)
        if kind == "sr":
            itemsize = torch.empty((), dtype=dtype).element_size()
            g = (make_sr_geometry(nx, ny, nz, taps, itemsize=itemsize)
                 if is_stencil else make_sr_geometry(
                     nx, ny, nz, taps, n_planes=int(planes.shape[0]),
                     weighted=weight is not None, sym=sym,
                     itemsize=itemsize))

            def step(first, x, r, p, rz, rw, bb, iters, fresh):
                return sr_cg_call(
                    g, first, coeffs=coeffs, tol=tol, atol=atol,
                    maxiter=iters, planes=planes, w=weight, b_norm_sq=bb,
                    resume=None if fresh else (x, r, p, rz, rw),
                    x0_l=x if fresh else None)
        else:
            spec = (nx, ny, nz, taps, coeffs)

            def step(first, x, r, p, rz, rw, bb, iters, fresh):
                return resident_cg_call(
                    spec, first, x if fresh else None, planes=planes,
                    weight=weight, sym=sym, tol=tol, atol=atol,
                    maxiter=iters,
                    resume=None if fresh else (x, r, p, rz, rw))
        cache[dtype] = (step, e)
        return cache[dtype]

    def solve(b, x0=None, *, checkpoint_path: Optional[str] = None,
              on_chunk: Optional[Callable[[CGState], None]] = None
              ) -> CGResult:
        mi = int(maxiter) if maxiter is not None else b.shape[0]
        step, e = built(b.dtype)
        # K4 takes r₀ (the residual of x0) and the true ‖b‖²; K2 takes the
        # scaled b and x0 and forms r₀ itself.
        bb = torch.sum(b.to(torch.float32) ** 2) if kind == "sr" else None
        if kind == "sr":
            r0 = b if x0 is None else b - spmv(a, x0)
            first = e * r0 if e is not None else r0
        else:
            first = e * b if e is not None else b

        if checkpoint_path and os.path.exists(checkpoint_path):
            cg = load_state(checkpoint_path, device=b.device)
            x, r, p = (v.to(b.dtype) for v in from_flat(cg, e))
            rz = torch.as_tensor(cg.rz).to(torch.float32)
            rw = torch.as_tensor(cg.rr).to(torch.float32)
            k_tot = int(cg.k)
            fresh = False
        else:
            if x0 is None:
                x = torch.zeros_like(b)
            elif e is not None:
                x = (x0 * safe_recip(e)).to(b.dtype)
            else:
                x = x0.to(b.dtype)
            r = p = torch.zeros_like(x)
            rz = rw = torch.zeros((), dtype=torch.float32, device=b.device)
            k_tot = 0
            fresh = True

        tol_sq = None
        while True:
            iters = min(chunk, mi - k_tot)
            if iters <= 0:
                break
            x, r, p, k, rzv, tol_sq = step(first, x, r, p, rz, rw, bb,
                                           iters, fresh)
            fresh = False
            k_tot += int(k)
            rz, rw = rzv[0], rzv[1]
            if checkpoint_path or on_chunk is not None:
                flat = to_flat(x, r, p, rz, rw, k_tot,
                               torch.zeros(0, device=x.device), e)
                if checkpoint_path:
                    save_state(checkpoint_path, flat)
                if on_chunk is not None:
                    on_chunk(flat)
            if float(rw) <= float(tol_sq):
                break

        if tol_sq is None:          # maxiter already spent: a 0-iteration
            # call for the true residual
            x, r, p, _, rzv, tol_sq = step(first, x, r, p, rz, rw, bb, 0,
                                           fresh)
            rw = rzv[1]
        if e is not None:
            x = e * x
        dev = b.device
        return CGResult(x=x, iterations=torch.tensor(k_tot,
                                                     dtype=torch.int32,
                                                     device=dev),
                        residual_norm_sq=rw.to(torch.float32),
                        converged=torch.tensor(float(rw) <= float(tol_sq),
                                               device=dev),
                        history=torch.zeros(0, dtype=torch.float32,
                                            device=b.device))

    return solve

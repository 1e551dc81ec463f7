"""Conjugate-gradient solver (PyTorch).

Counterpart of :mod:`cgx.solve.cg`: the same textbook Hestenes–Stiefel
(P)CG recurrence with the ``rᵀr`` reuse, the same convergence test
(``‖r‖² ≤ max(tol²·‖b‖², atol²)``, capped at ``maxiter``) and the same
state.  ``tol=0`` with ``atol=0`` keeps the reference's fixed-count
trajectory (the C program runs ``max_iter + 1`` updates, so pass
``maxiter=max_iter + 1``).

The JAX package runs the loop as one ``lax.while_loop`` on the device.
Here it is a Python ``while`` over the same ``cond``/``body``: each test of
``cond`` reads one boolean back from the device.  The whole-solve CUDA
kernel (:mod:`cgx_torch.kernels.fused_resident`) is the path that keeps
the loop on the device.

:func:`cg_solve_single_reduction` (Chronopoulos–Gear) and
:func:`cg_solve_pipelined` (Ghysels–Vanroose, with periodic or adaptive
residual replacement) keep their fused dots as one stacked tensor, the
one all-reduce of a distributed solve.  Each reads the device once
an iteration: the single-reduction loop its exit test; the pipelined loop
its exit test together with the replacement flag and the stagnation
guard's strikes (see :func:`cg_solve_pipelined`).

Distribution (the JAX package's ``axis_name``): with ``group=`` (a
``torch.distributed`` process group) ``b``, ``x0`` and the matvec are one
rank's rows, and every dot becomes one all-reduce over the group of the
stacked local dots the loop already forms
(:func:`cgx_torch.dist.halo.all_reduce`, counted): :func:`cg_solve` makes
two an iteration, the single-reduction and pipelined loops one.  The
default ``maxiter`` is the global size.  Every rank reads the same reduced
bits, so every rank takes the same exit.  With ``group=None`` nothing
changes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional, Union

import torch

from cgx_torch.ops import blas
from cgx_torch.ops.spmv import spmv
from cgx_torch.utils.profiling import ENGINE, PREP, RESULT, annotate, host_read

__all__ = ["CGResult", "CGState", "cg_solve", "cg_solve_single_reduction",
           "cg_solve_pipelined", "cg_init", "cg_chunk", "as_matvec"]

MatVec = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class CGResult:
    """Solver output; every field is a tensor on the solve's device."""

    x: torch.Tensor                 # solution iterate
    iterations: torch.Tensor        # int32 — CG iterations performed
    residual_norm_sq: torch.Tensor  # ‖r‖² of the recurrence at exit
    converged: torch.Tensor         # bool — hit the tolerance before maxiter
    # ‖r_k‖² for k = 0..maxiter (padded with the last value after exit);
    # only populated when track_history=True, else a size-0 tensor.
    history: torch.Tensor = field(default_factory=lambda: torch.zeros(0))

    @property
    def residual_norm(self) -> torch.Tensor:
        return torch.sqrt(self.residual_norm_sq)


@dataclass(frozen=True)
class CGState:
    """Full solver state — O(n) and sufficient to resume a solve exactly
    through :func:`cg_chunk`."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor
    k: torch.Tensor
    history: torch.Tensor


def as_matvec(a: Union[MatVec, object]) -> MatVec:
    """Normalise an operator or a callable into a matvec closure."""
    if callable(a):
        return a
    return partial(spmv, a)


def _as_apply(preconditioner):
    if preconditioner is None:
        return None
    if hasattr(preconditioner, "apply"):
        return preconditioner.apply
    return preconditioner


def _reduce(vals, group):
    """Local dots summed over ``group``'s ranks in one all-reduce of their
    stack (without a group: as they are)."""
    if group is None:
        return list(vals)
    # Imported at the call: cgx_torch.dist imports this module.
    from cgx_torch.dist.halo import sum_over

    return list(sum_over(torch.stack(list(vals)), group).unbind())


def _global_rows(b: torch.Tensor, group) -> int:
    """The global problem size: ``b``'s rows times the group's size."""
    if group is None:
        return int(b.shape[0])
    import torch.distributed as dist

    return int(b.shape[0]) * dist.get_world_size(group)


def _tol_sq(tol: float, atol: float, b: torch.Tensor,
            group=None) -> torch.Tensor:
    bb, = _reduce([blas.norm_sq(b)], group)
    t = torch.tensor(tol, dtype=b.dtype, device=b.device)
    at = torch.tensor(atol, dtype=b.dtype, device=b.device)
    return torch.maximum(t ** 2 * bb, at ** 2)


def cg_solve(
    a: Union[MatVec, object],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    track_history: bool = False,
    group=None,
) -> CGResult:
    """Solve ``A x = b`` for SPD ``A`` by (preconditioned) CG.

    Args:
      a: a cgx_torch operator or a matvec callable.
      b: right-hand side (1-D).
      x0: initial iterate; defaults to zeros.
      tol: relative tolerance — exit when ``‖r‖² ≤ tol²·‖b‖²``.  ``tol=0``
        with ``atol=0`` gives fixed-iteration behaviour (reference parity).
      atol: absolute tolerance floor on ``‖r‖``.
      maxiter: iteration cap (defaults to the problem size).
      preconditioner: ``None`` | matvec callable | object with ``.apply``.
      track_history: record ``‖r_k‖²`` per iteration into
        ``CGResult.history`` (length ``maxiter + 1``).
      group: the process group of a row-distributed solve (``b``, ``x0``
        and ``a`` this rank's rows), or None.
    """
    with annotate(PREP):
        matvec = as_matvec(a)
        apply_m = _as_apply(preconditioner)
        maxiter = int(_global_rows(b, group) if maxiter is None else maxiter)
        state = cg_init(matvec, b, x0, preconditioner=apply_m,
                        history_len=maxiter + 1 if track_history else 0,
                        group=group)
        tol_sq = _tol_sq(tol, atol, b, group)
        cond, body = _make_cond_body(matvec, apply_m, maxiter, tol_sq,
                                     track_history, group)
    with annotate(ENGINE):
        while cond(state):
            state = body(state)

    with annotate(RESULT):
        history = state.history
        if track_history:
            # Pad post-exit slots with the final residual so plots stay
            # flat.
            idx = torch.arange(maxiter + 1, device=b.device)
            history = torch.where(idx <= state.k, history, state.rr)
        return CGResult(x=state.x, iterations=state.k,
                        residual_norm_sq=state.rr,
                        converged=state.rr <= tol_sq, history=history)


def cg_init(a, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
            preconditioner=None, history_len: int = 0,
            group=None) -> CGState:
    """Initial :class:`CGState` for ``A x = b`` (x₀ defaults to zeros);
    ``group``: as :func:`cg_solve`'s."""
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    z0 = apply_m(r0) if apply_m is not None else r0
    if apply_m is not None:
        rz0, rr0 = _reduce([blas.dot(r0, z0), blas.dot(r0, r0)], group)
    else:
        rz0, = _reduce([blas.dot(r0, z0)], group)
        rr0 = rz0
    hist0 = torch.zeros(history_len, dtype=b.dtype, device=b.device)
    if history_len:
        hist0[0] = rr0
    return CGState(x=x0, r=r0, z=z0, p=z0, rz=rz0, rr=rr0,
                   k=torch.zeros((), dtype=torch.int32, device=b.device),
                   history=hist0)


def _make_cond_body(matvec, apply_m, maxiter, tol_sq, track_history,
                    group=None):
    def cond(s: CGState) -> bool:
        return host_read((s.k < maxiter) & (s.rr > tol_sq), bool)

    def body(s: CGState) -> CGState:
        q = matvec(s.p)
        pq, = _reduce([blas.dot(s.p, q)], group)
        alpha = s.rz / pq
        x = s.x + alpha * s.p
        r = s.r - alpha * q
        z = apply_m(r) if apply_m is not None else r
        if apply_m is not None:
            rz, rr = _reduce([blas.dot(r, z), blas.dot(r, r)], group)
        else:
            rz, = _reduce([blas.dot(r, z)], group)
            rr = rz
        beta = rz / s.rz
        p = z + beta * s.p
        hist = s.history
        if track_history:
            # Saturate at the last slot (cg_chunk may run past the buffer).
            idx = torch.clamp(s.k + 1, max=hist.shape[0] - 1).long()
            hist = hist.index_put((idx.reshape(1),), rr.reshape(1))
        return CGState(x=x, r=r, z=z, p=p, rz=rz, rr=rr, k=s.k + 1,
                       history=hist)

    return cond, body


# Host reads made by the single-reduction and pipelined loops, and the
# pipelined loop's residual replacements and discarded steps (see
# cg_solve_pipelined).  Counted like the kernels' launches: set to 0
# before a solve and read after it.
host_reads = 0
replacements = 0
discarded_steps = 0


def _read(flags: torch.Tensor) -> list:
    """One read of a small tensor from the device, counted (and a
    ``cgx.sync`` span)."""
    global host_reads
    host_reads += 1
    return host_read(flags)


def _count(k: int, b: torch.Tensor) -> torch.Tensor:
    return torch.tensor(k, dtype=torch.int32, device=b.device)


def cg_solve_single_reduction(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    group=None,
) -> CGResult:
    """Chronopoulos–Gear CG: one fused reduction per iteration.

    The recurrences are arranged so that γ = rᵀu, δ = wᵀu and ρ = rᵀr come
    from independent data and form one stacked tensor, the single
    all-reduce of a distributed solve, at the cost of one more axpy and one
    more carried vector (``s = A p`` by linearity).  The trajectory is
    CG's in exact arithmetic.  Each iteration reads the exit test once.
    ``group``: as :func:`cg_solve`'s (one all-reduce an iteration).

    Reference: Chronopoulos & Gear, J. Comput. Appl. Math. 25 (1989).
    """
    from cgx_torch.dist.halo import sum_over

    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    maxiter = int(_global_rows(b, group) if maxiter is None else maxiter)
    tol_sq = _tol_sq(tol, atol, b, group)

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    u = apply_m(r) if apply_m is not None else r
    w = matvec(u)

    def fused_dots(r, u, w):
        """γ = rᵀu, δ = wᵀu, ρ = rᵀr as one stacked tensor (summed over
        the group's ranks in one all-reduce)."""
        return sum_over(torch.stack([blas.dot(r, u), blas.dot(w, u),
                                     blas.dot(r, r)]), group)

    gamma, delta, rr = fused_dots(r, u, w)
    alpha = gamma / delta
    p = torch.zeros_like(b)
    s = torch.zeros_like(b)
    beta = torch.zeros((), dtype=b.dtype, device=b.device)
    k = 0
    while k < maxiter and _read(rr > tol_sq):
        p = u + beta * p
        s = w + beta * s            # s = A p by linearity
        x = x + alpha * p
        r = r - alpha * s
        u = apply_m(r) if apply_m is not None else r
        w = matvec(u)
        gamma_new, delta, rr = fused_dots(r, u, w)
        beta = gamma_new / gamma
        alpha = gamma_new / (delta - beta * gamma_new / alpha)
        gamma = gamma_new
        k += 1
    return CGResult(x=x, iterations=_count(k, b), residual_norm_sq=rr,
                    converged=rr <= tol_sq,
                    history=torch.zeros(0, dtype=b.dtype, device=b.device))


def cg_solve_pipelined(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    replace_every: int = 25,
    adaptive_replace: bool = False,
    group=None,
) -> CGResult:
    """Ghysels–Vanroose pipelined (P)CG: ``m = M⁻¹w`` and ``n = A m`` do
    not depend on the iteration's reduction, so a distributed solve can
    overlap the two.

    The recurrences and both stabilisations are :mod:`cgx.solve.cg`'s:
    α's denominator ``p'ᵀAp' = δ + β(uᵀs + pᵀw) + β²·pᵀs`` from three
    cross dots in the same stacked reduction (seven scalars), and residual
    replacement (``r = b − Ax``, ``u = M⁻¹r``, ``w = Au``, ``s = Ap``,
    ``q = M⁻¹s``, ``z = Aq``: four matvecs) every ``replace_every``
    iterations (0 disables), or, with ``adaptive_replace``, by the van der
    Vorst–Ye drift bound ``d ← d + ε·(‖r‖ + λ̂·‖x‖)`` (λ̂ the running max of
    δ/γ) once ``d > √ε·‖r‖``, ``d > 1.1·d_at_last_replacement`` and
    ``‖r‖² > 100·tol²‖b‖²``.  ε, d, λ̂ and the gate are float32 in any
    solve dtype, as in the JAX package.  Where replacement is on, a
    stagnation guard every 50 iterations ends the solve with
    ``converged=False`` after two windows without a 1 % gain in ‖r‖².

    In fp32 the periodic form converges only up to κ ≈ 4·10³ (2-D
    Poisson, the JAX package's measurement); past that it ends on the
    guard and the adaptive form is the one that converges.  In fp64
    neither fix fires and the trajectory is CG's.

    One read from the device an iteration.  The periodic form knows its
    replacement steps on the host and reads the exit test.  The adaptive
    form reads the replacement flag, the exit test of the step without
    replacement and, after a replacement, the exit test of the replaced
    state, together: the step after a replacement is computed before
    that state's exit test is read, and discarded (``discarded_steps``)
    if the test says stop, so the iterate and the count are the
    ``lax.while_loop``'s.  ``group``: as :func:`cg_solve`'s (the seven
    dots in one all-reduce an iteration; the drift model reads the global
    ‖x‖ and ‖r‖).
    """
    global replacements, discarded_steps
    from cgx_torch.dist.halo import sum_over

    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    maxiter = int(_global_rows(b, group) if maxiter is None else maxiter)
    dtype, dev = b.dtype, b.device
    tol_sq = _tol_sq(tol, atol, b, group)

    def precond(v):
        return apply_m(v) if apply_m is not None else v

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    u = precond(r)
    w = matvec(u)

    def fused_dots(r, u, w, p, s, x):
        """γ = rᵀu, δ = wᵀu, ρ = rᵀr, the cross terms uᵀs, pᵀw, pᵀs and
        xᵀx (for the drift model) as one stacked tensor (summed over the
        group's ranks in one all-reduce)."""
        return sum_over(torch.stack(
            [blas.dot(r, u), blas.dot(w, u), blas.dot(r, r), blas.dot(u, s),
             blas.dot(p, w), blas.dot(p, s), blas.dot(x, x)]), group)

    def refresh(x, p):
        r2 = b - matvec(x)
        u2 = precond(r2)
        w2 = matvec(u2)
        s2 = matvec(p)
        q2 = precond(s2)
        z2 = matvec(q2)
        return r2, u2, w2, z2, q2, s2, fused_dots(r2, u2, w2, p, s2, x)

    def fresh_drift(dots, lam):
        return eps * (torch.sqrt(dots[2].float())
                      + lam * torch.sqrt(dots[6].float()))

    def guard(k1, dots, best_rr, strikes):
        """The stagnation guard on its fixed 50-iteration cadence."""
        if k1 % 50:
            return best_rr, strikes
        improved = dots[2] < 0.99 * best_rr
        return (torch.where(improved, dots[2], best_rr),
                torch.where(improved, torch.zeros_like(strikes),
                            strikes + 1))

    replacing = bool(replace_every) or adaptive_replace
    zeros = torch.zeros_like(b)
    z = q = s = p = zeros
    dots = fused_dots(r, u, w, zeros, zeros, x)
    g_prev = torch.ones((), dtype=dtype, device=dev)
    best_rr = dots[2]
    strikes = torch.zeros((), dtype=torch.int32, device=dev)
    eps = torch.tensor(torch.finfo(dtype).eps, dtype=torch.float32,
                       device=dev)
    drift = lam = d_gate = torch.zeros((), dtype=torch.float32, device=dev)
    true_ = torch.ones((), dtype=torch.bool, device=dev)

    k = 0
    go = _read(dots[2] > tol_sq)
    pending = None      # the unread exit test of a replaced state
    while go and k < maxiter:
        gamma, delta, us, pw, ps = (dots[0], dots[1], dots[3], dots[4],
                                    dots[5])
        m = precond(w)
        n = matvec(m)
        beta = (torch.zeros((), dtype=dtype, device=dev) if k == 0
                else gamma / g_prev)
        alpha = gamma / (delta + beta * (us + pw) + beta * beta * ps)
        z_n = n + beta * z
        q_n = m + beta * q
        s_n = w + beta * s
        p_n = u + beta * p
        x_n = x + alpha * p_n
        r_n = r - alpha * s_n
        u_n = u - alpha * q_n
        w_n = w - alpha * z_n
        new = fused_dots(r_n, u_n, w_n, p_n, s_n, x_n)
        lam_n = torch.maximum(lam, torch.where(
            gamma > 0, delta / gamma, torch.zeros_like(gamma)).float())
        at_replace = False
        if replacing:
            drift_n = drift + fresh_drift(new, lam_n)
            if adaptive_replace:
                at_flag = ((drift_n * drift_n > eps * new[2].float())
                           & (drift_n > 1.1 * d_gate)
                           & (new[2] > 100.0 * tol_sq))
            else:
                at_replace = (k + 1) % replace_every == 0
        if not at_replace:
            best_k, strikes_k = ((best_rr, strikes) if not replacing
                                 else guard(k + 1, new, best_rr, strikes))
            go_k = (new[2] > tol_sq) & (strikes_k < 2)
        if adaptive_replace:
            prev_ok, at_replace, go = _read(torch.stack(
                [true_ if pending is None else pending, at_flag, go_k]))
            if not prev_ok:     # the replaced state was the last one
                discarded_steps += 1
                break
        elif not at_replace:
            go = _read(go_k)
        k += 1
        x, r, u, w, z, q, s, p = x_n, r_n, u_n, w_n, z_n, q_n, s_n, p_n
        g_prev, lam, pending = gamma, lam_n, None
        if at_replace:
            replacements += 1
            d_gate = drift_n
            r, u, w, z, q, s, dots = refresh(x, p)
            drift = fresh_drift(dots, lam)
            best_rr, strikes = guard(k, dots, best_rr, strikes)
            go_r = (dots[2] > tol_sq) & (strikes < 2)
            if adaptive_replace:
                pending, go = go_r, True
            else:
                go = _read(go_r)
        else:
            dots, best_rr, strikes = new, best_k, strikes_k
            if replacing:
                drift = drift_n
    return CGResult(x=x, iterations=_count(k, b),
                    residual_norm_sq=dots[2], converged=dots[2] <= tol_sq,
                    history=torch.zeros(0, dtype=dtype, device=dev))


def cg_chunk(a, state: CGState, iters: int, *,
             b: Optional[torch.Tensor] = None, tol: float = 0.0,
             atol: float = 0.0, preconditioner=None) -> CGState:
    """Advance a :class:`CGState` by up to ``iters`` CG iterations.

    Run a chunk, keep the returned state, repeat: the trajectory is the
    one of an uninterrupted :func:`cg_solve`.  Pass ``b`` with a nonzero
    ``tol`` to stop early inside the chunk.
    """
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    if b is not None:
        tol_sq = _tol_sq(tol, atol, b)
    else:
        tol_sq = torch.tensor(atol, dtype=state.r.dtype,
                              device=state.r.device) ** 2
    upto = state.k + iters
    track = state.history.shape[0] > 0
    _, body = _make_cond_body(matvec, apply_m, 0, tol_sq, track)
    while bool((state.k < upto) & (state.rr > tol_sq)):
        state = body(state)
    return state

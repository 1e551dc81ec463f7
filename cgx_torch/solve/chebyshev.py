"""Chebyshev iteration, the solver with no inner products (PyTorch).

Counterpart of :mod:`cgx.solve.chebyshev`.  Given bounds ``[λ_min,
λ_max]`` of the spectrum (of ``M⁻¹A`` with a preconditioner), an iteration
is one SpMV, one preconditioner apply and fused axpys with two scalars
fixed in advance: a distributed solve needs no reduction between checks.
The residual is computed every ``check_every`` iterations, and only
there does the loop read the device: between checks ‖r‖² does not change,
so the exit test is known on the host (``host_reads`` counts the reads).
The iteration count is the JAX package's ``lax.while_loop``'s.

:func:`analytic_bounds` gives the exact extreme eigenvalues of
axis-aligned constant-coefficient Dirichlet stencils (stencil objects and
constant DIA forms); :func:`estimate_bounds` estimates them by power
iteration from a start vector drawn from a ``torch.Generator`` seeded 0
on the vector's device, or from ``v0``.

``group=`` (the JAX package's ``axis_name``): a row-distributed solve, the
vectors one rank's rows; every norm and dot is summed over the group's
ranks in one all-reduce, and the default ``maxiter`` is the global size.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.ops import blas
from cgx_torch.solve.cg import CGResult, _as_apply, as_matvec
from cgx_torch.sparse.types import resolve_device

__all__ = ["chebyshev_solve", "estimate_bounds", "analytic_bounds"]

# Reads of the device made by chebyshev_solve: set to 0 before a solve and
# read after it.
host_reads = 0


def analytic_bounds(a) -> Optional[Tuple[float, float]]:
    """Closed-form ``(λ_min, λ_max)`` for axis-aligned constant-coefficient
    Dirichlet stencils, or ``None`` when ``a`` has no such form.

    For a tensor-product operator (center ``c₀``, symmetric couplings
    ``c_ax`` at offset ±1 along each axis) the eigenvalues are
    ``c₀ + Σ_ax 2·c_ax·cos(π·m_ax / (n_ax + 1))``, so the extremes are
    ``c₀ ∓ Σ 2|c_ax|·cos(π/(n_ax+1))``.  Returns Python floats."""
    from cgx_torch.kernels.fused_cg import stencil_taps

    spec = stencil_taps(a)
    if spec is None:
        spec = _dia_constant_taps(a)     # constant-coefficient DIA form
    if spec is None:
        return None
    nx, ny, nz, taps, coeffs = spec
    if any(c is None for c in coeffs):
        return None                      # variable-coefficient planes
    lens = (nx, ny, nz)
    center = None
    per = {}                             # axis -> {+1: c, -1: c}
    for d, c in zip(taps, coeffs):
        nzs = [i for i, v in enumerate(d) if v != 0]
        if not nzs:
            if center is not None:
                return None
            center = float(c)
        elif len(nzs) == 1 and abs(d[nzs[0]]) == 1:
            ax, sg = nzs[0], d[nzs[0]]
            if sg in per.setdefault(ax, {}):
                return None
            per[ax][sg] = float(c)
        else:
            return None                  # diagonal tap / reach > 1
    if center is None:
        return None
    lo = hi = center
    for ax, d in per.items():
        if set(d) != {1, -1} or d[1] != d[-1]:
            return None                  # non-symmetric coupling
        n_ax = lens[ax]
        if n_ax <= 1:
            continue                     # no neighbours along this axis
        span = 2.0 * abs(d[1]) * math.cos(math.pi / (n_ax + 1))
        lo -= span
        hi += span
    return lo, hi


def _dia_constant_taps(a):
    """``(nx, ny, nz, taps, coeffs)`` for a DIA operator whose every
    diagonal is one constant on its grid-valid slots (and zero at
    boundary-crossing slots), or ``None``.  Host side."""
    from cgx_torch.kernels.fused_dia_cg import dia_engine_spec

    spec = dia_engine_spec(a)
    if spec is None:
        return None
    nx, ny, nz, taps = spec
    data = a.data.detach().cpu().numpy()     # (n_diags, n): data[k, i]
    n = data.shape[1]
    if n != nx * ny * nz:
        return None
    r = np.arange(n)
    zc = r % nz
    yc = (r // nz) % ny
    xc = r // (ny * nz)
    coeffs = []
    for t, (dx, dy, dk) in enumerate(taps):
        valid = ((xc + dx >= 0) & (xc + dx < nx)
                 & (yc + dy >= 0) & (yc + dy < ny)
                 & (zc + dk >= 0) & (zc + dk < nz))
        col = data[t]
        if np.any(col[~valid] != 0):
            return None                  # wrap entries: not a grid stencil
        vals = col[valid]
        if vals.size == 0:
            coeffs.append(0.0)
            continue
        c = vals[0]
        if np.any(vals != c):
            return None                  # variable coefficients
        coeffs.append(float(c))
    return nx, ny, nz, list(map(tuple, taps)), coeffs


def estimate_bounds(a, n: int, iters: int = 30, key=None,
                    safety: float = 1.05, min_margin: float = 2.0,
                    dtype=None, v0=None, device="cuda", group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(λ_min, λ_max)`` estimates for SPD ``A`` by power iteration, as
    0-d tensors.

    λ_max: power iteration × ``safety``.  λ_min: power iteration on
    ``λ_max I − A``, then ÷ ``min_margin``: an estimate above the true
    minimum degrades Chebyshev badly, so it errs low.

    ``v0``: the start vector (its device and dtype are the iteration's).
    Without it one is drawn of shape ``n`` and dtype ``dtype`` (float32
    by default) on ``device`` (the card unless the caller asks for the
    CPU) from ``key``, a ``torch.Generator`` on that device, by default
    one seeded 0.  Its values are not the JAX package's (``PRNGKey(0)``):
    compare the two packages with the same ``v0``.  Callers with padded
    layouts mask padding slots of ``v0`` to zero.

    ``group``: ``a`` acts on one rank's rows and ``n`` is their number;
    every rank draws the same start vector, as the JAX package's shards
    do, and the norms and dots are summed over the ranks."""
    from cgx_torch.dist.halo import sum_over

    matvec = as_matvec(a)
    if v0 is None:
        dev = resolve_device(device)
        shape = tuple(n) if isinstance(n, (tuple, list)) else (n,)
        if key is None:
            key = torch.Generator(device=dev)
            key.manual_seed(0)
        v0 = torch.randn(shape, generator=key, device=dev,
                         dtype=dtype or torch.float32)

    def norm(v):
        return torch.sqrt(sum_over(blas.norm_sq(v), group))

    def power(mv, v):
        v = v / norm(v)
        for _ in range(iters):
            w = mv(v)
            v = w / norm(w)
        return sum_over(blas.dot(v, mv(v)), group)

    lam_max = power(matvec, v0) * safety
    lam_min_shift = power(lambda v: lam_max * v - matvec(v), v0)
    lam_min = torch.maximum(lam_max - lam_min_shift,
                            lam_max * 1e-6) / min_margin
    return lam_min, lam_max


def chebyshev_solve(
    a,
    b: torch.Tensor,
    lam_min,
    lam_max,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    maxiter: Optional[int] = None,
    preconditioner=None,
    check_every: int = 16,
    group=None,
) -> CGResult:
    """Chebyshev iteration on ``[λ_min, λ_max]`` (of ``M⁻¹A`` if a
    preconditioner is given); a :class:`CGResult` like ``cg_solve``'s.
    ``group``: a row-distributed solve (one all-reduce a check)."""
    global host_reads
    from cgx_torch.dist.halo import sum_over

    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    n = b.shape[0]
    if maxiter is None and group is not None:
        import torch.distributed as dist

        n = n * dist.get_world_size(group)
    maxiter = int(n if maxiter is None else maxiter)
    check_every = max(1, int(check_every))
    dtype, dev = b.dtype, b.device

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    theta = (scalar(lam_max) + scalar(lam_min)) / 2
    delta = (scalar(lam_max) - scalar(lam_min)) / 2
    # Collapsed bounds (λ_min == λ_max is a legal point spectrum, A = c·I):
    # keep delta away from zero relative to theta so sigma1 stays finite.
    # With a point spectrum the first step x += z/theta is exact, r becomes
    # 0 and the delta-scaled term never contributes.
    eps = scalar(torch.finfo(dtype).eps)
    delta = torch.maximum(delta, eps * torch.maximum(theta.abs(), eps))
    sigma1 = theta / delta

    tol_sq = scalar(tol) ** 2 * sum_over(blas.norm_sq(b), group)

    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    z0 = apply_m(r0) if apply_m is not None else r0
    d = z0 / theta
    rr = sum_over(blas.norm_sq(r0), group)
    x = x0 + d
    r = r0 - matvec(d)
    rho = 1.0 / sigma1
    k = 1

    host_reads += 1
    go = bool(rr > tol_sq)
    while go and k < maxiter:
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        z = apply_m(r) if apply_m is not None else r
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        r = r - matvec(d)
        rho = rho_new
        k += 1
        if k % check_every == 0:     # the only reduction in the loop
            host_reads += 1
            go = bool(sum_over(blas.norm_sq(r), group) > tol_sq)
    rr_final = sum_over(blas.norm_sq(r), group)
    return CGResult(x=x, iterations=torch.tensor(k, dtype=torch.int32,
                                                 device=dev),
                    residual_norm_sq=rr_final, converged=rr_final <= tol_sq,
                    history=torch.zeros(0, dtype=dtype, device=dev))

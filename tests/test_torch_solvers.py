"""Parity of the port's single-reduction and pipelined CG, Chebyshev and
its bounds with cgx (CPU).

The same seeded numpy inputs go through ``cgx`` and ``cgx_torch``.  fp64:
iteration counts equal and x within 1e-10 relative.  fp32: both converge,
iterations within 5 % of cgx's.
"""
import math

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
import cgx.sparse.stencil as jst  # noqa: E402
import cgx_torch  # noqa: E402
from cgx.io import poisson as jpoisson  # noqa: E402
from cgx.solve import chebyshev as jcheb  # noqa: E402
from cgx.sparse.types import csr_from_scipy as j_csr  # noqa: E402
from cgx_torch.interop import operator_from_cgx, precond_from_cgx  # noqa
from cgx_torch.solve import cg as tcg  # noqa: E402
from cgx_torch.solve import chebyshev as tcheb  # noqa: E402
from conftest import random_spd_csr  # noqa: E402
from torch_parity import n_, seeded, t  # noqa: E402

CPU = "cpu"


def _random_spd():
    s = random_spd_csr(200, 0.03, np.random.default_rng(5))
    d = np.linspace(1.0, 6.0, 200)
    return j_csr(s.multiply(np.outer(d, d)).tocsr())


OPERATORS = {
    "stencil2d_48": lambda dt: jst.Stencil2D(48, 48, 4.0, -1.0, -1.0,
                                             dtype_name=dt),
    "stencil3d_16": lambda dt: jst.Stencil3D(16, 16, 16, 6.0, -1.0, -1.0,
                                             -1.0, dtype_name=dt),
    "random_spd_200": lambda dt: _random_spd(),
}


def _pair(kind, dt="float64"):
    a_j = OPERATORS[kind](dt)
    return a_j, operator_from_cgx(a_j, device=CPU)


def _same(res_t, res_j, rtol=1e-10):
    assert int(res_t.iterations) == int(res_j.iterations)
    assert bool(res_t.converged) == bool(res_j.converged)
    x_j = np.asarray(res_j.x)
    assert (np.linalg.norm(n_(res_t.x) - x_j)
            <= rtol * np.linalg.norm(x_j))


def _solvers():
    return {
        "single_reduction": (cgx.cg_solve_single_reduction,
                             cgx_torch.cg_solve_single_reduction, {}),
        "pipelined_replace0": (cgx.cg_solve_pipelined,
                               cgx_torch.cg_solve_pipelined,
                               {"replace_every": 0}),
        "pipelined_adaptive": (cgx.cg_solve_pipelined,
                               cgx_torch.cg_solve_pipelined,
                               {"adaptive_replace": True}),
    }


@pytest.mark.parametrize("solver", sorted(_solvers()))
@pytest.mark.parametrize("kind", sorted(OPERATORS))
def test_fp64_matches_cgx(kind, solver):
    f_j, f_t, kw = _solvers()[solver]
    a_j, a_t = _pair(kind)
    b = seeded(a_j.shape[0], seed=21)
    res_j = f_j(a_j, jnp.asarray(b), tol=1e-9, maxiter=2000, **kw)
    res_t = f_t(a_t, t(b), tol=1e-9, maxiter=2000, **kw)
    assert bool(res_t.converged)
    _same(res_t, res_j)


@pytest.mark.parametrize("solver", sorted(_solvers()))
def test_fp64_preconditioned_warm_start_matches_cgx(solver):
    """Jacobi-PCG from a nonzero x0 on the random SPD matrix."""
    f_j, f_t, kw = _solvers()[solver]
    a_j, a_t = _pair("random_spd_200")
    n = a_j.shape[0]
    b, x0 = seeded(n, seed=22), 0.1 * seeded(n, seed=23)
    m_j = cgx.JacobiPrecond.from_matrix(a_j)
    m_t = precond_from_cgx(m_j, device=CPU)
    res_j = f_j(a_j, jnp.asarray(b), jnp.asarray(x0), tol=1e-10,
                maxiter=2000, preconditioner=m_j, **kw)
    res_t = f_t(a_t, t(b), t(x0), tol=1e-10, maxiter=2000,
                preconditioner=m_t, **kw)
    _same(res_t, res_j)


def test_fp64_periodic_pipelined_matches_cgx():
    """The default periodic replacement (every 25 iterations) in fp64."""
    a_j, a_t = _pair("stencil2d_48")
    b = seeded(a_j.shape[0], seed=24)
    res_j = cgx.cg_solve_pipelined(a_j, jnp.asarray(b), tol=1e-9,
                                   maxiter=2000)
    tcg.replacements = 0
    res_t = cgx_torch.cg_solve_pipelined(a_t, t(b), tol=1e-9, maxiter=2000)
    assert tcg.replacements == int(res_t.iterations) // 25
    _same(res_t, res_j)


def test_fixed_count_tol0_matches_cgx():
    a_j, a_t = _pair("stencil3d_16")
    b = seeded(a_j.shape[0], seed=25)
    for f_j, f_t, kw in _solvers().values():
        res_j = f_j(a_j, jnp.asarray(b), tol=0.0, maxiter=17, **kw)
        res_t = f_t(a_t, t(b), tol=0.0, maxiter=17, **kw)
        assert int(res_t.iterations) == 17
        _same(res_t, res_j)


@pytest.mark.parametrize("solver", sorted(_solvers()) + ["periodic"])
def test_fp32_converges_near_cgx(solver):
    """fp32, 2-D Poisson 48² (κ ≈ 10³, inside the periodic form's
    envelope): both converge, iterations within 5 %, forward error within
    1e-4 of an fp64 solve."""
    if solver == "periodic":
        f_j, f_t, kw = cgx.cg_solve_pipelined, cgx_torch.cg_solve_pipelined, {}
    else:
        f_j, f_t, kw = _solvers()[solver]
    a_j, a_t = _pair("stencil2d_48", "float32")
    b = seeded(a_j.shape[0], seed=26, dtype=np.float32)
    res_j = f_j(a_j, jnp.asarray(b), tol=1e-6, maxiter=3000, **kw)
    res_t = f_t(a_t, t(b), tol=1e-6, maxiter=3000, **kw)
    if solver == "pipelined_replace0":
        # Without replacement the fp32 recurrences drift apart and neither
        # package converges (the reason cgx replaces by default).
        assert not bool(res_j.converged) and not bool(res_t.converged)
        return
    assert bool(res_j.converged) and bool(res_t.converged)
    its_j, its_t = int(res_j.iterations), int(res_t.iterations)
    assert abs(its_t - its_j) <= 0.05 * its_j
    x64 = n_(cgx_torch.cg_solve(_pair("stencil2d_48")[1], t(b.astype(
        np.float64)), tol=1e-12, maxiter=5000).x)
    fwd = np.linalg.norm(n_(res_t.x) - x64) / np.linalg.norm(x64)
    assert fwd <= 1e-4


def test_one_host_read_an_iteration():
    """Single-reduction: the exit test once an iteration (plus the one
    before the first).  Pipelined: one read an iteration, periodic or
    adaptive, replacements and discarded steps included."""
    a_j, a_t = _pair("stencil2d_48", "float32")
    b = t(seeded(a_j.shape[0], seed=27, dtype=np.float32))
    for f, kw in ((cgx_torch.cg_solve_single_reduction, {}),
                  (cgx_torch.cg_solve_pipelined, {}),
                  (cgx_torch.cg_solve_pipelined, {"adaptive_replace": True})):
        tcg.host_reads = tcg.replacements = tcg.discarded_steps = 0
        res = f(a_t, b, tol=1e-6, maxiter=3000, **kw)
        its = int(res.iterations)
        assert tcg.host_reads == its + 1 + tcg.discarded_steps, kw
        if kw:
            assert tcg.replacements >= 1


def test_adaptive_counts_matvecs():
    """Matvecs of an adaptive pipelined solve: one a step, one at the
    start and four a replacement (plus one a discarded step)."""
    a_j, a_t = _pair("stencil2d_48", "float32")
    calls = []

    def mv(x):
        calls.append(1)
        return a_t.matvec(x)

    b = t(seeded(a_j.shape[0], seed=28, dtype=np.float32))
    tcg.replacements = tcg.discarded_steps = 0
    res = cgx_torch.cg_solve_pipelined(mv, b, tol=1e-6, maxiter=3000,
                                       adaptive_replace=True)
    assert len(calls) == (1 + int(res.iterations) + 4 * tcg.replacements
                          + tcg.discarded_steps)


def test_pipelined_stagnation_guard_matches_cgx():
    """fp32 periodic form past its envelope: the guard ends both solves
    with converged=False (a stiff 1-D operator, κ ≈ 10⁵)."""
    import scipy.sparse as sp
    n = 200
    s = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr", dtype=np.float32)
    a_j = j_csr(s)
    a_t = operator_from_cgx(a_j, device=CPU)
    b = seeded(n, seed=29, dtype=np.float32)
    res_j = cgx.cg_solve_pipelined(a_j, jnp.asarray(b), tol=1e-7,
                                   maxiter=5000)
    res_t = cgx_torch.cg_solve_pipelined(a_t, t(b), tol=1e-7, maxiter=5000)
    assert bool(res_t.converged) == bool(res_j.converged)
    if not bool(res_j.converged):
        assert int(res_t.iterations) < 5000
        assert int(res_t.iterations) % 50 == 0


# -- Chebyshev ----------------------------------------------------------------

def test_estimate_bounds_matches_cgx_with_shared_v0():
    a_j, a_t = _pair("stencil2d_48")
    v0 = seeded(a_j.shape[0], seed=31)
    lo_j, hi_j = jcheb.estimate_bounds(a_j, a_j.shape[0], iters=50,
                                       v0=jnp.asarray(v0))
    lo_t, hi_t = cgx_torch.estimate_bounds(a_t, a_t.shape[0], iters=50,
                                           v0=t(v0))
    np.testing.assert_allclose([float(lo_t), float(hi_t)],
                               [float(lo_j), float(hi_j)], rtol=1e-10)


def test_estimate_bounds_default_generator():
    """No v0: a generator seeded 0 on the given device, the same numbers
    each call, and bounds a Chebyshev solve converges with (λ_max within
    the 5 % safety of the true one)."""
    a_t = operator_from_cgx(jst.Stencil2D(16, 16, 4.0, -1.0, -1.0,
                                          dtype_name="float64"), device=CPU)
    lo, hi = analytic = cgx_torch.analytic_bounds(a_t)
    e1 = cgx_torch.estimate_bounds(a_t, a_t.shape[0], iters=50,
                                   dtype=torch.float64, device=CPU)
    e2 = cgx_torch.estimate_bounds(a_t, a_t.shape[0], iters=50,
                                   dtype=torch.float64, device=CPU)
    assert [float(v) for v in e1] == [float(v) for v in e2]
    assert e1[0].dtype == torch.float64
    assert 0 < float(e1[0]) < hi, analytic
    assert 0.99 * hi < float(e1[1]) <= 1.05 * hi, analytic
    b = t(seeded(a_t.shape[0], seed=30))
    res = cgx_torch.chebyshev_solve(a_t, b, *e1, tol=1e-8, maxiter=5000)
    assert bool(res.converged)
    g = torch.Generator(device=CPU)
    g.manual_seed(7)
    e3 = cgx_torch.estimate_bounds(a_t, a_t.shape[0], iters=50, key=g,
                                   dtype=torch.float64, device=CPU)
    assert float(e3[1]) != float(e1[1])
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cgx_torch.estimate_bounds(a_t, a_t.shape[0])


@pytest.mark.parametrize("bounds", ["analytic", "estimated"])
@pytest.mark.parametrize("kind", ["stencil2d_48", "stencil3d_16"])
def test_chebyshev_fp64_matches_cgx(kind, bounds):
    a_j, a_t = _pair(kind)
    n = a_j.shape[0]
    b = seeded(n, seed=32)
    if bounds == "analytic":
        lo_j = lo_t = jcheb.analytic_bounds(a_j)[0]
        hi_j = hi_t = jcheb.analytic_bounds(a_j)[1]
    else:
        v0 = seeded(n, seed=33)
        lo_j, hi_j = jcheb.estimate_bounds(a_j, n, iters=50,
                                           v0=jnp.asarray(v0))
        lo_t, hi_t = cgx_torch.estimate_bounds(a_t, n, iters=50, v0=t(v0))
    res_j = jcheb.chebyshev_solve(a_j, jnp.asarray(b), lo_j, hi_j,
                                  tol=1e-8, maxiter=5000)
    tcheb.host_reads = 0
    res_t = cgx_torch.chebyshev_solve(a_t, t(b), lo_t, hi_t, tol=1e-8,
                                      maxiter=5000)
    assert bool(res_t.converged)
    _same(res_t, res_j)
    # Reads: the one before the loop and one a check (every 16).
    assert tcheb.host_reads == 1 + int(res_t.iterations) // 16


def test_chebyshev_preconditioned_matches_cgx():
    a_j, a_t = _pair("random_spd_200")
    n = a_j.shape[0]
    b, x0 = seeded(n, seed=34), 0.1 * seeded(n, seed=35)
    m_j = cgx.JacobiPrecond.from_matrix(a_j)
    m_t = precond_from_cgx(m_j, device=CPU)
    v0 = seeded(n, seed=36)
    pa_j = lambda v: m_j.apply(cgx.spmv(a_j, v))  # noqa: E731
    pa_t = lambda v: m_t.apply(cgx_torch.spmv(a_t, v))  # noqa: E731
    lo_j, hi_j = jcheb.estimate_bounds(pa_j, n, iters=60, v0=jnp.asarray(v0))
    lo_t, hi_t = cgx_torch.estimate_bounds(pa_t, n, iters=60, v0=t(v0))
    np.testing.assert_allclose([float(lo_t), float(hi_t)],
                               [float(lo_j), float(hi_j)], rtol=1e-10)
    res_j = jcheb.chebyshev_solve(a_j, jnp.asarray(b), lo_j, hi_j,
                                  jnp.asarray(x0), tol=1e-8, maxiter=5000,
                                  preconditioner=m_j, check_every=5)
    res_t = cgx_torch.chebyshev_solve(a_t, t(b), lo_t, hi_t, t(x0),
                                      tol=1e-8, maxiter=5000,
                                      preconditioner=m_t, check_every=5)
    _same(res_t, res_j)


def test_chebyshev_point_spectrum_matches_cgx():
    """λ_min == λ_max (A = c·I): the delta clamp keeps the first step
    exact, as in cgx (tests/test_cg.py's degenerate case)."""
    n, c = 64, 3.0
    b = seeded(n, seed=37)
    res_j = jcheb.chebyshev_solve(lambda v: c * v, jnp.asarray(b), c, c,
                                  tol=1e-10, maxiter=50)
    res_t = cgx_torch.chebyshev_solve(lambda v: c * v, t(b), c, c,
                                      tol=1e-10, maxiter=50)
    assert bool(res_t.converged)
    assert np.all(np.isfinite(n_(res_t.x)))
    np.testing.assert_allclose(n_(res_t.x), b / c, rtol=1e-12)
    _same(res_t, res_j)


def test_chebyshev_fp32_converges_near_cgx():
    a_j, a_t = _pair("stencil3d_16", "float32")
    b = seeded(a_j.shape[0], seed=38, dtype=np.float32)
    lo, hi = jcheb.analytic_bounds(a_j)
    res_j = jcheb.chebyshev_solve(a_j, jnp.asarray(b), lo, hi, tol=1e-5,
                                  maxiter=3000)
    res_t = cgx_torch.chebyshev_solve(a_t, t(b), lo, hi, tol=1e-5,
                                      maxiter=3000)
    assert bool(res_j.converged) and bool(res_t.converged)
    its_j = int(res_j.iterations)
    assert abs(int(res_t.iterations) - its_j) <= 0.05 * its_j


def _anisotropic():
    return jst.Stencil3D(nx=5, ny=4, nz=6, c_center=2 * (3.0 + 1.0 + 0.25),
                         c_x=-3.0, c_y=-1.0, c_z=-0.25)


BOUNDS_CASES = {
    "stencil2d": lambda: jst.Stencil2D(nx=9, ny=7, c_center=4.0, c_x=-1.0,
                                       c_y=-1.0),
    "stencil3d": lambda: jst.poisson3d_stencil(6, 5, 7),
    "anisotropic3d": _anisotropic,
    "dia3d_constant": lambda: jpoisson.poisson3d_dia(6, 5, 4,
                                                     dtype=np.float32),
    "dia2d_constant": lambda: jpoisson.poisson2d_dia(7, 5),
    "csr": lambda: jpoisson.poisson2d(8, 8),
    "general27": lambda: jst.poisson3d_27point(4, 5, 6),
}


@pytest.mark.parametrize("case", sorted(BOUNDS_CASES))
def test_analytic_bounds_match_cgx(case):
    a_j = BOUNDS_CASES[case]()
    a_t = operator_from_cgx(a_j, device=CPU)
    want = jcheb.analytic_bounds(a_j)
    got = cgx_torch.analytic_bounds(a_t)
    if want is None:
        assert got is None
    else:
        assert got is not None
        np.testing.assert_allclose(got, want, rtol=1e-15)
    if case == "anisotropic3d":
        c = [math.cos(math.pi / m) for m in (6, 5, 7)]
        exp = 2 * (3.0 * c[0] + 1.0 * c[1] + 0.25 * c[2])
        np.testing.assert_allclose(got, [8.5 - exp, 8.5 + exp], rtol=1e-12)


def test_analytic_bounds_variable_dia_is_none():
    a_j = jpoisson.poisson3d_dia(5, 4, 3, dtype=np.float32)
    data = np.asarray(a_j.data).copy()
    data[3, 7] *= 1.5
    a_t = cgx_torch.DIAMatrix(data=torch.from_numpy(data),
                              offsets=tuple(a_j.offsets), shape=a_j.shape)
    assert cgx_torch.analytic_bounds(a_t) is None

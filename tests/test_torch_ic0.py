"""Parity of the port's IC(0) (``cgx_torch.solve.ic0``) with cgx (CPU).

The same CSR matrices go to both packages.  The pattern, the level
schedules, the colouring and the packings equal cgx's exactly; the native
factor equals cgx's to 1e-12 relative, and the Python path the native one;
the applies agree within 1e-12 in fp64 and 1e-5 in fp32, whether the port
builds its own preconditioner or carries cgx's across with
``precond_from_cgx``.
"""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import shutil  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
from cgx.io import poisson as jpoisson  # noqa: E402
from cgx.solve import ic0 as jic0  # noqa: E402
from cgx.sparse.types import csr_from_scipy as j_csr  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import operator_from_cgx, precond_from_cgx  # noqa
from cgx_torch.solve import ic0 as tic0  # noqa: E402
from conftest import random_spd_csr  # noqa: E402
from torch_parity import n_, seeded, t  # noqa: E402

CPU = "cpu"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the native IC(0) factor needs g++")


def _kershaw(nblocks=8):
    """Kershaw's 4x4 SPD matrix stacked: IC(0) breaks down at row 3."""
    k = np.array([[3., -2, 0, 2], [-2, 3, -2, 0],
                  [0, -2, 3, -2], [2, 0, -2, 3]])
    m = sp.csr_matrix(sp.block_diag([k] * nblocks))
    m.eliminate_zeros()
    return j_csr(m)


MATRICES = {
    "poisson2d_24": lambda: jpoisson.poisson2d(24, 24),
    "poisson2d_48": lambda: jpoisson.poisson2d(48, 48),
    "poisson3d_12": lambda: jpoisson.poisson3d(12, 12, 12),
    "random_spd_120": lambda: j_csr(random_spd_csr(
        120, 0.06, np.random.default_rng(3))),
}


def _pair(kind):
    a_j = MATRICES[kind]()
    return a_j, operator_from_cgx(a_j, device=CPU)


def _relerr(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_tril_pattern_and_levels_equal_cgx(kind):
    a_j, a_t = _pair(kind)
    want = jic0._tril_pattern(a_j)
    got = tic0._tril_pattern(a_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, lc, lp = want
    n = a_j.shape[0]
    lev_j = jic0._level_schedule(lc, lp, n, use_native=False)
    np.testing.assert_array_equal(tic0._level_schedule(lc, lp, n), lev_j)
    np.testing.assert_array_equal(
        tic0._level_schedule(lc, lp, n, use_native=False), lev_j)


@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_greedy_coloring_equals_cgx(kind):
    a_j, a_t = _pair(kind)
    n = a_j.shape[0]
    cols = np.asarray(a_j.col_indices).astype(np.int64)
    indptr = np.asarray(a_j.indptr).astype(np.int64)
    want = jic0.greedy_coloring(cols, indptr, n)
    got = tic0.greedy_coloring(n_(a_t.col_indices), n_(a_t.indptr), n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_factor_native_and_python_equal_cgx(kind):
    a_j, a_t = _pair(kind)
    lv_j, lc_j, lp_j = jic0.ic0_factor(a_j, use_native=False)
    lv_n, lc_n, lp_n = tic0.ic0_factor(a_t)
    lv_p, lc_p, lp_p = tic0.ic0_factor(a_t, use_native=False)
    np.testing.assert_array_equal(lc_n, lc_j)
    np.testing.assert_array_equal(lp_n, lp_j)
    np.testing.assert_array_equal(lc_p, lc_n)
    assert _relerr(lv_n, lv_j) <= 1e-12
    assert _relerr(lv_p, lv_n) <= 1e-12


def test_factor_exact_on_full_cholesky():
    rng = np.random.default_rng(4)
    n = 12
    m = rng.standard_normal((n, n))
    dense = m @ m.T + n * np.eye(n)
    a_t = cgx_torch.csr_from_scipy(sp.csr_matrix(dense), device=CPU)
    lv, lc, lp = tic0.ic0_factor(a_t)
    low = sp.csr_matrix((lv, lc, lp), shape=(n, n)).toarray()
    np.testing.assert_allclose(low, np.linalg.cholesky(dense), rtol=1e-10)


@pytest.mark.parametrize("ordering", ["natural", "multicolor"])
@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_packings_equal_cgx(kind, ordering):
    a_j, a_t = _pair(kind)
    m_j = jic0.IC0Precond.from_matrix(a_j, ordering=ordering)
    m_t = tic0.IC0Precond.from_matrix(a_t, ordering=ordering)
    assert m_t.n == m_j.n and m_t.n_levels == m_j.n_levels
    for f in ("f_rows", "f_cols", "f_vals", "f_inv_diag", "b_rows",
              "b_cols", "b_vals", "b_inv_diag"):
        got, want = n_(getattr(m_t, f)), np.asarray(getattr(m_j, f))
        assert got.shape == want.shape, f
        if f.endswith(("rows", "cols")):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                       err_msg=f)
    if ordering == "multicolor":
        for g, w in zip(m_t.perm, m_j.perm):
            np.testing.assert_array_equal(n_(g), np.asarray(w))
        if kind.startswith("poisson"):      # red-black: two levels
            assert m_t.n_levels == 2
    else:
        assert m_t.perm is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ordering", ["natural", "multicolor"])
@pytest.mark.parametrize("kind", ["poisson2d_48", "poisson3d_12",
                                  "random_spd_120"])
def test_apply_matches_cgx(kind, ordering, dtype):
    """The port's own preconditioner and cgx's carried across both apply
    as cgx's does."""
    a_j, a_t = _pair(kind)
    m_j = jic0.IC0Precond.from_matrix(a_j, dtype=np.dtype(dtype),
                                      ordering=ordering)
    m_t = tic0.IC0Precond.from_matrix(a_t, dtype=np.dtype(dtype),
                                      ordering=ordering)
    m_c = precond_from_cgx(m_j, device=CPU)
    r = seeded(a_j.shape[0], seed=41, dtype=np.dtype(dtype))
    want = np.asarray(m_j.apply(jnp.asarray(r)))
    tol = 1e-12 if dtype == "float64" else 1e-5
    for m in (m_t, m_c):
        got = n_(m.apply(t(r)))
        assert got.dtype == want.dtype
        assert _relerr(got, want) <= tol


def test_apply_equals_dense_solve():
    """apply(r) == L⁻ᵀ L⁻¹ r from the same factor, computed densely."""
    a_j, a_t = _pair("poisson2d_24")
    n = a_j.shape[0]
    lv, lc, lp = tic0.ic0_factor(a_t)
    low = sp.csr_matrix((lv, lc, lp), shape=(n, n)).toarray()
    r = seeded(n, seed=42)
    want = np.linalg.solve(low.T, np.linalg.solve(low, r))
    got = n_(tic0.IC0Precond.from_matrix(a_t).apply(t(r)))
    assert _relerr(got, want) <= 1e-12


def test_levels_are_views_of_the_packing():
    """Each level's slices are views of the packed arrays, over its real
    rows only; the padded gathers are cgx's count."""
    a_j, a_t = _pair("poisson2d_24")
    m = tic0.IC0Precond.from_matrix(a_t)
    sweep = m.f_levels
    assert len(sweep.steps) == len(sweep.counts) == m.n_levels == 47
    rows = n_(m.f_rows)
    assert sum(sweep.counts) == a_t.shape[0] == int((rows != m.n).sum())
    np.testing.assert_array_equal(np.sort(n_(sweep.order)),
                                  np.arange(a_t.shape[0]))
    for l, (c, r, cols, vals, inv_diag) in enumerate(sweep.steps):
        assert r._base is sweep.order and vals._base is m.f_vals
        assert inv_diag._base is m.f_inv_diag
        np.testing.assert_array_equal(n_(r), rows[l, :c])
        assert cols.shape == (c * m.f_cols.shape[2],)
    assert m.padded_gathers == (m.f_cols.numel() + m.b_cols.numel())


def test_timings_name_each_step():
    a_j, a_t = _pair("poisson2d_24")
    for ordering, extra in (("natural", set()),
                            ("multicolor", {"coloring", "permute"})):
        tm = {}
        tic0.IC0Precond.from_matrix(a_t, ordering=ordering, timings=tm)
        assert set(tm) == {"pattern", "factor", "levels", "pack",
                           "to_device"} | extra
        assert all(v >= 0 for v in tm.values())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nsweeps", ["levels", 3])
@pytest.mark.parametrize("kind", ["poisson2d_24", "poisson3d_12"])
def test_sweep_apply_matches_cgx(kind, nsweeps, dtype):
    a_j, a_t = _pair(kind)
    np_dt = np.dtype(dtype)
    m0 = jic0.IC0SweepPrecond.from_matrix(a_j, dtype=np_dt)
    ns = m0.n_levels - 1 if nsweeps == "levels" else nsweeps
    m_j = jic0.IC0SweepPrecond.from_matrix(a_j, nsweeps=ns, dtype=np_dt)
    m_t = tic0.IC0SweepPrecond.from_matrix(a_t, nsweeps=ns, dtype=np_dt)
    m_c = precond_from_cgx(m_j, device=CPU)
    assert (m_t.nsweeps, m_t.n_levels) == (m_j.nsweeps, m_j.n_levels)
    r = seeded(a_j.shape[0], seed=43, dtype=np_dt)
    want = np.asarray(m_j.apply(jnp.asarray(r)))
    tol = 1e-12 if dtype == "float64" else 1e-5
    for m in (m_t, m_c):
        assert _relerr(n_(m.apply(t(r))), want) <= tol
    if nsweeps == "levels" and dtype == "float64":
        exact = n_(tic0.IC0Precond.from_matrix(a_t).apply(t(r)))
        assert _relerr(n_(m_t.apply(t(r))), exact) <= 1e-10


def test_pcg_fp64_matches_cgx_and_beats_jacobi():
    a_j, a_t = _pair("poisson2d_24")
    b = seeded(a_j.shape[0], seed=44)
    res_j = cgx.cg_solve(a_j, jnp.asarray(b), tol=1e-10, maxiter=2000,
                         preconditioner=jic0.IC0Precond.from_matrix(a_j))
    res_t = cgx_torch.cg_solve(a_t, t(b), tol=1e-10, maxiter=2000,
                               preconditioner=tic0.IC0Precond.from_matrix(
                                   a_t))
    jac = cgx_torch.cg_solve(a_t, t(b), tol=1e-10, maxiter=2000,
                             preconditioner=cgx_torch.JacobiPrecond
                             .from_matrix(a_t))
    assert bool(res_t.converged)
    assert int(res_t.iterations) == int(res_j.iterations)
    assert _relerr(n_(res_t.x), np.asarray(res_j.x)) <= 1e-10
    assert int(res_t.iterations) < int(jac.iterations)


def test_pcg_ordering_and_sweeps_between_jacobi_and_exact():
    """IC(0) natural ≤ sweeps(3) < Jacobi iterations on 3-D Poisson."""
    a_j, a_t = _pair("poisson3d_12")
    b = t(seeded(a_j.shape[0], seed=45))

    def its(m):
        res = cgx_torch.cg_solve(a_t, b, tol=1e-8, maxiter=2000,
                                 preconditioner=m)
        assert bool(res.converged)
        return int(res.iterations)

    it_jac = its(cgx_torch.JacobiPrecond.from_matrix(a_t))
    it_exact = its(tic0.IC0Precond.from_matrix(a_t))
    it_sweep = its(tic0.IC0SweepPrecond.from_matrix(a_t, nsweeps=3))
    it_color = its(tic0.IC0Precond.from_matrix(a_t, ordering="multicolor"))
    assert it_exact <= it_sweep < it_jac
    assert it_color < it_jac


def test_breakdown_raises():
    a_t = cgx_torch.csr_from_scipy(sp.csr_matrix(
        np.array([[1.0, 2.0], [2.0, 1.0]])), device=CPU)
    for native in (True, False):
        with pytest.raises(np.linalg.LinAlgError):
            tic0.ic0_factor(a_t, use_native=native)


def test_shifted_recovers_kershaw_breakdown():
    a_j = _kershaw()
    a_t = operator_from_cgx(a_j, device=CPU)
    with pytest.raises(np.linalg.LinAlgError):
        tic0.ic0_factor(a_t)
    lv, lc, lp, alpha = tic0.ic0_factor_shifted(a_t)
    lv_j, _, _, alpha_j = jic0.ic0_factor_shifted(a_j, use_native=False)
    assert alpha == alpha_j > 0
    assert _relerr(lv, lv_j) <= 1e-12


def test_precond_and_sweep_survive_breakdown_matrix():
    """from_matrix shifts on breakdown; PCG still converges to CG's x."""
    a_j = _kershaw()
    a_t = operator_from_cgx(a_j, device=CPU)
    b = t(seeded(a_t.shape[0], seed=46))
    plain = cgx_torch.cg_solve(a_t, b, tol=1e-10, maxiter=500)
    for m in (tic0.IC0Precond.from_matrix(a_t),
              tic0.IC0SweepPrecond.from_matrix(a_t, nsweeps=3)):
        res = cgx_torch.cg_solve(a_t, b, tol=1e-10, maxiter=500,
                                 preconditioner=m)
        assert bool(res.converged)
        np.testing.assert_allclose(n_(res.x), n_(plain.x), rtol=1e-7,
                                   atol=1e-9)


def test_gather_budget_guard_with_explicit_budget():
    """The guard refuses when a budget is given; the default (None) has
    none and builds."""
    a_j, a_t = _pair("random_spd_120")
    with pytest.raises(ValueError, match="IC0SweepPrecond"):
        tic0.IC0Precond.from_matrix(a_t, gather_budget=10)
    with pytest.raises(ValueError, match="IC0SweepPrecond"):
        jic0.IC0Precond.from_matrix(a_j, gather_budget=10)
    m = tic0.IC0Precond.from_matrix(a_t, dtype=np.float32)
    r = t(seeded(a_t.shape[0], seed=47, dtype=np.float32))
    assert bool(torch.isfinite(m.apply(r)).all())


def test_sweep_rejects_unbanded():
    s = random_spd_csr(128, 0.2)
    a_t = cgx_torch.csr_from_scipy(s, device=CPU)
    with pytest.raises(ValueError, match="banded"):
        tic0.IC0SweepPrecond.from_matrix(a_t)
    with pytest.raises(ValueError, match="banded"):
        jic0.IC0SweepPrecond.from_matrix(j_csr(s))


def test_unknown_ordering_raises():
    _, a_t = _pair("poisson2d_24")
    with pytest.raises(ValueError, match="ordering"):
        tic0.IC0Precond.from_matrix(a_t, ordering="rcm")

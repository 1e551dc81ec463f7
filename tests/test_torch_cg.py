"""Parity of the port's cg_solve / cg_init / cg_chunk with cgx (CPU, fp64)."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
import cgx.sparse.stencil as jst  # noqa: E402
import cgx_torch  # noqa: E402
from cgx.solve.cg import cg_chunk as j_chunk  # noqa: E402
from cgx.solve.cg import cg_init as j_init  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.solve.cg import cg_chunk, cg_init  # noqa: E402
from torch_parity import n_, seeded, t  # noqa: E402

OPERATORS = {
    "stencil3d": lambda: jst.poisson3d_stencil(9, 8, 7),
    "stencil2d": lambda: jst.poisson2d_stencil(14, 11),
}


def _pair(kind):
    a_j = OPERATORS[kind]()
    return a_j, operator_from_cgx(a_j)


def _assert_same(res_t, res_j, rtol=1e-10):
    assert int(res_t.iterations) == int(res_j.iterations)
    assert bool(res_t.converged) == bool(res_j.converged)
    np.testing.assert_allclose(n_(res_t.x), np.asarray(res_j.x), rtol=rtol,
                               atol=rtol * float(np.abs(res_j.x).max()))


@pytest.mark.parametrize("kind", sorted(OPERATORS))
def test_cg_solve_matches_cgx(kind):
    a_j, a_t = _pair(kind)
    b = seeded(a_j.shape[0], seed=11)
    res_j = cgx.cg_solve(a_j, jnp.asarray(b), tol=1e-8)
    res_t = cgx_torch.cg_solve(a_t, t(b), tol=1e-8)
    assert bool(res_t.converged)
    _assert_same(res_t, res_j)
    np.testing.assert_allclose(float(res_t.residual_norm),
                               float(res_j.residual_norm), rtol=1e-6)


@pytest.mark.parametrize("kind", sorted(OPERATORS))
def test_cg_fixed_count_tol0(kind):
    """tol=0: the reference's fixed-count semantics (maxiter updates)."""
    a_j, a_t = _pair(kind)
    b = seeded(a_j.shape[0], seed=12)
    res_j = cgx.cg_solve(a_j, jnp.asarray(b), tol=0.0, maxiter=17)
    res_t = cgx_torch.cg_solve(a_t, t(b), tol=0.0, maxiter=17)
    assert int(res_t.iterations) == 17
    assert not bool(res_t.converged)
    _assert_same(res_t, res_j)


@pytest.mark.parametrize("kind", sorted(OPERATORS))
def test_cg_warm_start(kind):
    a_j, a_t = _pair(kind)
    n = a_j.shape[0]
    b, x0 = seeded(n, seed=13), 0.1 * seeded(n, seed=14)
    res_j = cgx.cg_solve(a_j, jnp.asarray(b), jnp.asarray(x0), tol=1e-8)
    res_t = cgx_torch.cg_solve(a_t, t(b), t(x0), tol=1e-8)
    _assert_same(res_t, res_j)


def test_cg_history_and_preconditioner():
    a_j, a_t = _pair("stencil3d")
    b = seeded(a_j.shape[0], seed=15)
    res_j = cgx.cg_solve(a_j, jnp.asarray(b), tol=1e-8, maxiter=200,
                         track_history=True,
                         preconditioner=lambda r: r / 6.0)
    res_t = cgx_torch.cg_solve(a_t, t(b), tol=1e-8, maxiter=200,
                               track_history=True,
                               preconditioner=lambda r: r / 6.0)
    _assert_same(res_t, res_j)
    assert res_t.history.shape == (201,)
    np.testing.assert_allclose(n_(res_t.history), np.asarray(res_j.history),
                               rtol=1e-8, atol=1e-300)


def test_cg_chunk_resumes_to_same_x():
    a_j, a_t = _pair("stencil3d")
    b = seeded(a_j.shape[0], seed=16)
    full = cgx_torch.cg_solve(a_t, t(b), tol=1e-8)
    st = cg_init(a_t, t(b))
    for _ in range(100):
        if not bool(st.rr > 1e-16 * torch.dot(t(b), t(b))):
            break
        st = cg_chunk(a_t, st, 7, b=t(b), tol=1e-8)
    assert int(st.k) == int(full.iterations)
    np.testing.assert_array_equal(n_(st.x), n_(full.x))
    # And the chunked trajectory agrees with cgx's chunked one.
    sj = j_init(a_j, jnp.asarray(b))
    sj = j_chunk(a_j, sj, 10)
    stt = cg_chunk(a_t, cg_init(a_t, t(b)), 10)
    assert int(stt.k) == int(sj.k) == 10
    np.testing.assert_allclose(n_(stt.x), np.asarray(sj.x), rtol=1e-10,
                               atol=1e-12)

"""The df64 arithmetic and the high-accuracy solvers of the port
(``cgx_torch.ops.df64``, ``cgx_torch.solve.hp``) against the JAX package.

The cases mirror ``tests/test_hp.py``: the same seeded numpy inputs go
through ``cgx`` (on the CPU, its Pallas kernels in interpret mode) and the
port with ``device="cpu"`` (its kernels' plain versions).  Tolerances:
the df64 primitives, ``df64_ell_spmv``/``spmm`` and ``df64_col_norm_sq``
bit for bit; ``df64_cg_solve`` equal iterations and x within 1e-12
relative in the fp64 view; the refinement loop, given the same inner
solve, bit for bit in its iterate and equal ``outer`` and
``inner_iterations``; the refinement solvers equal ``outer`` and
``inner_iterations`` where the fp32 inner solves are short (WBELL,
bcsstk, auto, multi-RHS).  Where the fp32 inners run into thousands of
iterations on a κ ≥ 10⁶ operator (the clustered spectrum, the κ = 10⁶
tridiagonal) the counts are set by rounding, and the port's fp32 dots
sum in another order than XLA's: there both packages are held to the
TRUE relative residual in fp64, not to each other's counts.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cgx
import cgx.ops.df64 as jdf
import cgx.solve.hp as jhp
import cgx_torch
import cgx_torch.ops.df64 as tdf
import cgx_torch.solve.hp as thp
from conftest import random_spd_csr
from torch_parity import n_

CPU = "cpu"


def _ill_conditioned_spd(n=96, kappa=1e9, seed=0):
    """Tridiagonal SPD with a log-spaced diagonal: κ ≈ kappa."""
    rng = np.random.default_rng(seed)
    d = np.logspace(0, np.log10(kappa), n)
    off = 0.1 * np.sqrt(d[:-1] * d[1:])
    a = sp.diags([off, d, off], [-1, 0, 1], format="csr").astype(np.float64)
    return a, rng.standard_normal(n)


def _clustered_spectrum_spd(n=96, kappa=3e7, seed=0, n_small=4):
    """Dense SPD with a rotation-hidden clustered spectrum (test_hp.py)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([(1.0 / kappa) * (1 + 1e-3 * np.arange(n_small)),
                        np.linspace(0.5, 1.0, n - n_small)])
    a = (q * d) @ q.T
    a = (a + a.T) / 2
    return sp.csr_matrix(a), rng.standard_normal(n)


def _scaled_random(n, hi_exp, seed=3):
    """``random_spd_csr`` worsened by a log-spaced two-sided scaling."""
    a = random_spd_csr(n, 0.03, np.random.default_rng(seed))
    d = sp.diags(np.logspace(0, hi_exp, n))
    return (d @ a @ d).tocsr()


def _same_df(t, j):
    """A port DF64 equals a cgx DF64 word for word."""
    np.testing.assert_array_equal(n_(t.hi), np.asarray(j.hi))
    np.testing.assert_array_equal(n_(t.lo), np.asarray(j.lo))


def _true_rel(a, b, x64):
    return np.linalg.norm(b - a @ x64) / np.linalg.norm(b)


def _jacobi_pair(a):
    """The same Jacobi preconditioner in both packages."""
    inv = (1.0 / a.diagonal()).astype(np.float32)
    return (cgx.JacobiPrecond(inv_diag=jnp.asarray(inv)),
            cgx_torch.JacobiPrecond(inv_diag=torch.from_numpy(inv)))


def _same_ir(info_t, info_j):
    assert info_t["outer"] == info_j["outer"], (info_t, info_j)
    assert info_t["inner_iterations"] == info_j["inner_iterations"], \
        (info_t, info_j)


# -- the df64 primitives, bit for bit -------------------------------------

def test_two_sum_exact():
    s, e = tdf.two_sum(torch.tensor(1.0), torch.tensor(1e-8))
    assert float(s) == 1.0
    assert float(np.float64(s) + np.float64(e)) == 1.0 + np.float64(
        np.float32(1e-8))
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * 1e3).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    got = tdf.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    ref = jdf.two_sum(jnp.asarray(a), jnp.asarray(b))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(n_(g), np.asarray(r))
    np.testing.assert_array_equal(
        n_(got[0]).astype(np.float64) + n_(got[1]),
        a.astype(np.float64) + b.astype(np.float64))


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    p, e = tdf.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(n_(p).astype(np.float64) + n_(e), exact)
    pj, ej = jdf.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(n_(p), np.asarray(pj))
    np.testing.assert_array_equal(n_(e), np.asarray(ej))


def test_df_dot_beats_fp32():
    """Adversarial cancellation: df64 ~1e-14 relative, fp32 ~1e-7; the
    dot equals cgx's word for word (same products, same fold)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4096) * np.logspace(0, 6, 4096)
    y = rng.standard_normal(4096)
    exact = float(np.dot(x, y))
    d = tdf.df_dot(tdf.df_from_f64(x, CPU), tdf.df_from_f64(y, CPU))
    got = float(np.float64(d.hi) + np.float64(d.lo))
    rel_df = abs(got - exact) / abs(exact)
    rel_32 = abs(float(torch.dot(torch.tensor(x, dtype=torch.float32),
                                 torch.tensor(y, dtype=torch.float32)))
                 - exact) / abs(exact)
    assert rel_df < 1e-11
    assert rel_df < rel_32 * 1e-3
    _same_df(d, jdf.df_dot(jdf.df_from_f64(x), jdf.df_from_f64(y)))


def test_df_div_accuracy():
    q = tdf.df_div(tdf.df_from_f64(np.array([np.pi]), CPU),
                   tdf.df_from_f64(np.array([np.e]), CPU))
    assert abs(tdf.df_to_f64(q)[0] - np.pi / np.e) < 1e-13
    _same_df(q, jdf.df_div(jdf.df_from_f64(np.array([np.pi])),
                           jdf.df_from_f64(np.array([np.e]))))


def test_df_arithmetic_equals_cgx():
    """add, sub, mul, mul_f32, axpy, sum and the odd-length fold over
    seeded df64 arrays, word for word against cgx."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal(1000) * np.logspace(-3, 3, 1000)
    y = rng.standard_normal(1000)
    c = np.float32(rng.standard_normal())
    alpha = np.array(rng.standard_normal())
    tx, ty = tdf.df_from_f64(x, CPU), tdf.df_from_f64(y, CPU)
    jx, jy = jdf.df_from_f64(x), jdf.df_from_f64(y)
    _same_df(tdf.df_add(tx, ty), jdf.df_add(jx, jy))
    _same_df(tdf.df_sub(tx, ty), jdf.df_sub(jx, jy))
    _same_df(tdf.df_mul(tx, ty), jdf.df_mul(jx, jy))
    _same_df(tdf.df_mul_f32(tx, torch.tensor(c)),
             jdf.df_mul_f32(jx, jnp.float32(c)))
    _same_df(tdf.df_axpy(tdf.df_from_f64(alpha, CPU), tx, ty),
             jdf.df_axpy(jdf.df_from_f64(alpha), jx, jy))
    _same_df(tdf.df_sum(tx), jdf.df_sum(jx))
    np.testing.assert_array_equal(tdf.df_to_f64(tx), jdf.df_to_f64(jx))


# -- df64 ELL products ------------------------------------------------------

def test_df64_ell_spmv_matches_f64():
    a, _ = _ill_conditioned_spd(200, 1e8)
    x = np.random.default_rng(3).standard_normal(200)
    ahp = thp.df64_ell_from_csr(a, device=CPU)
    y = thp.df64_ell_spmv(ahp, tdf.df_from_f64(x, CPU))
    np.testing.assert_allclose(tdf.df_to_f64(y), a @ x, rtol=1e-12,
                               atol=1e-12)
    _same_df(y, jhp.df64_ell_spmv(jhp.df64_ell_from_csr(a),
                                  jdf.df_from_f64(x)))


def test_df64_ell_spmm_matches_f64():
    a, _ = _ill_conditioned_spd(200, 1e8)
    X = np.random.default_rng(4).standard_normal((200, 3))
    ahp = thp.df64_ell_from_csr(a, device=CPU)
    Y = thp.df64_ell_spmm(ahp, tdf.df_from_f64(X, CPU))
    np.testing.assert_allclose(tdf.df_to_f64(Y), a @ X, rtol=1e-12,
                               atol=1e-12)
    _same_df(Y, jhp.df64_ell_spmm(jhp.df64_ell_from_csr(a),
                                  jdf.df_from_f64(X)))


def test_df64_col_norm_sq_exact():
    X = (np.random.default_rng(7).standard_normal((512, 4))
         * np.logspace(0, 5, 512)[:, None])
    got = thp.df64_col_norm_sq(tdf.df_from_f64(X, CPU))
    np.testing.assert_allclose(got, np.einsum("nk,nk->k", X, X), rtol=1e-12)
    np.testing.assert_array_equal(
        got, jhp.df64_col_norm_sq(jdf.df_from_f64(X)))


# -- whole-df64 CG ----------------------------------------------------------

def _same_cg(res_t, res_j):
    assert int(res_t.iterations) == int(res_j.iterations)
    xt, xj = tdf.df_to_f64(res_t.x), jdf.df_to_f64(res_j.x)
    assert np.linalg.norm(xt - xj) <= 1e-12 * np.linalg.norm(xj)


def test_fp32_cg_cannot_but_df64_can():
    """True relres 1e-6 at κ ≈ 3e7: fp32 CG stalls above it, df64 CG
    reaches it in a few hundred iterations, as cgx's does."""
    a, b = _clustered_spectrum_spd(96, 3e7)
    a32 = cgx_torch.csr_from_scipy(a.astype(np.float32), device=CPU)
    r32 = cgx_torch.cg_solve(a32, torch.tensor(b, dtype=torch.float32),
                             tol=1e-8, maxiter=3000)
    assert _true_rel(a, b, n_(r32.x).astype(np.float64)) > 1e-6

    res = thp.df64_cg_solve(thp.df64_ell_from_csr(a, device=CPU), b,
                            tol=1e-8, maxiter=3000)
    assert bool(res.converged)
    assert _true_rel(a, b, tdf.df_to_f64(res.x)) <= 1e-6
    assert int(res.iterations) < 500
    _same_cg(res, jhp.df64_cg_solve(jhp.df64_ell_from_csr(a), b, tol=1e-8,
                                    maxiter=3000))


@pytest.mark.parametrize("jacobi", [False, True])
def test_df64_cg_matches_f64_cg_trajectory(jacobi):
    a, b = _ill_conditioned_spd(80, 1e3, seed=5)
    res = thp.df64_cg_solve(thp.df64_ell_from_csr(a, device=CPU), b,
                            tol=1e-10, maxiter=500, jacobi=jacobi)
    x64 = tdf.df_to_f64(res.x)
    assert _true_rel(a, b, x64) <= 1e-10
    np.testing.assert_allclose(x64, sp.linalg.spsolve(a.tocsc(), b),
                               rtol=1e-6)
    _same_cg(res, jhp.df64_cg_solve(jhp.df64_ell_from_csr(a), b, tol=1e-10,
                                    maxiter=500, jacobi=jacobi))


# -- refinement ------------------------------------------------------------

def test_ir_df64_reaches_true_tol():
    a, b = _clustered_spectrum_spd(96, 3e7, seed=7)
    res, info = thp.ir_df64_solve(a, b, tol=1e-6, inner_tol=1e-2,
                                  inner_maxiter=3000, device=CPU)
    assert bool(res.converged)
    assert _true_rel(a, b, tdf.df_to_f64(res.x)) <= 1.5e-6
    assert info["outer"] <= 20
    res_j, info_j = jhp.ir_df64_solve(a, b, tol=1e-6, inner_tol=1e-2,
                                      inner_maxiter=3000)
    assert bool(res_j.converged) and info_j["outer"] <= 20
    assert _true_rel(a, b, jdf.df_to_f64(res_j.x)) <= 1.5e-6


def _exact_inner(a, to_host, from_host):
    """An inner solve both packages can share: the fp64 direct solve of
    the unit residual, rounded to fp32, with a fixed count of 7."""
    lu = sp.linalg.splu(a.tocsc())

    def inner(r_unit):
        d = lu.solve(np.asarray(to_host(r_unit), np.float64))
        return from_host(d.astype(np.float32)), 7
    return inner


@pytest.mark.parametrize("resume", [False, True])
def test_ir_df64_loop_equals_cgx_bit_for_bit(resume):
    """The refinement loop alone: given the same inner solve, the port's
    loop equals cgx's word for word (iterate, outer, inner count, relres),
    from zero and resumed from a one-cycle iterate."""
    a, b = _clustered_spectrum_spd(96, 3e7, seed=7)
    a = (a + sp.diags(np.full(96, 1e-4))).tocsr()
    kw = dict(tol=1e-12, atol=0.0, max_outer=6, verbose=False)
    loop_t = thp._ir_df64_loop(
        thp.df64_ell_from_csr(a, device=CPU),
        _exact_inner(a, n_, torch.from_numpy), 96, **kw)
    loop_j = jhp._ir_df64_loop(
        jhp.df64_ell_from_csr(a), _exact_inner(a, np.asarray, jnp.asarray),
        96, **kw)
    x0_t = x0_j = None
    if resume:
        one = dict(kw, max_outer=1)
        x0_t = thp._ir_df64_loop(
            thp.df64_ell_from_csr(a, device=CPU),
            _exact_inner(a, n_, torch.from_numpy), 96, **one)(b)[0].x
        x0_j = jhp._ir_df64_loop(
            jhp.df64_ell_from_csr(a),
            _exact_inner(a, np.asarray, jnp.asarray), 96, **one)(b)[0].x
        _same_df(x0_t, x0_j)
    res_t, info_t = loop_t(b, x0=x0_t)
    res_j, info_j = loop_j(b, x0=x0_j)
    assert info_t == info_j
    assert info_t["outer"] >= 2
    _same_df(res_t.x, res_j.x)


def test_ir_df64_on_bcsstk_standin_small():
    """The bcsstk class at CPU scale (the port's stand-in equals cgx's)
    with a Jacobi inner."""
    from cgx.io.suitesparse import standin as j_standin
    from cgx_torch.io.suitesparse import standin

    a = standin("bcsstk17", scale=0.04, device=CPU)
    aj = j_standin("bcsstk17", scale=0.04)
    av = thp._scipy_f64(a)
    np.testing.assert_array_equal(av.toarray(),
                                  thp._scipy_f64(aj).toarray())
    b = np.random.default_rng(11).standard_normal(a.shape[0])
    mj, mt = _jacobi_pair(av)
    res, info = thp.ir_df64_solve(av, b, tol=1e-6, inner_tol=1e-2,
                                  inner_maxiter=5000, preconditioner=mt,
                                  device=CPU)
    assert _true_rel(av, b, tdf.df_to_f64(res.x)) <= 1.5e-6, info
    _, info_j = jhp.ir_df64_solve(av, b, tol=1e-6, inner_tol=1e-2,
                                  inner_maxiter=5000, preconditioner=mj)
    _same_ir(info, info_j)


def test_ir_df64_wbell_inner_reaches_true_tol():
    """inner_format='wbell': the outer drives K7 inners (its plain version
    on the CPU) to TRUE relres ≤ 1e-6, as cgx does in interpret mode."""
    a = _scaled_random(300, 4)
    b = np.random.default_rng(5).standard_normal(300)
    mj, mt = _jacobi_pair(a)
    res, info = thp.ir_df64_solve(a, b, tol=1e-6, inner_tol=1e-2,
                                  inner_maxiter=2000, preconditioner=mt,
                                  inner_format="wbell", device=CPU)
    assert _true_rel(a, b, tdf.df_to_f64(res.x)) <= 1.5e-6, info
    assert bool(res.converged)
    _, info_j = jhp.ir_df64_solve(a, b, tol=1e-6, inner_tol=1e-2,
                                  inner_maxiter=2000, preconditioner=mj,
                                  inner_format="wbell")
    _same_ir(info, info_j)


def test_ir_df64_wbell_inner_chunked_matches():
    """inner_chunk bounds each inner call; the result reaches tol and is
    the monolithic inner's bit for bit (chunking moves only where the
    host looks)."""
    a = random_spd_csr(256, 0.04, np.random.default_rng(9))
    b = np.random.default_rng(10).standard_normal(256)
    res, info = thp.ir_df64_solve(a, b, tol=1e-8, inner_tol=1e-3,
                                  inner_format="wbell", inner_chunk=20,
                                  device=CPU)
    assert _true_rel(a, b, tdf.df_to_f64(res.x)) <= 1.5e-8, info
    mono, info_m = thp.ir_df64_solve(a, b, tol=1e-8, inner_tol=1e-3,
                                     inner_format="wbell", device=CPU)
    assert info == info_m
    np.testing.assert_array_equal(n_(res.x.hi), n_(mono.x.hi))
    np.testing.assert_array_equal(n_(res.x.lo), n_(mono.x.lo))


def test_ir_df64_wbell_inner_rejects_unsupported_precond():
    a = random_spd_csr(128, 0.05, np.random.default_rng(2))
    m = cgx_torch.BlockJacobiPrecond.from_matrix(
        cgx_torch.csr_from_scipy(a.astype(np.float32), device=CPU),
        blocksize=4)
    with pytest.raises(ValueError, match="wbell"):
        thp.ir_df64_solve(a, np.zeros(128), preconditioner=m,
                          inner_format="wbell", device=CPU)


def test_ir_df64_auto_inner_format_small_no_wbell():
    """auto: the pick is pick_format's (the one surface auto_format uses),
    and agrees with cgx's: csr for this irregular matrix, ell for a
    near-uniform band."""
    from cgx.sparse.wbell import pick_format as j_pick
    from cgx_torch.sparse.wbell import pick_format

    a = random_spd_csr(128, 0.05, np.random.default_rng(4))
    assert thp._pick_inner_format(a, device=CPU) == pick_format(
        a, device=CPU) == j_pick(a) == "csr"
    offs = [-3, -2, -1, 0, 1, 2, 3]
    band = sp.diags([np.ones(128 - abs(k)) for k in offs], offs,
                    format="csr")
    assert thp._pick_inner_format(band, device=CPU) == pick_format(
        band, device=CPU) == "ell"
    b = np.random.default_rng(6).standard_normal(128)
    res, info = thp.ir_df64_solve(a, b, tol=1e-7, inner_format="auto",
                                  device=CPU)
    assert _true_rel(a, b, tdf.df_to_f64(res.x)) <= 1.5e-7
    _, info_j = jhp.ir_df64_solve(a, b, tol=1e-7, inner_format="auto")
    _same_ir(info, info_j)


def test_wbell_routing_threshold_unified():
    """One threshold for every auto surface: past WBELL_MIN_ROWS an
    irregular matrix goes to WBELL on the card (deciding builds nothing,
    so no card is needed to ask), and to CSR on the CPU; one row short of
    the threshold, CSR everywhere."""
    import cgx_torch.sparse.wbell as W

    n = W.WBELL_MIN_ROWS + 1
    rng = np.random.default_rng(0)
    a = sp.random(n, n, density=2e-4, random_state=rng, format="csr")
    a = (a + a.T + sp.identity(n, format="csr")).tocsr()
    assert W.pick_format(a) == "wbell"
    assert thp._pick_inner_format(a) == "wbell"
    assert W.pick_format(a, min_rows_wbell=n + 1) == "csr"
    assert W.pick_format(a, device=CPU) == thp._pick_inner_format(
        a, device=CPU) == "csr"


def test_make_ir_df64_solver_reuses_build():
    """The factory: one build, several right-hand sides, each reaching
    the tolerance as cgx's factory does."""
    a, _ = _ill_conditioned_spd(n=200, kappa=1e6)
    solve = thp.make_ir_df64_solver(a, tol=1e-8, inner_tol=1e-2,
                                    inner_maxiter=2000, device=CPU)
    solve_j = jhp.make_ir_df64_solver(a, tol=1e-8, inner_tol=1e-2,
                                      inner_maxiter=2000)
    rng = np.random.default_rng(42)
    for _ in range(2):
        b = rng.standard_normal(200)
        res, info = solve(b)
        assert bool(res.converged)
        assert info["relres"] <= 1e-8
        res_j, info_j = solve_j(b)
        assert bool(res_j.converged) and info_j["relres"] <= 1e-8


def test_ir_df64_operator_bundle_roundtrip(tmp_path):
    """save_to persists the WBELL+df64 bundle; a factory on the loaded
    bundle repeats the solve with no host build, bit for bit."""
    from cgx_torch.io.native_format import load_df64_operator, peek_kind

    a = _scaled_random(300, 4)
    b = np.random.default_rng(5).standard_normal(300)
    _, mt = _jacobi_pair(a)
    p = str(tmp_path / "op.npz")
    s1 = thp.make_ir_df64_solver(a, tol=1e-6, inner_tol=1e-2,
                                 inner_maxiter=2000, preconditioner=mt,
                                 inner_format="wbell", save_to=p,
                                 device=CPU)
    r1, i1 = s1(b)
    assert peek_kind(p) == "ir_df64"
    op, _ = load_df64_operator(p, device=CPU)
    assert op.wb is not None
    np.testing.assert_array_equal(op.diag, a.diagonal())
    m2 = cgx_torch.JacobiPrecond(inv_diag=torch.from_numpy(
        (1.0 / op.diag).astype(np.float32)))
    s2 = thp.make_ir_df64_solver(prebuilt=op, tol=1e-6, inner_tol=1e-2,
                                 inner_maxiter=2000, preconditioner=m2)
    r2, i2 = s2(b)
    assert i1 == i2
    assert _true_rel(a, b, tdf.df_to_f64(r1.x)) <= 1.5e-6
    np.testing.assert_array_equal(n_(r2.x.hi), n_(r1.x.hi))
    np.testing.assert_array_equal(n_(r2.x.lo), n_(r1.x.lo))


def test_ir_df64_save_to_rejects_non_wbell_inner(tmp_path):
    a, _ = _ill_conditioned_spd(n=128)
    with pytest.raises(ValueError, match="persist"):
        thp.make_ir_df64_solver(a, inner_format="ell",
                                save_to=str(tmp_path / "x.npz"), device=CPU)
    assert not (tmp_path / "x.npz").exists()


def test_ir_df64_multi_rhs_reaches_true_tol():
    """A block of right-hand sides reaches TRUE relres ≤ tol per column
    through batched WBELL inners (K8's plain version over the tier plan);
    the chunked form agrees; outer and inner counts equal cgx's."""
    n, k = 300, 3
    a = _scaled_random(n, 4)
    B = np.random.default_rng(5).standard_normal((n, k))
    solve = thp.make_ir_df64_solver_multi(a, tol=1e-6, inner_tol=1e-2,
                                          inner_maxiter=2000, device=CPU)
    res, info = solve(B)
    assert bool(res.converged.all()), info
    X = tdf.df_to_f64(res.x)
    for j in range(k):
        assert _true_rel(a, B[:, j], X[:, j]) <= 1.5e-6, (j, info)
    _, info_j = jhp.make_ir_df64_solver_multi(
        a, tol=1e-6, inner_tol=1e-2, inner_maxiter=2000)(B)
    _same_ir(info, info_j)
    res_c, info_c = thp.make_ir_df64_solver_multi(
        a, tol=1e-6, inner_tol=1e-2, inner_maxiter=2000, inner_chunk=25,
        device=CPU)(B)
    assert bool(res_c.converged.all()), info_c


def test_ir_df64_resume_from_iterate():
    """A refinement stopped after half its cycles resumes from its iterate
    (x0=res.x) and needs fewer cycles to the same TRUE accuracy."""
    a = _scaled_random(300, 5)
    b = np.random.default_rng(5).standard_normal(300)
    _, mt = _jacobi_pair(a)
    kw = dict(tol=1e-8, inner_tol=1e-2, inner_maxiter=2000,
              preconditioner=mt, inner_format="wbell", device=CPU)
    solver = thp.make_ir_df64_solver(a, **kw)
    full, info_full = solver(b)
    assert bool(full.converged)
    part, _ = thp.make_ir_df64_solver(
        a, max_outer=max(1, info_full["outer"] // 2), **kw)(b)
    res, info_res = solver(b, x0=part.x)
    assert bool(res.converged)
    assert info_res["outer"] < info_full["outer"] or info_full["outer"] <= 1
    assert _true_rel(a, b, tdf.df_to_f64(res.x)) <= 1.5e-8


def test_ir_df64_multi_resume_from_iterate():
    n, k = 300, 2
    a = _scaled_random(n, 4)
    B = np.random.default_rng(9).standard_normal((n, k))
    kw = dict(tol=1e-8, inner_tol=1e-2, inner_maxiter=2000, device=CPU)
    solver = thp.make_ir_df64_solver_multi(a, **kw)
    full, info_full = solver(B)
    assert bool(full.converged.all())
    part, _ = thp.make_ir_df64_solver_multi(
        a, max_outer=max(1, info_full["outer"] // 2), **kw)(B)
    res, info_res = solver(B, x0=part.x)
    assert bool(res.converged.all())
    assert info_res["outer"] < info_full["outer"] or info_full["outer"] <= 1


def test_operators_from_cgx_solve_alike():
    """A cgx DF64ELL carried by interop is the port's own build, and a
    cgx DF64 iterate carried by df64_from_cgx resumes the port's
    refinement."""
    from cgx_torch.interop import df64_from_cgx, operator_from_cgx

    a, b = _clustered_spectrum_spd(96, 3e7, seed=7)
    carried = operator_from_cgx(jhp.df64_ell_from_csr(a), device=CPU)
    own = thp.df64_ell_from_csr(a, device=CPU)
    for f in ("vhi", "vlo", "col_indices"):
        assert torch.equal(getattr(carried, f), getattr(own, f))
    part, _ = jhp.make_ir_df64_solver(a, tol=1e-6, max_outer=1)(b)
    res, info = thp.make_ir_df64_solver(a, tol=1e-6, device=CPU)(
        b, x0=df64_from_cgx(part.x, device=CPU))
    assert bool(res.converged)
    assert _true_rel(a, b, tdf.df_to_f64(res.x)) <= 1.5e-6


def test_entry_points_need_the_card_by_default():
    """Without a device argument the constructors go to the card, and raise
    without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a, _ = _ill_conditioned_spd(16, 1e2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        thp.df64_ell_from_csr(a)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdf.df_from_f64(np.ones(4))

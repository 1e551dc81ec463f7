"""The port's DIA/CSR formats, JacobiPrecond, the DIA host prep and K2's
planes/weight mode (its plain version, resident_dia_cg) against cgx on the
CPU.  The same numpy data goes to both packages; cgx's Pallas kernel runs
in interpret mode, as its own tests run it."""
import importlib

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
from cgx.io import poisson as jpo  # noqa: E402
from cgx.sparse import types as jty  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import (  # noqa: E402
    operator_from_cgx, precond_from_cgx)
from cgx_torch.io import poisson as tpo  # noqa: E402
from cgx_torch.kernels import fused_dia_cg as tfd  # noqa: E402
from cgx_torch.kernels import fused_resident as k2  # noqa: E402
from cgx_torch.sparse.types import (  # noqa: E402
    csr_from_scipy, dia_from_csr)
from conftest import random_spd_csr  # noqa: E402
from torch_parity import n_, scaled_dia_data, seeded, t  # noqa: E402

jfd = importlib.import_module("cgx.kernels.fused_dia_cg")
jres = importlib.import_module("cgx.kernels.fused_resident")


def _poisson11(nx, ny, nz, seed=5):
    """SPD 11-point banded operator: the 7-point Laplacian plus a symmetric
    ±(nz+1) coupling (needs grid metadata), as cgx's kernel tests build."""
    a = tpo.poisson3d_dia(nx, ny, nz, device="cpu")
    n = a.shape[0]
    flat = np.arange(n)
    k = flat % nz
    j = (flat // nz) % ny
    c = -0.25 * (1.0 + 0.5 * np.random.default_rng(seed).random(n))
    up = np.where((k < nz - 1) & (j < ny - 1), c, 0.0)
    dn = np.zeros(n)
    dn[nz + 1:] = up[:-(nz + 1)]
    data = np.concatenate([dn[None], a.data.numpy(), up[None]])
    data[1 + 3] = 6.0 + 2 * 0.5
    offsets = (-(nz + 1),) + tuple(a.offsets) + (nz + 1,)
    return data, offsets, (n, n), (nx, ny, nz)


def _data(kind):
    """``(data fp64 numpy, offsets, shape, grid)`` of a named operator."""
    if kind == "scaled7":
        return (*scaled_dia_data(6, 8, 7, seed=1), None)
    if kind == "p11":
        return _poisson11(8, 7, 6)
    if kind in ("p2d_grid", "p2d_nogrid"):
        a = tpo.poisson2d_dia(12, 9, device="cpu")
        return (a.data.numpy(), a.offsets, a.shape,
                (12, 1, 9) if kind == "p2d_grid" else None)
    if kind == "p27var":
        a = tpo.poisson3d_dia27(5, 6, 7, variable=True, seed=3,
                                dtype=np.float64, device="cpu")
        return a.data.numpy(), a.offsets, a.shape, a.grid
    if kind == "asym":
        data, offs, shape = scaled_dia_data(6, 8, 7, seed=1)
        data = data.copy()
        data[4, 100] *= 1.5
        return data, offs, shape, None
    raise KeyError(kind)


def _pair(kind, dtype=np.float64):
    """The same operator as a cgx and a cgx_torch DIAMatrix."""
    data, offs, shape, grid = _data(kind)
    aj = jty.DIAMatrix(data=jnp.asarray(data.astype(dtype)), offsets=offs,
                       shape=shape, grid=grid)
    return aj, operator_from_cgx(aj, device="cpu")


@pytest.mark.parametrize("kind", ["p2d", "p3d", "p27", "p27var"])
def test_builders_bit_identical(kind):
    nd = {"p2d": (lambda m, **kw: m.poisson2d_dia(7, 5, **kw)),
          "p3d": (lambda m, **kw: m.poisson3d_dia(4, 5, 6, **kw)),
          "p27": (lambda m, **kw: m.poisson3d_dia27(4, 5, 6, **kw)),
          "p27var": (lambda m, **kw: m.poisson3d_dia27(
              4, 5, 6, variable=True, seed=7, **kw))}[kind]
    aj, at = nd(jpo), nd(tpo, device="cpu")
    assert at.offsets == tuple(aj.offsets) and at.shape == aj.shape
    assert at.grid == aj.grid
    np.testing.assert_array_equal(n_(at.data), np.asarray(aj.data))


@pytest.mark.parametrize("kind", ["scaled7", "p11", "p2d_grid", "p27var"])
def test_dia_spmv_spmm_match_cgx_fp64(kind):
    aj, at = _pair(kind)
    n = aj.shape[0]
    x = seeded(n, seed=41)
    xs = np.stack([seeded(n, seed=42 + j) for j in range(3)], axis=1)
    y = cgx_torch.spmv(at, t(x))
    ys = cgx_torch.spmm(at, t(xs))
    # fp64, the same products summed in the same order: <= 1e-12 relative.
    ref = np.asarray(cgx.spmv(aj, jnp.asarray(x)))
    refs = np.asarray(cgx.spmm(aj, jnp.asarray(xs)))
    np.testing.assert_allclose(n_(y), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(n_(ys), refs, rtol=0,
                               atol=1e-12 * np.abs(refs).max())


@pytest.mark.parametrize("kind", ["random_spd", "poisson2d"])
def test_csr_spmv_and_dia_from_csr(kind):
    s = (random_spd_csr(60, 0.08, np.random.default_rng(3))
         if kind == "random_spd"
         else sp.csr_matrix(sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1],
                                     shape=(50, 50))))
    aj, at = jty.csr_from_scipy(s), csr_from_scipy(s, device="cpu")
    n = s.shape[0]
    x = seeded(n, seed=43)
    xs = np.stack([seeded(n, seed=44 + j) for j in range(2)], axis=1)
    # fp64, per-row sums of a few products in another order: <= 1e-12.
    for got, ref in ((cgx_torch.spmv(at, t(x)), s @ x),
                     (cgx_torch.spmm(at, t(xs)), s @ xs),
                     (at.diagonal(), s.diagonal())):
        np.testing.assert_allclose(n_(got), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(n_(cgx_torch.spmv(at, t(x))),
                               np.asarray(cgx.spmv(aj, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    if kind == "random_spd":
        # More than 64 populated diagonals: both packages refuse.
        for fn, a in ((jty.dia_from_csr, aj), (dia_from_csr, at)):
            with pytest.raises(ValueError, match="diagonals"):
                fn(a)
    else:
        dj, dt = jty.dia_from_csr(aj), dia_from_csr(at)
        assert dt.offsets == tuple(dj.offsets) and dt.shape == dj.shape
        np.testing.assert_array_equal(n_(dt.data), np.asarray(dj.data))
    # CSR crosses through interop as well.
    back = operator_from_cgx(aj, device="cpu")
    np.testing.assert_array_equal(n_(back.values), np.asarray(aj.values))
    np.testing.assert_array_equal(n_(back.col_indices),
                                  np.asarray(aj.col_indices))


@pytest.mark.parametrize("kind", ["dia", "csr"])
def test_jacobi_precond_matches_cgx(kind):
    if kind == "dia":
        aj, at = _pair("scaled7")
    else:
        s = random_spd_csr(40, 0.1, np.random.default_rng(4))
        aj, at = jty.csr_from_scipy(s), csr_from_scipy(s, device="cpu")
    mj = cgx.JacobiPrecond.from_matrix(aj)
    mt = cgx_torch.JacobiPrecond.from_matrix(at)
    r = seeded(aj.shape[0], seed=45)
    # One reciprocal and one product each, fp64: <= 1e-12 relative.
    np.testing.assert_allclose(n_(mt.inv_diag), np.asarray(mj.inv_diag),
                               rtol=1e-12)
    np.testing.assert_allclose(n_(mt.apply(t(r))),
                               np.asarray(mj.apply(jnp.asarray(r))),
                               rtol=1e-12)
    np.testing.assert_array_equal(
        n_(precond_from_cgx(mj, device="cpu").inv_diag),
        np.asarray(mj.inv_diag))


@pytest.mark.parametrize("kind", ["scaled7", "p11", "p2d_grid", "p2d_nogrid",
                                  "p27var"])
def test_engine_spec_and_supports_match_cgx(kind):
    aj, at = _pair(kind, np.float32)
    spec_j, spec_t = jfd.dia_engine_spec(aj), tfd.dia_engine_spec(at)
    assert (spec_t is None) == (spec_j is None)
    if spec_j is not None:
        assert tuple(spec_t[:3]) == tuple(spec_j[:3])
        assert [tuple(x) for x in spec_t[3]] == [tuple(x) for x in spec_j[3]]
    assert tfd.supports_dia(at) == jfd.supports_dia(aj)
    assert tfd.dia_pattern_dims(at) == jfd.dia_pattern_dims(aj)
    assert tfd.wrap_entries_zero_or_none(at) == \
        jfd.wrap_entries_zero_or_none(aj)


def _dirty(kind):
    """cgx's dirty 7-point matrices (tests/test_kernels.py): a nonzero at an
    x-plane-crossing slot of offset +1 (and its mirror), or of +nz."""
    a = tpo.poisson3d_dia(4, 5, 6, device="cpu")
    data = a.data.numpy().copy()
    if kind == "dirty_pm1":
        data[4, 59] = 1.0
        data[2, 60] = 1.0
    elif kind == "dirty_nz":
        data[5, 26] = 0.5
    return data, a.offsets, a.shape


@pytest.mark.parametrize("kind", ["clean", "dirty_pm1", "dirty_nz", "asym",
                                  "p27var"])
def test_wrap_entries_and_symmetry_match_cgx(kind):
    if kind in ("asym", "p27var"):
        aj, at = _pair(kind, np.float32)
    else:
        data, offs, shape = _dirty(kind)
        aj = jty.DIAMatrix(data=jnp.asarray(data), offsets=offs, shape=shape)
        at = operator_from_cgx(aj, device="cpu")
    assert tfd.wrap_entries_zero(at) == jfd.wrap_entries_zero(aj)
    assert tfd.data_symmetric_or_none(at) == jfd.data_symmetric_or_none(aj)
    assert tfd.wrap_entries_zero(at) == (kind not in ("dirty_pm1",
                                                      "dirty_nz"))


@pytest.mark.parametrize("case", ["scaled7", "scaled7_plain", "p11",
                                  "asym", "p27var", "custom_inv"])
def test_dia_prep_matches_cgx(case):
    kind = {"scaled7_plain": "scaled7", "custom_inv": "scaled7"}.get(case,
                                                                    case)
    aj, at = _pair(kind, np.float32)
    kw = {"jacobi": case != "scaled7_plain"}
    kw_t = dict(kw)
    if case == "custom_inv":
        inv = (0.5 + np.random.default_rng(6).random(aj.shape[0])).astype(
            np.float32)
        kw, kw_t = dict(inv_diag=jnp.asarray(inv)), dict(inv_diag=t(inv))
    pj = jfd.dia_prep(aj, jnp.float32, **kw)
    pt = tfd.dia_prep(at, torch.float32, **kw_t)
    assert tuple(pt[:3]) == tuple(pj[:3])
    assert [tuple(x) for x in pt[3]] == [tuple(x) for x in pj[3]]
    assert pt[4] == tuple(pj[4])
    assert pt[8] == pj[8]
    # Elementwise fp32 products in the same order: equal to the last bit
    # but for XLA's own rounding of sqrt; 1 ulp allowed.
    for got, ref in zip(pt[5:8], pj[5:8]):
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_allclose(n_(got), np.asarray(ref), rtol=2e-7,
                                       atol=0)


@pytest.mark.parametrize("case", ["scaled7", "scaled7_warm", "p11",
                                  "p2d_grid"])
def test_resident_dia_cg_matches_cgx(case):
    aj, at = _pair(case.replace("_warm", ""), np.float32)
    n = aj.shape[0]
    b = seeded(n, seed=46, dtype=np.float32)
    x0 = ((0.1 * seeded(n, seed=47)).astype(np.float32)
          if case.endswith("warm") else None)
    ref = jres.resident_dia_cg(aj, jnp.asarray(b),
                               None if x0 is None else jnp.asarray(x0),
                               tol=1e-5, maxiter=800, interpret=True)
    before = k2.resident_dia_launches
    res = k2.resident_dia_cg(at, t(b), None if x0 is None else t(x0),
                             tol=1e-5, maxiter=800)
    assert k2.resident_dia_launches == before     # CPU: the plain version
    assert bool(res.converged)
    # fp32 sums in another order: cgx's own kernel tests allow ±2
    # iterations and these tolerances (tests/test_kernels.py:191-193).
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)


def test_xla_route_jacobi_pcg_matches_cgx_fp64():
    aj, at = _pair("scaled7")
    b = seeded(aj.shape[0], seed=48)
    ref = cgx.cg_solve(aj, jnp.asarray(b), tol=1e-10, maxiter=800,
                       preconditioner=cgx.JacobiPrecond.from_matrix(aj))
    res = cgx_torch.cg_solve(at, t(b), tol=1e-10, maxiter=800,
                             preconditioner=precond_from_cgx(
                                 cgx.JacobiPrecond.from_matrix(aj),
                                 device="cpu"))
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(ref.x)).max())


def test_resident_dia_refuses_wrap_entries():
    data, offs, shape = _dirty("dirty_pm1")
    at = cgx_torch.DIAMatrix(data=t(data.astype(np.float32)), offsets=offs,
                             shape=shape)
    with pytest.raises(ValueError, match="x-plane"):
        k2.resident_dia_cg(at, torch.ones(shape[0]))
    with pytest.raises(ValueError, match="x-plane"):
        tfd.fused_dia_cg(at, torch.ones(shape[0]))


@pytest.mark.parametrize("kind,dtype,expect", [
    ("scaled7", torch.float32, True), ("p27var", torch.float32, True),
    ("scaled7", torch.float64, False), ("p2d_nogrid", torch.float32, False),
    ("dirty", torch.float32, False)])
def test_resident_supported_dia(kind, dtype, expect):
    if kind == "dirty":
        data, offs, shape = _dirty("dirty_nz")
        at = cgx_torch.DIAMatrix(data=t(data), offsets=offs, shape=shape)
    else:
        at = _pair(kind, np.float32)[1]
    assert k2.resident_supported(at, dtype) is expect


def test_planes_mode_resume_reaches_same_x():
    at = _pair("scaled7", np.float32)[1]
    nx, ny, nz, taps, coeffs, planes, e, w, sym = tfd.dia_prep(
        at, torch.float32)
    spec = (nx, ny, nz, taps, coeffs)
    b = e * t(seeded(at.shape[0], seed=49, dtype=np.float32))
    kw = dict(planes=planes, weight=w, sym=sym, tol=1e-6)
    full = k2.resident_cg_call(spec, b, maxiter=800, **kw)
    x, r, p, k, rz, _ = k2.resident_cg_call(spec, b, maxiter=9, **kw)
    assert int(k) == 9
    rest = k2.resident_cg_call(spec, b, maxiter=800,
                               resume=(x, r, p, rz[0], rz[1]), **kw)
    assert 9 + int(rest[3]) == int(full[3])
    np.testing.assert_array_equal(n_(rest[0]), n_(full[0]))

"""The port's unstructured-sparsity path against cgx on the CPU: the
stand-ins and Matrix Market I/O, ELL, the WBELL build, the plain versions
of K7/K8/K9, the tier plan, the WBELL solvers, the format choice and the
interop.  The same seeded numpy data goes to both packages; cgx's Pallas
kernels run in interpret mode, as tests/test_wbell.py runs them.  The JAX
results are computed once per module (each interpret-mode compile takes
seconds)."""
import dataclasses
import gzip
import shutil

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
from cgx.io import matrix_market as jmm  # noqa: E402
from cgx.io import suitesparse as jss  # noqa: E402
from cgx.kernels import wbell as jkw  # noqa: E402
from cgx.sparse import types as jty  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import operator_from_cgx, precond_from_cgx  # noqa
from cgx_torch.io import matrix_market as tmm  # noqa: E402
from cgx_torch.io import suitesparse as tss  # noqa: E402
from cgx_torch.kernels import wbell as tkw  # noqa: E402
from torch_parity import n_, t  # noqa: E402

CPU = "cpu"
WB_TENSORS = ("values", "lc", "outg", "ps", "wb", "zi", "g0", "gn", "perm",
              "iperm", "diag_internal", "pgo", "p_og", "p_ga")
WB_STATIC = ("shape", "ng_real", "nt", "ngw", "wbcap", "span", "nnz")


def _random_spd(n, density, seed):
    """tests/test_wbell.py's random SPD matrix."""
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    return sp.csr_matrix((a + a.T) + sp.eye(n) * (2.0 + density * n))


def _random_spd12(n, seed):
    """tests/test_wbell.py's multi-RHS matrix: (A + Aᵀ) + 12 I."""
    a = sp.random(n, n, density=0.004, random_state=seed, format="csr")
    return sp.csr_matrix((a + a.T) + sp.eye(n) * 12.0)


def _scipy(a):
    return sp.csr_matrix((n_(a.values), n_(a.col_indices), n_(a.indptr)),
                         shape=a.shape)


def _maxrel(got, ref):
    """Max-norm relative difference."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def thermal():
    """The thermal2 stand-in at scale 0.004 (4,912 rows) in both packages,
    as CSR and WBELL."""
    aj = jss.standin("thermal2", scale=0.004)
    at = tss.standin("thermal2", scale=0.004, device=CPU)
    wj = cgx.wbell_from_csr(aj)
    wt = cgx_torch.wbell_from_csr(at, device=CPU)
    return dict(aj=aj, at=at, wj=wj, wt=wt, s=_scipy(at))


@pytest.fixture(scope="module")
def products(thermal):
    """cgx's K7 (k = 1 and 3) and K8 (k = 3) on seeded internal-layout
    operands (interpret mode; K9 equals K7 bitwise, tests/test_wbell.py)."""
    wj = thermal["wj"]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, wj.nt, 8, 128)).astype(np.float32)
    plan = jkw.build_tier_plan(wj)
    return dict(x=x, plan=plan,
                y1=np.asarray(jkw.wbell_spmv(wj, jnp.asarray(x[0]))),
                y3=np.asarray(jkw.wbell_spmm(wj, jnp.asarray(x))),
                y3t=np.asarray(jkw.wbell_spmm_tiered(plan, jnp.asarray(x))))


# -- stand-ins and Matrix Market ------------------------------------------

@pytest.mark.parametrize("name,scale", [
    ("thermal2", 0.004), ("ecology2", 0.001), ("G3_circuit", 0.002),
    ("parabolic_fem", 0.004), ("bcsstk17", 0.25)])
def test_standin_matches_cgx(name, scale):
    aj = jss.standin(name, seed=3, scale=scale)
    at = tss.standin(name, seed=3, scale=scale, device=CPU)
    assert at.shape == aj.shape
    for f in ("values", "col_indices", "indptr"):
        np.testing.assert_array_equal(n_(getattr(at, f)),
                                      np.asarray(getattr(aj, f)))
    assert tss.SUITESPARSE_SPD == jss.SUITESPARSE_SPD


@pytest.mark.parametrize("gz", [False, True])
def test_matrix_market_matches_cgx(tmp_path, monkeypatch, gz):
    at = tss.standin("parabolic_fem", scale=0.002, device=CPU)
    path = str(tmp_path / "m.mtx")
    tmm.write_matrix_market(path, at, comment="cgx_torch")
    if gz:
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            shutil.copyfileobj(f, g)
        path += ".gz"
    aj = jmm.read_matrix_market(path)
    back = tmm.read_matrix_market(path, device=CPU)
    for f in ("values", "col_indices", "indptr"):
        np.testing.assert_array_equal(n_(getattr(back, f)),
                                      np.asarray(getattr(aj, f)))
        np.testing.assert_array_equal(n_(getattr(back, f)),
                                      n_(getattr(at, f)))
    # The real matrix wins when it is present locally; else the stand-in.
    monkeypatch.setenv("CGX_SUITESPARSE_DIR", str(tmp_path))
    got, is_standin = tss.load_or_standin("m", device=CPU)
    assert not is_standin and torch.equal(got.values, back.values)
    got, is_standin = tss.load_or_standin("thermal2", scale=1e-3,
                                          device=CPU)
    assert is_standin and got.shape == (1228, 1228)


# -- ELL ----------------------------------------------------------------------

def test_ell_matches_cgx():
    s = _random_spd(300, 0.02, seed=5)
    aj = jty.csr_from_scipy(s)
    at = cgx_torch.csr_from_scipy(s, device=CPU)
    ej = jty.ell_from_csr(aj, width_multiple=8)
    et = cgx_torch.ell_from_csr(at, width_multiple=8, device=CPU)
    assert et.shape == ej.shape and et.width == ej.width
    np.testing.assert_array_equal(n_(et.values), np.asarray(ej.values))
    np.testing.assert_array_equal(n_(et.col_indices),
                                  np.asarray(ej.col_indices))
    rng = np.random.default_rng(6)
    x, xs = rng.standard_normal(300), rng.standard_normal((300, 2))
    # fp64, a row's products summed over its padded width: <= 1e-12.
    np.testing.assert_allclose(n_(cgx_torch.spmv(et, t(x))),
                               np.asarray(cgx.spmv(ej, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(n_(cgx_torch.spmm(et, t(xs))), s @ xs,
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="width"):
        cgx_torch.ell_from_csr(at, width=2, device=CPU)


# -- the WBELL build ----------------------------------------------------------

def _build_case(case):
    """``(scipy matrix, keyword arguments)`` of a build case."""
    if case in ("thermal", "thermal_span1"):
        a = _scipy(tss.standin("thermal2", scale=0.004, device=CPU))
        return a, (dict(span=1) if case == "thermal_span1" else {})
    return {"natural": (_random_spd(300, 0.05, seed=300),
                        dict(order="natural")),
            "wbcap2": (_random_spd(600, 0.03, seed=11), dict(wbcap=2)),
            "two_groups": (_random_spd(1025, 0.004, seed=1025), {}),
            "bf16": (_random_spd(400, 0.02, seed=7), {})}[case]


@pytest.mark.parametrize("case", ["thermal", "thermal_span1", "natural",
                                  "wbcap2", "two_groups", "bf16"])
def test_wbell_from_csr_arrays_equal(case):
    a, kw = _build_case(case)
    kw_j, kw_t = dict(kw), dict(kw)
    if case == "bf16":
        kw_j["value_dtype"] = jnp.bfloat16
        kw_t["value_dtype"] = torch.bfloat16
    wj = cgx.wbell_from_csr(jty.csr_from_scipy(a), **kw_j)
    wt = cgx_torch.wbell_from_csr(cgx_torch.csr_from_scipy(a, device=CPU),
                                  device=CPU, **kw_t)
    for f in WB_TENSORS:
        got, ref = getattr(wt, f), np.asarray(getattr(wj, f))
        if f == "values" and case == "bf16":
            assert got.dtype == torch.bfloat16
            got, ref = got.float(), ref.astype(np.float32)
        np.testing.assert_array_equal(n_(got), ref, err_msg=f)
    for f in WB_STATIC:
        assert getattr(wt, f) == getattr(wj, f), f
    assert wt.nnz_stored == wj.nnz_stored
    assert wt.vector_dtype == torch.float32
    # The scipy input path builds the same matrix.
    assert torch.equal(cgx_torch.wbell_from_csr(a, device=CPU, **kw_t).lc,
                       wt.lc)
    if case == "thermal_span1":
        assert wt.ngw <= 8      # RCM keeps the windows narrow


def test_wbell_window_rejection_matches_cgx():
    n = 4096
    i = np.arange(64)
    a = sp.coo_matrix((np.ones(64), (i, n - 1 - i)), shape=(n, n)).tocsr()
    a = sp.csr_matrix(a + a.T + sp.eye(n))
    for build, kw in ((cgx.wbell_from_csr, {}),
                      (cgx_torch.wbell_from_csr, dict(device=CPU))):
        with pytest.raises(ValueError, match="max_ngw"):
            build(a, order="natural", max_ngw=1, **kw)


def test_layout_round_trip_and_diagonal(thermal):
    wj, wt, s = thermal["wj"], thermal["wt"], thermal["s"]
    n = s.shape[0]
    v = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    vi = wt.to_internal(t(v))
    np.testing.assert_array_equal(n_(vi),
                                  np.asarray(wj.to_internal(jnp.asarray(v))))
    assert torch.equal(wt.from_internal(vi), t(v))
    taken = np.zeros((wt.nt, 8, 128), bool)
    b_all = np.arange(n) >> 3
    taken[b_all >> 7, np.arange(n) & 7, b_all & 127] = True
    assert np.all(n_(vi)[~taken] == 0.0)          # pad lanes stay zero
    np.testing.assert_allclose(n_(wt.from_internal(wt.diagonal())),
                               s.diagonal(), rtol=1e-6)


# -- the plain versions of K7, K8, K9 -----------------------------------------

@pytest.mark.parametrize("kernel,k", [("k7", 1), ("k9", 1), ("k7", 3),
                                      ("k9", 3), ("k8", 3)])
def test_plain_kernels_match_cgx(thermal, products, kernel, k):
    """The plain versions against cgx's kernels on the same operands.  K7
    and K9 sum in cgx's order, each product and sum rounded on its own
    (XLA's ISA is held below FMA, tests/conftest.py), so they come out
    equal; K8 walks the planes in K7's order where cgx's walks them class
    by class: max relative difference <= 1e-5 (fp32 summation order)."""
    wt = thermal["wt"]
    x = t(products["x"][:k])
    before = (tkw.wbell_resident_launches, tkw.wbell_tiered_launches,
              tkw.wbell_windowed_launches)
    if kernel == "k8":
        got = tkw.wbell_spmm_tiered(tkw.build_tier_plan(wt), x)
        ref = products["y3t"]
    else:
        backend = "resident" if kernel == "k7" else "windowed"
        got = (tkw.wbell_spmv(wt, x[0], backend=backend) if k == 1
               else tkw.wbell_spmm(wt, x, backend=backend))
        ref = products["y1"] if k == 1 else products["y3"]
    if kernel == "k8":
        assert _maxrel(n_(got), ref) <= 1e-5
    else:
        np.testing.assert_array_equal(n_(got), ref)
    # CPU tensors take the plain version: no launch is counted.
    assert (tkw.wbell_resident_launches, tkw.wbell_tiered_launches,
            tkw.wbell_windowed_launches) == before


def test_k7_k8_k9_agree_bitwise(thermal, products):
    """K8 walks each group's planes in their original order and K9 visits
    them tile by tile in the same order, so all three sum alike."""
    wt = thermal["wt"]
    x = t(products["x"])
    y7 = tkw.wbell_spmm(wt, x)
    assert torch.equal(tkw.wbell_spmm_tiered(tkw.build_tier_plan(wt), x), y7)
    assert torch.equal(tkw.wbell_spmm(wt, x, backend="windowed"), y7)
    y = cgx_torch.spmv(wt, x[0])
    assert torch.equal(y, y7[0])
    assert torch.equal(cgx_torch.spmm(wt, x), y7)
    # Against scipy through the layout: fp32 sums of <= 16 terms.
    v = np.random.default_rng(2).standard_normal(wt.n).astype(np.float32)
    np.testing.assert_allclose(n_(tkw.wbell_matvec(wt, t(v))),
                               thermal["s"] @ v, rtol=2e-5, atol=1e-4)


def test_wbell_spmv_dispatch_and_shape_checks(thermal):
    wt = thermal["wt"]
    v = t(np.ones(wt.n, np.float32))
    with pytest.raises(ValueError, match="internal layout"):
        tkw.wbell_spmv(wt, v)
    with pytest.raises(ValueError, match="backend"):
        tkw.wbell_spmv(wt, wt.to_internal(v), backend="nope")
    with pytest.raises(ValueError, match="tier kernel"):
        tkw.wbell_spmm_tiered(tkw.build_tier_plan(wt), wt.to_internal(v))


# -- the tier plan ------------------------------------------------------------

def _assert_plan_equal(pt, pj):
    for f in ("values", "lc", "packed"):
        np.testing.assert_array_equal(n_(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    assert (pt.steps, pt.splane, pt.nt) == (tuple(pj.steps), pj.splane,
                                            pj.nt)


def test_tier_plan_arrays_equal_cgx(thermal, products):
    _assert_plan_equal(tkw.build_tier_plan(thermal["wt"]), products["plan"])


def test_tier_plan_window_end_clamp():
    """The clamp invariant of tests/test_wbell.py:555, asserted for real:
    every plane's tight window [ga, ga + class span) lies inside [0, nt),
    on a matrix whose narrow planes sit at the right end of their window."""
    n = 4000
    d = sp.diags([np.ones(n), np.ones(n - 1900)], [0, 1900], format="csr")
    a = sp.csr_matrix(d + d.T + sp.eye(n) * 5.0)
    wt = cgx_torch.wbell_from_csr(a, device=CPU)
    pt = tkw.build_tier_plan(wt)
    _assert_plan_equal(pt, jkw.build_tier_plan(cgx.wbell_from_csr(a)))
    ga = n_(pt.packed) & 0xFFFF
    lo = 0
    for w, steps in zip((4, 8, 16), pt.steps):
        hi = lo + steps * pt.splane
        assert (ga[lo:hi] >= 0).all() and (ga[lo:hi] + w <= pt.nt).all()
        assert (n_(pt.lc)[lo:hi, 0] // 128 < w).all()
        lo = hi
    assert lo == pt.values.shape[0]
    x = t(np.random.default_rng(3).standard_normal(
        (2, wt.nt, 8, 128)).astype(np.float32))
    assert torch.equal(tkw.wbell_spmm_tiered(pt, x), tkw.wbell_spmm(wt, x))


def test_tier_plan_refuses_what_it_cannot_pack(thermal):
    wt = thermal["wt"]
    with pytest.raises(ValueError, match="65536"):
        tkw.build_tier_plan(dataclasses.replace(wt, nt=1 << 16))
    with pytest.raises(ValueError, match="span"):
        tkw.build_tier_plan(dataclasses.replace(wt, span=32))


# -- the solvers --------------------------------------------------------------

def _iters_to(history, tol, bb):
    """The first k with ‖r_k‖² <= tol²·‖b‖² in a residual history."""
    return int(np.argmax(np.asarray(history) <= tol * tol * bb))


@pytest.mark.parametrize("pc", ["none", "jacobi", "poly", "block_jacobi"])
def test_wbell_cg_solve_matches_cgx(thermal, pc):
    """b = ones on the thermal2 stand-in to 1e-6, both packages with their
    histories.  Both converge and x agrees to 1e-4 relative.  The
    iteration counts are compared where the two recurrences reach 1e-4:
    ±2.  The exits at 1e-6 are not compared: there the fp32 recurrence
    has reached its rounding floor and wanders, and the two packages,
    which sum the dots in another order, exit more than 2 iterations
    apart with x still within 1e-4."""
    wj, wt = thermal["wj"], thermal["wt"]
    b = np.ones(wt.n, np.float32)
    kw = {"none": {}, "jacobi": dict(jacobi=True),
          "poly": dict(precond="poly"),
          "block_jacobi": dict(precond="block_jacobi")}[pc]
    rj = cgx.wbell_cg_solve(wj, jnp.asarray(b), tol=1e-6, track_history=True,
                            **kw)
    rt = cgx_torch.wbell_cg_solve(wt, t(b), tol=1e-6, track_history=True,
                                  **kw)
    assert bool(rj.converged) and bool(rt.converged)
    xj = np.asarray(rj.x, np.float64)
    assert np.linalg.norm(n_(rt.x) - xj) / np.linalg.norm(xj) <= 1e-4
    bb = float(wt.n)
    assert abs(_iters_to(n_(rt.history), 1e-4, bb)
               - _iters_to(np.asarray(rj.history), 1e-4, bb)) <= 2


@pytest.fixture(scope="module")
def multi():
    """tests/test_wbell.py's multi-RHS system (2,500 rows, k = 3, seeded B)
    and cgx's Jacobi solve of it (tier plan by default)."""
    a = _random_spd12(2500, seed=13)
    B = np.random.default_rng(42).standard_normal((2500, 3)).astype(
        np.float32)
    wj = cgx.wbell_from_csr(a)
    ref = cgx.wbell_cg_solve_multi(wj, jnp.asarray(B), tol=1e-6, jacobi=True)
    return dict(a=a, B=B, wj=wj, ref=ref,
                wt=cgx_torch.wbell_from_csr(a, device=CPU))


@pytest.mark.parametrize("tiered", [True, False])
def test_wbell_cg_solve_multi_matches_cgx(multi, tiered):
    """Per column: cgx's iterations ±2 and x to 1e-4 relative; and the
    port's single-RHS solve of that column, bit for bit (K8 and K7 sum in
    one order and the column dots are the single solve's)."""
    wt, B, ref = multi["wt"], multi["B"], multi["ref"]
    res = cgx_torch.wbell_cg_solve_multi(wt, t(B), tol=1e-6, jacobi=True,
                                         tiered=tiered)
    assert res.x.shape == (2500, 3) and res.iterations.shape == (3,)
    for j in range(3):
        assert bool(res.converged[j]) and bool(ref.converged[j])
        assert abs(int(res.iterations[j]) - int(ref.iterations[j])) <= 2
        xj = np.asarray(ref.x[:, j], np.float64)
        assert np.linalg.norm(n_(res.x[:, j]) - xj) / np.linalg.norm(xj) \
            <= 1e-4
        one = cgx_torch.wbell_cg_solve(wt, t(B[:, j]), tol=1e-6, jacobi=True)
        assert int(one.iterations) == int(res.iterations[j])
        assert torch.equal(one.x, res.x[:, j])


@pytest.mark.parametrize("pc", ["block_jacobi", "poly"])
def test_wbell_cg_solve_multi_preconditioners(multi, pc):
    """The multi-RHS preconditioner family: each column converges, solves
    the system to 2e-6 and follows its single-RHS solve exactly."""
    wt, B, a = multi["wt"], multi["B"], multi["a"]
    res = cgx_torch.wbell_cg_solve_multi(wt, t(B[:, :2]), tol=1e-6,
                                         precond=pc)
    for j in range(2):
        assert bool(res.converged[j])
        x = n_(res.x[:, j]).astype(np.float64)
        assert np.linalg.norm(a @ x - B[:, j]) / np.linalg.norm(B[:, j]) \
            <= 2e-6
        one = cgx_torch.wbell_cg_solve(wt, t(B[:, j]), tol=1e-6, precond=pc)
        assert torch.equal(one.x, res.x[:, j])
    with pytest.raises(ValueError, match="not both"):
        cgx_torch.wbell_cg_solve_multi(wt, t(B), jacobi=True, precond=pc)
    with pytest.raises(ValueError, match="unknown wbell precond"):
        cgx_torch.wbell_cg_solve(wt, t(B[:, 0]), precond="ic0")


def test_auto_solve_end_to_end_matches_cgx(thermal, multi):
    """auto_solve over WBELL (built explicitly: cgx's auto_format picks CSR
    off the TPU) in both packages, with a JacobiPrecond carried across:
    one right-hand side (x to 1e-4, iterations to 1e-4 ±2) and three
    (cgx_torch routes a 2-D b to wbell_cg_solve_multi)."""
    wj, wt = thermal["wj"], thermal["wt"]
    b = np.ones(wt.n, np.float32)
    mj = cgx.JacobiPrecond(inv_diag=jnp.asarray(
        1.0 / thermal["s"].diagonal(), jnp.float32))
    mt = precond_from_cgx(mj, device=CPU)
    assert cgx_torch.select_backend(wt, t(b), mt) == "wbell"
    rj = cgx.auto_solve(wj, jnp.asarray(b), tol=1e-6, preconditioner=mj,
                        track_history=True)
    rt = cgx_torch.auto_solve(wt, t(b), tol=1e-6, preconditioner=mt,
                              track_history=True)
    assert bool(rt.converged)
    xj = np.asarray(rj.x, np.float64)
    assert np.linalg.norm(n_(rt.x) - xj) / np.linalg.norm(xj) <= 1e-4
    assert abs(_iters_to(n_(rt.history), 1e-4, wt.n)
               - _iters_to(np.asarray(rj.history), 1e-4, wt.n)) <= 2
    with pytest.raises(ValueError, match="wbell backend"):
        cgx_torch.auto_solve(wt, t(b), preconditioner=object())

    a, B, ref = multi["a"], multi["B"], multi["ref"]
    mj3 = cgx.JacobiPrecond(inv_diag=jnp.asarray(1.0 / a.diagonal(),
                                                 jnp.float32))
    res = cgx_torch.auto_solve(multi["wt"], t(B), tol=1e-6,
                               preconditioner=precond_from_cgx(mj3,
                                                               device=CPU))
    ref2 = cgx.auto_solve(multi["wj"], jnp.asarray(B), tol=1e-6,
                          preconditioner=mj3)
    assert res.x.shape == (2500, 3)
    for j in range(3):
        assert abs(int(res.iterations[j]) - int(ref2.iterations[j])) <= 2
        assert abs(int(ref2.iterations[j]) - int(ref.iterations[j])) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref2.x), rtol=1e-3,
                               atol=1e-4 * float(np.abs(ref2.x).max()))


# -- the format choice --------------------------------------------------------

def test_pick_and_auto_format_match_cgx(thermal):
    """The decision surface: uniform degrees → ELL; large irregular →
    WBELL on CUDA (TPU in cgx); small irregular, or not CUDA → CSR
    unchanged.  Deciding builds nothing, so device="cuda" needs no card."""
    from cgx.sparse.wbell import pick_format as jpick

    aj, at = thermal["aj"], thermal["at"]
    for kw in (dict(), dict(min_rows_wbell=1000)):
        want = jpick(aj, backend="tpu", **kw)
        assert cgx_torch.pick_format(at, device="cuda", **kw) == want
        assert cgx_torch.pick_format(at, device=CPU, **kw) == \
            jpick(aj, backend="cpu", **kw)
    assert cgx_torch.pick_format(at, min_rows_wbell=1000) == "wbell"
    assert cgx_torch.pick_format(at, min_rows_wbell=1000,
                                 allow_wbell=False) == "csr"
    op, fmt = cgx_torch.auto_format(at, device="cuda")   # small: no build
    assert fmt == "csr" and op is at
    op, fmt = cgx_torch.auto_format(at, min_rows_wbell=1000, device=CPU)
    assert fmt == "csr" and op is at
    # Near-uniform 25 nnz/row band: 8-padded width 32, waste 1.28 → ELL.
    dense = np.zeros((216, 216), np.float32)
    for off in range(-12, 13):
        idx = np.arange(216 - abs(off))
        dense[idx + max(0, -off), idx + max(0, off)] = 30.0 if off == 0 \
            else -0.5
    s = sp.csr_matrix(dense)
    opj, fj = cgx.auto_format(jty.csr_from_scipy(s))
    opt, ft = cgx_torch.auto_format(cgx_torch.csr_from_scipy(s, device=CPU),
                                    device=CPU)
    assert fj == ft == "ell" and isinstance(opt, cgx_torch.ELLMatrix)
    np.testing.assert_array_equal(n_(opt.values), np.asarray(opj.values))


# -- interop ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wbell_operator_from_cgx(thermal, products, dtype):
    """Every field of a cgx WBELLMatrix crosses, the static ones included,
    and the carried operator computes cgx's product."""
    if dtype == "float32":
        wj, wt = thermal["wj"], thermal["wt"]
    else:
        wj = cgx.wbell_from_csr(thermal["aj"], value_dtype=jnp.bfloat16)
        wt = cgx_torch.wbell_from_csr(thermal["at"], device=CPU,
                                      value_dtype=torch.bfloat16)
    got = operator_from_cgx(wj, device=CPU)
    for f in WB_TENSORS:
        assert getattr(got, f).dtype == getattr(wt, f).dtype, f
        assert torch.equal(getattr(got, f), getattr(wt, f)), f
    for f in WB_STATIC:
        assert getattr(got, f) == getattr(wj, f), f
    back = operator_from_cgx(got, device=CPU)
    assert torch.equal(back.values, got.values)
    if dtype == "float32":
        x = t(products["x"][0])
        assert _maxrel(n_(cgx_torch.spmv(got, x)), products["y1"]) <= 1e-5
    else:
        # bf16 planes upcast exactly: the product of the fp32 copy.
        x = t(products["x"][:1])
        wide = dataclasses.replace(got, values=got.values.float())
        assert torch.equal(tkw.wbell_spmm(got, x), tkw.wbell_spmm(wide, x))


def test_block_jacobi_precond_matches_cgx(thermal):
    """The extracted 8×8 block inverses equal cgx's (the same blocks
    inverted in fp64 by the same LAPACK call), directly and through
    interop, and the apply agrees."""
    wj, wt = thermal["wj"], thermal["wt"]
    mj = cgx.WBellBlockJacobiPrecond.from_wbell(wj)
    mt = cgx_torch.WBellBlockJacobiPrecond.from_wbell(wt)
    np.testing.assert_array_equal(n_(mt.binv), np.asarray(mj.binv))
    carried = precond_from_cgx(mj, device=CPU)
    assert torch.equal(carried.binv, mt.binv)
    r = np.random.default_rng(4).standard_normal(
        (wt.nt, 8, 128)).astype(np.float32)
    # fp32, 8-term sums in another order: 1e-5 of the largest entry.
    zj = np.asarray(mj.apply_internal(jnp.asarray(r)))
    np.testing.assert_allclose(n_(mt.apply(t(r))), zj, rtol=0,
                               atol=1e-5 * np.abs(zj).max())


def test_polynomial_precond_matches_cgx():
    s = _random_spd(200, 0.03, seed=21)
    aj = jty.csr_from_scipy(s)
    at = cgx_torch.csr_from_scipy(s, device=CPU)
    mj = cgx.PolynomialPrecond.from_matrix(aj, steps=4, omega=0.6)
    mt = cgx_torch.PolynomialPrecond.from_matrix(at, steps=4, omega=0.6)
    r = np.random.default_rng(8).standard_normal(200)
    zj = np.asarray(mj.apply(jnp.asarray(r)))
    # fp64, four sweeps of the same products: <= 1e-12 relative.
    np.testing.assert_allclose(n_(mt.apply(t(r))), zj, rtol=1e-12)
    carried = precond_from_cgx(mj, device=CPU, operator=at)
    assert (carried.steps, carried.omega) == (4, 0.6)
    np.testing.assert_allclose(n_(carried.apply(t(r))), zj, rtol=1e-12)
    with pytest.raises(ValueError, match="operator="):
        precond_from_cgx(mj, device=CPU)


# -- builders land on the card ------------------------------------------------

@pytest.mark.parametrize("builder", [
    "poisson3d_dia", "csr_from_scipy", "from_arrays", "ell_from_csr",
    "wbell_from_csr", "standin", "operator_from_cgx"])
def test_builders_default_to_the_card(builder):
    """Without ``device=`` a builder puts its data on the card; with no
    card it raises instead of falling back to the CPU."""
    from cgx_torch.io.poisson import poisson3d_dia

    s = _random_spd(64, 0.1, seed=2)
    at = cgx_torch.csr_from_scipy(s, device=CPU)
    build = {
        "poisson3d_dia": lambda: poisson3d_dia(3, 4, 5).data,
        "csr_from_scipy": lambda: cgx_torch.csr_from_scipy(s).values,
        "from_arrays": lambda: cgx_torch.CSRMatrix.from_arrays(
            s.data, s.indices, s.indptr, s.shape).values,
        "ell_from_csr": lambda: cgx_torch.ell_from_csr(at).values,
        "wbell_from_csr": lambda: cgx_torch.wbell_from_csr(at).values,
        "standin": lambda: tss.standin("thermal2", scale=1e-4).values,
        "operator_from_cgx": lambda: operator_from_cgx(
            jty.csr_from_scipy(s)).values,
    }[builder]
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build()

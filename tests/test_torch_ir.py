"""Mixed precision in the port against cgx, on the CPU: the bf16 modes of
K3 (plain versions), the bf16 plane mode of K2 and K5, ``bf16_plane_speedup``,
``ir_cg_solve`` and ``auto_solve(mixed_precision=True)``'s routing, and the
faults C2 (row-ordered products) and C3 (history fallback of the sr routes).

cgx runs its Pallas kernels in interpret mode, as tests/test_ir.py runs
them, at that file's sizes (a 12×10×11 stencil, a 10×9×8 variable DIA).
"""
import dataclasses
import importlib

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
import cgx.sparse.stencil as jst  # noqa: E402
from cgx.io import poisson as jpo  # noqa: E402
from cgx.kernels.fused_engine import from_layout  # noqa: E402
import cgx_torch  # noqa: E402
import cgx_torch.solve.auto as auto  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.kernels import fused_dia_cg as tfd  # noqa: E402
from cgx_torch.kernels import fused_engine as k3  # noqa: E402
from cgx_torch.kernels import fused_multi as k5  # noqa: E402
from cgx_torch.kernels import fused_resident as k2  # noqa: E402
from cgx_torch.kernels.fused_cg import build_fused, fused_stencil_cg  # noqa
from cgx_torch.ops.spmv import row_sum  # noqa: E402
from torch_parity import n_, scaled_dia_data, seeded, t  # noqa: E402

jfc = importlib.import_module("cgx.kernels.fused_cg")
jfd = importlib.import_module("cgx.kernels.fused_dia_cg")
jfr = importlib.import_module("cgx.kernels.fused_resident")
jfm = importlib.import_module("cgx.kernels.fused_multi")
jir = importlib.import_module("cgx.solve.ir")

BF16 = torch.bfloat16


def _variable_dia(seed=5, dims=(10, 9, 8)):
    """tests/test_ir.py:118-124: the 7-point Poisson DIA with its diagonal
    scaled by 1 + 0.3·U[0, 1) (symmetric, SPD); cgx's and the port's."""
    d = jpo.poisson3d_dia(*dims, dtype=np.float32)
    n = d.shape[0]
    scale = jnp.asarray(1.0 + 0.3 * np.random.default_rng(seed).random(n),
                        jnp.float32)
    dj = dataclasses.replace(d, data=d.data.at[3].mul(scale))
    return dj, operator_from_cgx(dj, device="cpu")


def _jacobi(dj):
    mj = cgx.JacobiPrecond(inv_diag=1.0 / dj.data[3])
    return mj, cgx_torch.JacobiPrecond(inv_diag=t(np.asarray(mj.inv_diag)))


def _speedup_op(kind):
    if kind == "d7":
        return jpo.poisson3d_dia(8, 8, 8, dtype=np.float32)
    if kind == "variable":
        return _variable_dia()[0]
    d27 = jpo.poisson3d_dia27(8, 8, 8)
    if kind == "d27":
        return d27
    return dataclasses.replace(d27, data=d27.data.at[0, -1].add(0.5))


# -- bf16_plane_speedup --------------------------------------------------------

@pytest.mark.parametrize("n", [8 ** 3, 128 ** 3, 160 ** 3])
@pytest.mark.parametrize("kind", ["d7", "d27", "d27_asym", "variable"])
def test_bf16_plane_speedup_equals_cgx(kind, n):
    """The footprint model, with its TPU constants, float for float on the
    four operators of tests/test_ir.py:170-207 (the 2.8 residency flip at
    27-point 128³ included)."""
    dj = _speedup_op(kind)
    dt = operator_from_cgx(dj, device="cpu")
    assert tfd.bf16_plane_speedup(dt, n) == jfd.bf16_plane_speedup(dj, n)


# -- K3's narrow modes, one step (plain versions) ------------------------------

def _cgx_q(eng, n, p):
    """cgx kernel A's q through the public init: r = 0 − A·x0."""
    st = eng.init(jnp.zeros((n,), eng.dtype), jnp.asarray(p))
    return -np.asarray(from_layout(eng.geom, st.r), np.float32)


def test_kernel_a_bf16_planes_matches_cgx():
    """fp32 vectors with bf16 planes: within 1e-6·max|q| of cgx's
    FusedCG(plane_dtype=bf16) (the same widened fp32 products)."""
    dj, dt = _variable_dia()
    n = dj.shape[0]
    ej, _, _ = jfd.build_fused_dia(dj, jnp.float32, plane_dtype=jnp.bfloat16,
                                   interpret=True)
    et, _, _ = tfd.build_fused_dia(dt, torch.float32, plane_dtype=BF16)
    assert et.planes.dtype == BF16 and et.sym
    p = seeded(n, seed=81, dtype=np.float32)
    q_j = _cgx_q(ej, n, p)
    q_t = n_(et.kernel_a_reference(t(p))[0])
    assert np.abs(q_t - q_j).max() <= 1e-6 * np.abs(q_j).max()


@pytest.mark.parametrize("op", ["stencil", "dia"])
def test_kernel_a_bf16_vectors_matches_cgx(op):
    """bf16 vectors: the port rounds q once, cgx rounds every bf16 term;
    within 2⁻⁶·max|q| (a 7-term row, each term and partial sum off by at
    most half a bf16 ulp in cgx)."""
    if op == "stencil":
        sj = jst.poisson3d_stencil(12, 10, 11)
        ej = jfc.build_fused(sj, jnp.bfloat16, interpret=True)
        et = build_fused(operator_from_cgx(sj, device="cpu"), BF16)
        n = sj.shape[0]
    else:
        dj, dt = _variable_dia()
        ej, _, _ = jfd.build_fused_dia(dj, jnp.bfloat16, interpret=True)
        et, _, _ = tfd.build_fused_dia(dt, BF16)
        n = dj.shape[0]
    p = seeded(n, seed=82, dtype=np.float32).astype(jnp.bfloat16)
    q_j = _cgx_q(ej, n, p)
    q_t, pq, qq = et.kernel_a_reference(t(np.asarray(p, np.float32)).to(BF16))
    assert q_t.dtype == BF16
    err = np.abs(n_(q_t.float()) - q_j).max()
    assert err <= 2.0 ** -6 * np.abs(q_j).max()
    # The sums read the stored bf16 q, exactly.
    assert float(qq) == float(torch.sum(q_t.double() ** 2).float())


def test_kernel_b_bf16_vectors_rounds_alpha_beta_and_each_update():
    """Kernel B's plain version in bf16: α and β rounded to bf16, each
    update taken in fp32 and rounded once; cgx's within a bf16 ulp."""
    sj = jst.poisson3d_stencil(12, 10, 11)
    et = build_fused(operator_from_cgx(sj, device="cpu"), BF16)
    n = sj.shape[0]
    x, r, p = (t(seeded(n, seed=s, dtype=np.float32)).to(BF16)
               for s in (83, 84, 85))
    q, pq, qq = et.kernel_a_reference(p)
    rz = torch.sum(r.double() ** 2).float()
    xn, rn, pn, s, sw = et.kernel_b_reference(rz, pq, qq, x, r, p, q)
    a32 = rz / pq
    alpha = a32.to(BF16).float()
    beta = ((a32 * a32 * qq - rz) / rz).to(BF16).float()
    assert torch.equal(xn, (x.float() + alpha * p.float()).to(BF16))
    assert torch.equal(rn, (r.float() - alpha * q.float()).to(BF16))
    assert torch.equal(pn, (rn.float() + beta * p.float()).to(BF16))
    assert float(s) == float(sw) == float(torch.sum(rn.double() ** 2)
                                          .float())
    # cgx's kernel B in bf16 arithmetic: within a bf16 ulp of the port.
    xj = x.float().numpy().astype(jnp.bfloat16)
    pj = p.float().numpy().astype(jnp.bfloat16)
    xj = np.asarray(xj + jnp.asarray(alpha.item(), jnp.bfloat16) * pj,
                    np.float32)
    assert np.abs(xj - n_(xn.float())).max() <= 2.0 ** -7 * np.abs(xj).max()


# -- The plane mode equals fp32 on pre-rounded planes --------------------------

def _rounded_dia(seed=5):
    """The variable DIA with its data rounded through bf16 (so that, with
    jacobi=False, its planes are exact in bf16)."""
    _, dt = _variable_dia(seed)
    return dataclasses.replace(dt, data=dt.data.to(BF16).float())


@pytest.mark.parametrize("entry", ["fused_dia", "resident_dia",
                                   "fused_dia_multi"])
def test_plane_mode_equals_fp32_on_prerounded_planes(entry):
    """Each entry with plane_dtype=bf16 equals the same call in fp32 on
    planes rounded through bf16, bit for bit: the engines under Jacobi
    scaling (the planes rounded after it), and the user-level call on
    bf16-exact data without scaling."""
    _, dt = _variable_dia()
    n = dt.shape[0]
    b = t(seeded(n, seed=86, dtype=np.float32))
    kw = dict(tol=1e-6, maxiter=500)
    nx, ny, nz, taps, coeffs, planes, e, w, sym = tfd.dia_prep(
        dt, torch.float32)
    pl16 = planes.to(BF16)
    dr = _rounded_dia()
    if entry == "fused_dia":
        eng16 = k3.FusedCG(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                           weight=w, sym=sym, plane_dtype=BF16)
        eng32 = k3.FusedCG(nx, ny, nz, taps, coeffs=coeffs,
                           planes=pl16.float(), weight=w, sym=sym)
        got, ref = eng16.solve(e * b, **kw), eng32.solve(e * b, **kw)
        user = tfd.fused_dia_cg(dr, b, jacobi=False, plane_dtype=BF16, **kw)
        user32 = tfd.fused_dia_cg(dr, b, jacobi=False, **kw)
    elif entry == "resident_dia":
        spec = (nx, ny, nz, taps, coeffs)
        got = k2.resident_cg(spec, e * b, planes=pl16, weight=w, sym=sym,
                             **kw)
        ref = k2.resident_cg(spec, e * b, planes=pl16.float(), weight=w,
                             sym=sym, **kw)
        user = k2.resident_dia_cg(dr, b, jacobi=False, plane_dtype=BF16,
                                  **kw)
        user32 = k2.resident_dia_cg(dr, b, jacobi=False, **kw)
    else:
        B = torch.stack([b, t(seeded(n, seed=87, dtype=np.float32))])
        eng16 = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs,
                                planes=planes, weight=w, sym=sym,
                                plane_dtype=BF16)
        eng32 = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs,
                                planes=pl16.float(), weight=w, sym=sym)
        got, ref = eng16.solve(B * e, **kw), eng32.solve(B * e, **kw)
        user = k5.fused_dia_cg_multi(dr, B.T, jacobi=False, plane_dtype=BF16,
                                     **kw)
        user32 = k5.fused_dia_cg_multi(dr, B.T, jacobi=False, **kw)
    for g, r in ((got, ref), (user, user32)):
        assert bool(torch.all(g.converged))
        assert torch.equal(g.iterations, r.iterations)
        assert torch.equal(g.x, r.x)


@pytest.mark.parametrize("entry", ["fused_dia", "resident_dia",
                                   "fused_dia_multi"])
def test_plane_dtype_solve_matches_cgx(entry):
    """Each plane_dtype=bf16 solve against cgx's (interpret mode): ±2
    iterations, x to rtol 5e-3 / atol 5e-4, and both show the plateau of
    tests/test_ir.py:138-148 (the recurrence converges, the true residual
    stops near the planes' rounding)."""
    dj, dt = _variable_dia()
    n = dj.shape[0]
    b = seeded(n, seed=7, dtype=np.float32)
    kw = dict(tol=1e-6, maxiter=3000)
    if entry == "fused_dia":
        ref = jfd.fused_dia_cg(dj, jnp.asarray(b), plane_dtype=jnp.bfloat16,
                               interpret=True, **kw)
        res = tfd.fused_dia_cg(dt, t(b), plane_dtype=BF16, **kw)
    elif entry == "resident_dia":
        ref = jfr.resident_dia_cg(dj, jnp.asarray(b),
                                  plane_dtype=jnp.bfloat16, interpret=True,
                                  **kw)
        res = k2.resident_dia_cg(dt, t(b), plane_dtype=BF16, **kw)
    else:
        B = np.stack([b, seeded(n, seed=8, dtype=np.float32)], axis=1)
        ref = jfm.fused_dia_cg_multi(dj, jnp.asarray(B),
                                     plane_dtype=jnp.bfloat16,
                                     interpret=True, **kw)
        res = k5.fused_dia_cg_multi(dt, t(B), plane_dtype=BF16, **kw)
    assert bool(np.all(np.asarray(ref.converged)))
    assert bool(torch.all(res.converged))
    its_j = np.max(np.asarray(ref.iterations))
    assert abs(int(torch.max(res.iterations)) - int(its_j)) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)
    for x in (n_(res.x), np.asarray(ref.x)):
        xs = x if x.ndim == 2 else x[:, None]
        bs = B if entry == "fused_dia_multi" else b[:, None]
        for j in range(xs.shape[1]):
            r = bs[:, j] - np.asarray(cgx.spmv(dj, jnp.asarray(xs[:, j])))
            rel = np.linalg.norm(r) / np.linalg.norm(bs[:, j])
            assert 1e-6 < rel < 5e-2


# -- ir_cg_solve ------------------------------------------------------------------

def _ir_case(mode):
    """(cgx operator, port operator, b, cgx/port preconditioner, kwargs of
    both, the inner-iteration bound's factor): the three modes of
    tests/test_ir.py."""
    if mode == "stencil_bf16":
        sj = jst.poisson3d_stencil(12, 10, 11)
        b = np.random.default_rng(3).standard_normal(sj.shape[0])
        return (sj, operator_from_cgx(sj, device="cpu"),
                b.astype(np.float32), (None, None), ({}, {}), 2.0)
    if mode == "dia_planes":
        dj, dt = _variable_dia(seed=11)
        b = np.random.default_rng(13).standard_normal(dj.shape[0])
        return (dj, dt, b.astype(np.float32), _jacobi(dj),
                (dict(inner_dtype=jnp.float32,
                      inner_plane_dtype=jnp.bfloat16, inner_tol=5e-3),
                 dict(inner_dtype=torch.float32, inner_plane_dtype=BF16,
                      inner_tol=5e-3)), 1.5)
    dj = jpo.poisson3d_dia(10, 9, 8, dtype=np.float32)
    b = np.random.default_rng(2).standard_normal(dj.shape[0])
    return (dj, operator_from_cgx(dj, device="cpu"), b.astype(np.float32),
            (None, None), ({}, {}), 2.0)


@pytest.mark.parametrize("mode", ["stencil_bf16", "dia_planes", "dia_none"])
def test_ir_cg_solve_matches_cgx(mode):
    """The three modes: converged, ‖b − A·x‖ ≤ 1.1e-6‖b‖ (fp32, as
    tests/test_ir.py computes it), x within 5e-4 (relative) of
    cgx.ir_cg_solve's, and total inner iterations within the bounds of
    tests/test_ir.py:54,167 against a direct fp32 solve."""
    aj, at, b, (mj, mt), (kj, kt), factor = _ir_case(mode)
    ref = jir.ir_cg_solve(aj, jnp.asarray(b), tol=1e-6, maxiter=4000,
                          preconditioner=mj, interpret=True, **kj)
    res = cgx_torch.ir_cg_solve(at, t(b), tol=1e-6, maxiter=4000,
                                preconditioner=mt, **kt)
    assert bool(res.converged) and bool(ref.converged)
    r = b - np.asarray(cgx.spmv(aj, jnp.asarray(n_(res.x))))
    assert np.linalg.norm(r) <= 1.1e-6 * np.linalg.norm(b)
    xr = np.asarray(ref.x)
    assert np.linalg.norm(n_(res.x) - xr) <= 5e-4 * np.linalg.norm(xr)
    direct = cgx.cg_solve(aj, jnp.asarray(b), tol=1e-6, maxiter=4000,
                          preconditioner=mj)
    assert int(res.iterations) <= int(factor * int(direct.iterations)) + 10


def test_ir_fp32_inner_matches_direct():
    """inner_dtype=float32 makes IR a restarted fp32 CG: the same answer
    as a direct solve to atol 1e-5 (tests/test_ir.py:76-86)."""
    s = cgx_torch.poisson3d_stencil(8, 8, 8)
    b = t(np.random.default_rng(0).standard_normal(512).astype(np.float32))
    res = cgx_torch.ir_cg_solve(s, b, tol=1e-6, maxiter=2000, inner_tol=1e-4,
                                inner_dtype=torch.float32)
    direct = cgx_torch.cg_solve(s, b, tol=1e-6, maxiter=2000)
    assert bool(res.converged)
    np.testing.assert_allclose(n_(res.x), n_(direct.x), rtol=0, atol=1e-5)


def test_ir_reference_is_the_same_loop_and_refuses_other_preconditioners():
    s = cgx_torch.poisson3d_stencil(8, 8, 8)
    b = t(seeded(512, seed=88, dtype=np.float32))
    res = cgx_torch.ir_cg_solve(s, b, tol=1e-6)
    ref = cgx_torch.solve.ir.ir_cg_solve_reference(s, b, tol=1e-6)
    assert torch.equal(res.x, ref.x)
    assert int(res.iterations) == int(ref.iterations)
    assert cgx_torch.ir_supported(s)
    assert cgx_torch.ir_supported(_variable_dia()[1])
    assert not cgx_torch.ir_supported(object())
    with pytest.raises(ValueError, match="JacobiPrecond"):
        cgx_torch.ir_cg_solve(s, b, preconditioner=lambda r: r)


def test_bf16_b_through_the_two_pass_engine_stalls_where_ir_does_not():
    """tests/test_ir.py:98-115: CG in bf16 vectors alone stalls well above
    fp32 accuracy in both packages; K3's bf16 mode takes a bf16 b."""
    sj = jst.poisson3d_stencil(12, 10, 11)
    b = np.random.default_rng(1).standard_normal(sj.shape[0]).astype(
        np.float32)
    plain_j = jfc.fused_stencil_cg(sj, jnp.asarray(b).astype(jnp.bfloat16),
                                   tol=1e-6, maxiter=600, interpret=True)
    st = operator_from_cgx(sj, device="cpu")
    plain_t = fused_stencil_cg(st, t(b).to(BF16), tol=1e-6, maxiter=600)
    assert plain_t.x.dtype == BF16
    for x in (np.asarray(plain_j.x, np.float32), n_(plain_t.x.float())):
        r = b - np.asarray(cgx.spmv(sj, jnp.asarray(x)))
        assert np.linalg.norm(r) / np.linalg.norm(b) > 1e-5
    assert bool(cgx_torch.ir_cg_solve(st, t(b), tol=1e-6,
                                      maxiter=3000).converged)


# -- auto_solve(mixed_precision=True) -----------------------------------------

def test_auto_solve_mixed_precision_routes_normally_below_threshold(
        monkeypatch):
    """On the CPU and below FUSED_MIN_ROWS the opt-in routes as without it
    and still converges (tests/test_ir.py:89-95); ir_cg_solve is not
    called."""
    calls = []
    monkeypatch.setattr(auto, "ir_cg_solve",
                        lambda *a, **k: calls.append(k))
    s = cgx_torch.poisson3d_stencil(8, 8, 8)
    res = cgx_torch.auto_solve(s, torch.ones(512), tol=1e-6,
                               mixed_precision=True)
    assert bool(res.converged) and not calls
    # A named route below FUSED_MIN_ROWS: no IR either.
    res = cgx_torch.auto_solve(s, torch.ones(512), tol=1e-6,
                               backend="fused_stencil", mixed_precision=True)
    assert bool(res.converged) and not calls


@pytest.mark.parametrize("case,planes", [("stencil", False),
                                         ("dia7", True), ("dia2d", False)])
def test_auto_solve_mixed_precision_reaches_ir(monkeypatch, case, planes):
    """With FUSED_MIN_ROWS lowered and a named resident route, the solve
    reaches ir_cg_solve; a DIA operator takes the planes mode exactly
    where bf16_plane_speedup ≥ 1.15 (the symmetric 7-point one, 1.16),
    else bf16 vectors (the 2-D 5-point one, 1.11)."""
    monkeypatch.setattr(auto, "FUSED_MIN_ROWS", 100)
    calls = []
    real = auto.ir_cg_solve

    def counted(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(auto, "ir_cg_solve", counted)
    if case == "stencil":
        a, m, backend = cgx_torch.poisson3d_stencil(12, 10, 11), None, \
            "resident_stencil"
    else:
        a = (_variable_dia()[1] if case == "dia7" else operator_from_cgx(
            dataclasses.replace(jpo.poisson2d_dia(21, 19),
                                grid=(21, 1, 19)), device="cpu").astype(
                torch.float32))
        m, backend = cgx_torch.JacobiPrecond.from_matrix(a), "resident_dia"
        assert (tfd.bf16_plane_speedup(a, a.shape[0]) >= 1.15) == planes
    b = t(seeded(a.shape[0], seed=89, dtype=np.float32))
    res = cgx_torch.auto_solve(a, b, tol=1e-6, preconditioner=m,
                               backend=backend, mixed_precision=True)
    assert len(calls) == 1 and bool(res.converged)
    k = calls[0]
    if planes:
        assert k["inner_plane_dtype"] == BF16
        assert k["inner_dtype"] == torch.float32 and k["inner_tol"] == 5e-3
    else:
        assert "inner_plane_dtype" not in k and "inner_dtype" not in k
    # With history the opt-in is ignored, as in the reference.
    res = cgx_torch.auto_solve(a, b, tol=1e-6, preconditioner=m,
                               backend=backend, mixed_precision=True,
                               track_history=True, maxiter=2000)
    assert len(calls) == 1 and res.history.shape == (2001,)


# -- Faults C2 and C3 ---------------------------------------------------------

@pytest.mark.parametrize("fmt", ["csr", "coo_shuffled", "bsr"])
def test_row_ordered_products_equal_index_add_on_cpu(fmt):
    """C2: the row-ordered sum adds each row's entries in storage order,
    which is what index_add_ computes on the CPU, bit for bit (so the CPU
    results keep today's agreement with cgx)."""
    import scipy.sparse as sp

    m = (sp.random(300, 300, density=0.03, random_state=4, format="csr")
         + sp.eye(300)).tocsr().astype(np.float32)
    a = cgx_torch.csr_from_scipy(m, device="cpu")
    x = t(seeded(300, seed=90, dtype=np.float32))
    if fmt == "bsr":
        bsr = cgx_torch.bsr_from_csr(a, 4)
        got = cgx_torch.spmv(bsr, x)
        xb = x.reshape(-1, 4, 1)
        prods = torch.bmm(bsr.values, xb[bsr.col_indices])
        want = torch.zeros((75, 4, 1)).index_add_(
            0, bsr.row_indices, prods).reshape(-1)
    else:
        rows, cols, vals = a.row_indices, a.col_indices, a.values
        if fmt == "coo_shuffled":
            perm = torch.from_numpy(np.random.default_rng(5).permutation(
                rows.numel()))
            rows, cols, vals = rows[perm], cols[perm], vals[perm]
        prods = vals * x[cols]
        got = row_sum(rows, prods, 300)
        want = torch.zeros(300).index_add_(0, rows, prods)
    assert torch.equal(got, want)
    np.testing.assert_allclose(n_(got), m @ n_(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["sr_stencil", "sr_dia"])
def test_sr_routes_with_history_fall_back(monkeypatch, backend):
    """C3: with track_history=True the semi-resident routes fall back as
    the reference does (cgx/solve/auto.py:267-271): to the loop below
    FUSED_MIN_ROWS, to the two-pass engine at or above it.  Without
    history they still raise and name K4."""
    if backend == "sr_stencil":
        aj = jst.poisson3d_stencil(6, 7, 5)
        at, mj, mt = operator_from_cgx(aj, device="cpu"), None, None
    else:
        aj, at = _variable_dia()
        mj, mt = _jacobi(aj)
    b = seeded(aj.shape[0], seed=91, dtype=np.float32)
    kw = dict(tol=1e-6, maxiter=400, track_history=True, backend=backend)
    ref = cgx.auto_solve(aj, jnp.asarray(b), preconditioner=mj, **kw)
    res = cgx_torch.auto_solve(at, t(b), preconditioner=mt, **kw)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)
    assert res.history.shape == (401,)
    monkeypatch.setattr(auto, "FUSED_MIN_ROWS", 100)
    before = (k3.fused_a_launches, k3.fused_b_launches)
    fused = cgx_torch.auto_solve(at, t(b), preconditioner=mt, **kw)
    assert (k3.fused_a_launches, k3.fused_b_launches) == before   # CPU
    assert abs(int(fused.iterations) - int(ref.iterations)) <= 2
    assert fused.history.shape == (401,)
    with pytest.raises(NotImplementedError, match="K4"):
        cgx_torch.auto_solve(at, t(b), preconditioner=mt, backend=backend)


def test_ir_drops_a_non_finite_correction_and_finishes_in_fp32(monkeypatch):
    """An inner solve that breaks down (bf16 planes can make a nearly
    singular Ã indefinite) gives a non-finite correction: the port drops
    it, ends the refinement and converges through the fp32 finish, where
    the JAX package would carry the NaN into its finish."""
    dj, dt = _variable_dia(seed=11)
    _, mt = _jacobi(dj)
    b = t(np.random.default_rng(13).standard_normal(dj.shape[0]).astype(
        np.float32))
    real = k3.FusedCG.run_reference

    def broken(self, state, upto, tol_sq):
        out = real(self, state, upto, tol_sq)
        if self.plane_dtype == BF16:
            out = dataclasses.replace(out, x=out.x * float("nan"))
        return out

    monkeypatch.setattr(k3.FusedCG, "run_reference", broken)
    res = cgx_torch.ir_cg_solve(dt, b, tol=1e-6, maxiter=4000,
                                preconditioner=mt, inner_dtype=torch.float32,
                                inner_plane_dtype=BF16, inner_tol=5e-3)
    direct = tfd.fused_dia_cg(dt, b, tol=1e-6, maxiter=4000,
                              inv_diag=mt.inv_diag)
    assert bool(res.converged) and bool(torch.isfinite(res.x).all())
    np.testing.assert_allclose(n_(res.x), n_(direct.x), rtol=1e-4,
                               atol=1e-5)


def test_ir_solves_in_fp32_where_bf16_planes_lose_the_spectrum_bottom(
        monkeypatch):
    """Under Jacobi scaling a D·A·D 7-point operator becomes A/6, and bf16
    rounds every −1/6 to −0.16699, a shift of about −0.00195 in the
    spectrum; past ~50³ that exceeds λ_min and the plane mode's operator
    is indefinite (the JAX package's inner solve then breaks down).  The
    smoothest-mode probe sees it and IR solves in fp32 alone, with no
    narrow inner solve."""
    data, offs, shape = scaled_dia_data(64, 64, 64, seed=0)
    d = cgx_torch.DIAMatrix(data=t(data.astype(np.float32)), offsets=offs,
                            shape=shape)
    m = cgx_torch.JacobiPrecond.from_matrix(d)
    eng, _, _ = tfd.build_fused_dia(d, torch.float32, inv_diag=m.inv_diag,
                                    plane_dtype=BF16)
    assert torch.unique(eng.planes.float()).tolist() == [-0.1669921875, 0.0]
    assert 6 * (0.1669921875 - 1 / 6) > (np.pi / 65) ** 2 / 2   # > λ_min
    narrow_runs = []
    real = k3.FusedCG.run_reference

    def counted(self, state, upto, tol_sq):
        if self.plane_dtype == BF16:
            narrow_runs.append(upto)
        return real(self, state, upto, tol_sq)

    monkeypatch.setattr(k3.FusedCG, "run_reference", counted)
    b = t(seeded(d.shape[0], seed=92, dtype=np.float32))
    res = cgx_torch.ir_cg_solve(d, b, tol=1e-6, maxiter=3000,
                                preconditioner=m, inner_dtype=torch.float32,
                                inner_plane_dtype=BF16, inner_tol=5e-3)
    direct = tfd.fused_dia_cg(d, b, tol=1e-6, maxiter=3000,
                              inv_diag=m.inv_diag)
    assert not narrow_runs and bool(res.converged)
    assert int(res.iterations) == int(direct.iterations)
    assert torch.equal(res.x, direct.x)

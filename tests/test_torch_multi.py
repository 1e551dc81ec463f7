"""The multi-RHS path: K5's plain version (FusedCGMulti and the fused_*_multi
solvers), cg_solve_multi's routes, block_cg_solve, BlockJacobiPrecond and
auto_solve with a 2-D b, against cgx (Pallas kernels in interpret mode) on
the CPU."""
import importlib
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
import cgx.sparse.stencil as jst  # noqa: E402
from cgx.io import poisson as jpo  # noqa: E402
from cgx.sparse import types as jty  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import (  # noqa: E402
    operator_from_cgx, precond_from_cgx, result_to_numpy)
from cgx_torch.io.poisson import poisson3d_dia, poisson3d_dia27  # noqa: E402
from cgx_torch.kernels import fused_engine as k3  # noqa: E402
from cgx_torch.kernels import fused_multi as k5  # noqa: E402
from cgx_torch.kernels.fused_dia_cg import fused_dia_cg  # noqa: E402
from cgx_torch.solve import block as tbl  # noqa: E402
from cgx_torch.solve.auto import FUSED_MIN_ROWS  # noqa: E402
from torch_parity import n_, scaled_dia_data, t  # noqa: E402

jfm = importlib.import_module("cgx.kernels.fused_multi")
jbl = importlib.import_module("cgx.solve.block")


def _block(n, k, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def _launches():
    return (k5.multi_a_launches, k5.multi_b_launches, k3.fused_a_launches,
            k3.fused_b_launches)


def _close_multi(res, ref):
    """cgx's own bounds for the multi engine (tests/test_kernels.py:548-
    767): every column converged, the shared count ±2, x to rtol 5e-3 /
    atol 5e-4."""
    assert bool(res.converged.all()) and bool(np.asarray(ref.converged).all())
    its, its_ref = n_(res.iterations), np.asarray(ref.iterations)
    assert len(set(its.tolist())) == 1         # one shared count
    assert abs(int(its[0]) - int(its_ref[0])) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)


@pytest.mark.parametrize("warm", [False, True])
def test_fused_stencil_cg_multi_matches_cgx(warm):
    s = jst.poisson3d_stencil(6, 7, 5)
    n, k = s.shape[0], 4
    b = _block(n, k, seed=71)
    x0 = (0.1 * _block(n, k, seed=72)) if warm else None
    ref = jfm.fused_stencil_cg_multi(
        s, jnp.asarray(b), None if x0 is None else jnp.asarray(x0),
        tol=1e-5, maxiter=500, interpret=True)
    before = _launches()
    res = k5.fused_stencil_cg_multi(operator_from_cgx(s), t(b),
                                    None if x0 is None else t(x0),
                                    tol=1e-5, maxiter=500)
    assert _launches() == before               # the CPU takes no kernel
    assert res.x.shape == (n, k) and res.iterations.shape == (k,)
    _close_multi(res, ref)


def _dia_pair(kind, seed=0):
    """A DIA operator in both packages: the scaled 7-point D·A·D or the
    variable 27-point one, fp32."""
    if kind == "scaled7":
        data, offs, shape = scaled_dia_data(6, 8, 7, seed=seed)
        grid = None
    else:
        a = jpo.poisson3d_dia27(6, 7, 5, variable=True, seed=seed)
        data, offs, shape, grid = (np.asarray(a.data), a.offsets, a.shape,
                                   a.grid)
    aj = jty.DIAMatrix(data=jnp.asarray(data.astype(np.float32)),
                       offsets=offs, shape=shape, grid=grid)
    return aj, operator_from_cgx(aj, device="cpu")


@pytest.mark.parametrize("kind,k", [("scaled7", 3), ("scaled7", 8),
                                    ("dia27", 4)])
def test_fused_dia_cg_multi_matches_cgx(kind, k):
    aj, at = _dia_pair(kind)
    n = aj.shape[0]
    b = _block(n, k, seed=73 + k)
    tol = 1e-6 if kind == "dia27" else 1e-5
    ref = jfm.fused_dia_cg_multi(aj, jnp.asarray(b), tol=tol, maxiter=800,
                                 interpret=True)
    before = _launches()
    res = k5.fused_dia_cg_multi(at, t(b), tol=tol, maxiter=800)
    assert _launches() == before
    _close_multi(res, ref)


def test_dia27_shared_count_and_last_column():
    """On the 27-point operator the columns share the largest single-RHS
    count, and the column that exits last follows its single K3 solve bit
    for bit (the sums are taken exactly in both engines)."""
    _, at = _dia_pair("dia27")
    b = t(_block(at.shape[0], 4, seed=0))
    res = k5.fused_dia_cg_multi(at, b, tol=1e-6)
    singles = [fused_dia_cg(at, b[:, j].contiguous(), tol=1e-6)
               for j in range(4)]
    its = [int(s.iterations) for s in singles]
    assert int(res.iterations[0]) == max(its)
    last = its.index(max(its))
    assert torch.equal(res.x[:, last], singles[last].x)
    for j, s in enumerate(singles):
        np.testing.assert_allclose(n_(res.x[:, j]), n_(s.x), rtol=5e-3,
                                   atol=5e-4)


def test_fused_multi_easy_hard_and_zero_columns():
    """An easy column (A·1), a hard one and an all-zero one: all finite and
    converged; the zero column stays exactly zero (tests/test_kernels.py:
    745-767)."""
    dj = jpo.poisson3d_dia(8, 8, 8, dtype=np.float32)
    dt = operator_from_cgx(dj, device="cpu")
    n = dj.shape[0]
    easy = n_(cgx_torch.spmv(dt, torch.ones(n)))
    hard = np.random.default_rng(74).standard_normal(n).astype(np.float32)
    b = np.stack([easy, hard, np.zeros(n, np.float32)], axis=1)
    ref = jfm.fused_dia_cg_multi(dj, jnp.asarray(b), tol=1e-5, maxiter=600,
                                 interpret=True)
    res = k5.fused_dia_cg_multi(dt, t(b), tol=1e-5, maxiter=600)
    assert torch.isfinite(res.x).all()
    assert float(res.x[:, 2].abs().max()) == 0.0
    _close_multi(res, ref)


def test_engine_steps_and_chunks():
    """FusedCGMulti's plain kernels are K3's per column, and init / run to
    k = 4 / run to the end / result is the solve."""
    _, at = _dia_pair("dia27")
    nx, ny, nz, taps, coeffs, planes, e, w, sym = \
        cgx_torch.kernels.fused_dia_cg.dia_prep(at, torch.float32)
    eng = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                          weight=w, sym=sym)
    one = k3.FusedCG(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                     weight=w, sym=sym)
    p = t(_block(eng.n, 3, seed=75).T.copy())
    q, pq, qq = eng.kernel_a(p)
    for j in range(3):
        qj, pqj, qqj = one.kernel_a(p[j])
        assert torch.equal(q[j], qj) and float(pq[j]) == float(pqj) \
            and float(qq[j]) == float(qqj)
    b = e * t(_block(eng.n, 3, seed=76)).T
    full = eng.solve(b, tol=1e-6, maxiter=400)
    tol_sq = k5.thresholds(b, 1e-6, 0.0, eng.weight)
    st = eng.run(eng.init(b), 4, tol_sq)
    assert int(st.k) == 4
    res = eng.result(eng.run(st, 400, tol_sq), tol_sq)
    assert torch.equal(res.iterations, full.iterations)
    assert torch.equal(res.x, full.x)


def test_cg_solve_multi_matches_cgx_fp64():
    """The batched loop against cgx's vmapped cg_solve in fp64 on the 2-D
    Poisson CSR with Jacobi: per-column iterations equal, x to 1e-9."""
    aj = jpo.poisson2d(12, 12)
    at = operator_from_cgx(aj, device="cpu")
    mj = cgx.JacobiPrecond.from_matrix(aj)
    b = _block(144, 5, seed=77, dtype=np.float64)
    ref = jbl.cg_solve_multi(aj, jnp.asarray(b), tol=1e-10, maxiter=1000,
                             preconditioner=mj)
    res = cgx_torch.cg_solve_multi(at, t(b), tol=1e-10, maxiter=1000,
                                   preconditioner=precond_from_cgx(
                                       mj, device="cpu"))
    assert bool(res.converged.all())
    np.testing.assert_array_equal(n_(res.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-11)
    # Each column is its own single-RHS solve.
    for j in range(5):
        one = cgx_torch.cg_solve(at, t(b[:, j]), tol=1e-10, maxiter=1000,
                                 preconditioner=precond_from_cgx(
                                     mj, device="cpu"))
        assert int(one.iterations) == int(res.iterations[j])
        assert torch.equal(one.x, res.x[:, j])


def test_sequential_backend_equals_single_solves():
    """backend="sequential" is fused_dia_cg per column: equal iterations
    and x bit for bit (tests/test_kernels.py:813-841)."""
    a = poisson3d_dia(8, 6, 7, dtype=np.float32, device="cpu")
    b = t(_block(a.shape[0], 3, seed=78))
    res = cgx_torch.cg_solve_multi(a, b, tol=1e-5, maxiter=500,
                                   backend="sequential")
    assert res.x.shape == (a.shape[0], 3)
    for j in range(3):
        ref = fused_dia_cg(a, b[:, j].contiguous(), tol=1e-5, maxiter=500,
                           jacobi=False)
        assert int(res.iterations[j]) == int(ref.iterations)
        assert torch.equal(res.x[:, j], ref.x)


@pytest.mark.parametrize("kind", ["sym7", "perturbed7", "dia27"])
def test_narrow_band_matches_cgx(kind):
    if kind == "dia27":
        aj = jpo.poisson3d_dia27(5, 6, 7, variable=True, seed=1)
    else:
        aj = jpo.poisson3d_dia(8, 6, 7, dtype=np.float32)
        if kind == "perturbed7":
            data = np.asarray(aj.data).copy()
            data[1] *= 1.00005
            aj = jty.DIAMatrix(data=jnp.asarray(data), offsets=aj.offsets,
                               shape=aj.shape, grid=aj.grid)
    at = operator_from_cgx(aj, device="cpu")
    assert tbl._narrow_band(at) == jbl._narrow_band(aj)
    assert tbl._narrow_band(at) == (kind == "sym7")


def _cuda_like(n, k=4, dtype=torch.float32):
    """A stand-in with what the multi-RHS routing reads of a CUDA block."""
    return SimpleNamespace(device=torch.device("cuda", 0), shape=(n, k),
                           dtype=dtype, dim=lambda: 2)


@pytest.mark.parametrize("op,device,dtype,precond,backend,expect", [
    ("dia27", "cuda", torch.float32, "jacobi", "auto", "fused"),
    ("dia27", "cuda", torch.float32, None, "auto", "fused"),
    ("dia7", "cuda", torch.float32, "jacobi", "auto", "sequential"),
    ("p3d", "cuda", torch.float32, None, "auto", "fused"),
    ("p3d", "cuda", torch.float32, "jacobi", "auto", "xla"),
    ("p3d", "cuda", torch.float64, None, "auto", "xla"),    # K5 is fp32
    ("p3d_small", "cuda", torch.float32, None, "auto", "xla"),
    ("dia27", "cpu", torch.float32, "jacobi", "auto", "xla"),
    ("dia7", "cpu", torch.float32, "jacobi", "fused", "fused"),
    ("dia27", "cpu", torch.float32, "jacobi", "sequential", "sequential"),
    ("dia7", "cuda", torch.float32, "jacobi", "xla", "xla"),
])
def test_multi_routing_table(op, device, dtype, precond, backend, expect):
    """The routes of cg_solve_multi: K5 for stencils and wide DIA and K3
    per column for narrow DIA, on float32 CUDA blocks of at least
    FUSED_MIN_ROWS rows; the batched loop otherwise."""
    m = 150 if op != "p3d_small" else 100
    a = {"dia27": lambda: poisson3d_dia27(m, m, m, variable=True, seed=0,
                                          device="cpu"),
         "dia7": lambda: poisson3d_dia(m, m, m, dtype=np.float32,
                                       device="cpu")}.get(
        op, lambda: cgx_torch.poisson3d_stencil(m, m, m))()
    n = a.shape[0]
    assert (n >= FUSED_MIN_ROWS) == (op != "p3d_small")
    b = (_cuda_like(n, dtype=dtype) if device == "cuda"
         else torch.zeros((n, 4), dtype=dtype))
    pre = (cgx_torch.JacobiPrecond.from_matrix(a)
           if precond == "jacobi" and op != "p3d" else
           (lambda r: r) if precond else None)
    assert tbl._multi_route(a, b, pre, backend)[0] == expect


def test_fused_backends_refuse_other_operators():
    aj = jpo.poisson2d(6, 6)
    at = operator_from_cgx(aj, device="cpu")
    b = torch.ones((36, 2), dtype=torch.float64)
    for backend in ("fused", "sequential"):
        with pytest.raises(ValueError, match="fused-capable"):
            cgx_torch.cg_solve_multi(at, b, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        cgx_torch.cg_solve_multi(at, b, backend="nope")
    with pytest.raises(ValueError, match=r"\(n, k\)"):
        cgx_torch.cg_solve_multi(at, b[:, 0])


@pytest.mark.parametrize("precond", [None, "jacobi", "block_jacobi"])
def test_block_cg_solve_matches_cgx(precond):
    """True block CG against cgx in fp64 on the 2-D Poisson CSR, k = 4:
    x to 1e-6, iterations ±1."""
    aj = jpo.poisson2d(12, 12)
    at = operator_from_cgx(aj, device="cpu")
    mj = {None: None, "jacobi": cgx.JacobiPrecond.from_matrix(aj),
          "block_jacobi": cgx.BlockJacobiPrecond.from_matrix(
              aj, blocksize=12)}[precond]
    mt = None if mj is None else precond_from_cgx(mj, device="cpu")
    b = _block(144, 4, seed=79, dtype=np.float64)
    ref = jbl.block_cg_solve(aj, jnp.asarray(b), tol=1e-9, maxiter=500,
                             preconditioner=mj)
    res = cgx_torch.block_cg_solve(at, t(b), tol=1e-9, maxiter=500,
                                   preconditioner=mt)
    assert bool(res.converged.all()) and bool(np.asarray(ref.converged).all())
    assert abs(int(res.iterations[0]) - int(ref.iterations[0])) <= 1
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=1e-6,
                               atol=1e-8)


def test_block_cg_fewer_iterations_than_single():
    """k clustered right-hand sides share their Krylov space: block CG
    converges in fewer iterations than CG on one of them
    (tests/test_cg.py:326-343)."""
    a = operator_from_cgx(jpo.poisson2d(24, 24), device="cpu")
    rng = np.random.default_rng(80)
    base = rng.standard_normal(576)
    b = t(np.stack([base + 0.05 * rng.standard_normal(576)
                    for _ in range(8)], axis=1))
    res = cgx_torch.block_cg_solve(a, b, tol=1e-8, maxiter=2000)
    single = cgx_torch.cg_solve(a, b[:, 0].contiguous(), tol=1e-8,
                                maxiter=2000)
    assert bool(res.converged.all())
    assert int(res.iterations[0]) < int(single.iterations)


@pytest.mark.parametrize("blocksize", [6, 5])
def test_block_jacobi_precond_matches_cgx(blocksize):
    """Blocks (identity on padding rows) and apply against cgx; with
    blocksize 5 the 42 rows leave 3 padding rows."""
    aj = jpo.poisson2d(7, 6)
    mj = cgx.BlockJacobiPrecond.from_matrix(aj, blocksize=blocksize)
    mt = cgx_torch.BlockJacobiPrecond.from_matrix(
        operator_from_cgx(aj, device="cpu"), blocksize=blocksize)
    assert mt.blocksize == blocksize
    np.testing.assert_allclose(n_(mt.inv_blocks), np.asarray(mj.inv_blocks),
                               rtol=1e-14, atol=1e-15)
    r = np.random.default_rng(81).standard_normal(42)
    np.testing.assert_allclose(n_(mt.apply(t(r))),
                               np.asarray(mj.apply(jnp.asarray(r))),
                               rtol=1e-13, atol=1e-14)
    carried = precond_from_cgx(mj, device="cpu")
    assert carried.blocksize == blocksize
    assert torch.equal(carried.inv_blocks, mt.inv_blocks)


def test_auto_solve_2d_matches_cgx_fp64():
    """auto_solve with a 2-D b on the 27-point DIA under Jacobi, data and
    preconditioner carried from cgx: the batched loop on both sides (the
    CPU), per-column iterations equal, x to 1e-10."""
    aj = jpo.poisson3d_dia27(6, 7, 5, variable=True, seed=2,
                             dtype=np.float64)
    mj = cgx.JacobiPrecond.from_matrix(aj)
    b = _block(aj.shape[0], 3, seed=82, dtype=np.float64)
    ref = cgx.auto_solve(aj, jnp.asarray(b), tol=1e-8, preconditioner=mj)
    res = cgx_torch.auto_solve(operator_from_cgx(aj, device="cpu"), t(b),
                               tol=1e-8, preconditioner=precond_from_cgx(
                                   mj, device="cpu"))
    np.testing.assert_array_equal(n_(res.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-10 * float(np.abs(ref.x).max()))


@pytest.mark.parametrize("backend,expect", [
    (None, "xla"), ("xla", "xla"), ("padded", "xla"), ("fused", "fused"),
    ("resident_stencil", "fused"), ("fused_dia", "fused")])
def test_auto_solve_2d_backend_mapping(backend, expect):
    """A 2-D b maps auto_solve's backend onto cg_solve_multi's: "xla" and
    "padded" are the batched loop (per-column counts), any other name the
    fused engine (one shared count); None lets it route itself (the loop
    on the CPU)."""
    a = cgx_torch.poisson3d_stencil(6, 7, 5)
    b = t(_block(a.shape[0], 4, seed=83))
    res = cgx_torch.auto_solve(a, b, tol=1e-6, backend=backend)
    ref = cgx_torch.cg_solve_multi(a, b, tol=1e-6, backend=expect)
    assert torch.equal(res.iterations, ref.iterations)
    assert torch.equal(res.x, ref.x)
    assert bool(res.converged.all())


def test_auto_solve_2d_refuses_what_it_cannot_honour():
    a = cgx_torch.poisson3d_stencil(4, 4, 4)
    b = torch.ones((64, 2))
    with pytest.raises(ValueError, match="track_history"):
        cgx_torch.auto_solve(a, b, track_history=True)
    # The reference's ValueError (cgx/solve/auto.py:188-191).
    with pytest.raises(ValueError, match="mixed_precision is single-RHS"):
        cgx_torch.auto_solve(a, b, mixed_precision=True)
    # The direct route it names is ported.
    res = k5.fused_dia_cg_multi(poisson3d_dia(4, 4, 4, dtype=np.float32,
                                              device="cpu"), b,
                                plane_dtype=torch.bfloat16)
    assert bool(res.converged.all())


def test_result_to_numpy_of_a_batched_result():
    """A batched result's iterations and converged come back as (k,)
    arrays (they raised before: int() of a (k,) tensor)."""
    r = sp.random(300, 300, density=0.02, random_state=3, format="csr")
    a = sp.csr_matrix((r + r.T) + sp.eye(300) * 8.0)
    w = cgx_torch.wbell_from_csr(a, device="cpu")
    b = t(_block(300, 3, seed=84))
    res = result_to_numpy(cgx_torch.wbell_cg_solve_multi(w, b, tol=1e-6,
                                                         jacobi=True))
    assert res["iterations"].shape == (3,)
    assert res["converged"].shape == (3,) and res["converged"].all()
    assert res["x"].shape == (300, 3)
    one = result_to_numpy(cgx_torch.cg_solve(cgx_torch.poisson3d_stencil(
        3, 3, 3), torch.ones(27), tol=1e-8))
    assert isinstance(one["iterations"], int) and one["converged"] is True

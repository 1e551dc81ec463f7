"""The slice as a whole: cgx_torch.auto_solve against cgx.auto_solve, the
routing table, operator interop, and the port's independence of JAX."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
import cgx.sparse.stencil as jst  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import (  # noqa: E402
    operator_from_cgx, precond_from_cgx, result_to_numpy, tensor_from_numpy)
from cgx_torch.io.poisson import (  # noqa: E402
    poisson2d_dia, poisson3d_dia, poisson3d_dia27)
from cgx_torch.solve.auto import (  # noqa: E402
    FUSED_MIN_ROWS, RESIDENT_MIN_ROWS)
from torch_parity import n_, scaled_dia_data, seeded, t  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("rhs", ["ones", "random", "warm"])
def test_auto_solve_matches_cgx_fp64(rhs):
    a_j = jst.poisson3d_stencil(12, 10, 9)
    a_t = operator_from_cgx(a_j)
    n = a_j.shape[0]
    b = np.ones(n) if rhs == "ones" else seeded(n, seed=31)
    x0 = 0.1 * seeded(n, seed=32) if rhs == "warm" else None
    bj = jnp.asarray(b)
    # On the CPU the JAX package pads this off-tile size; the port does not.
    assert cgx.select_backend(a_j, bj) == "padded"
    assert cgx_torch.select_backend(a_t, t(b)) == "xla"
    res_j = cgx.auto_solve(a_j, bj, None if x0 is None else jnp.asarray(x0),
                           tol=1e-6)
    res_t = cgx_torch.auto_solve(a_t, t(b), None if x0 is None else t(x0),
                                 tol=1e-6)
    assert bool(res_t.converged) and bool(res_j.converged)
    assert int(res_t.iterations) == int(res_j.iterations)
    np.testing.assert_allclose(n_(res_t.x), np.asarray(res_j.x), rtol=1e-10,
                               atol=1e-10 * float(np.abs(res_j.x).max()))
    # The "padded" name is accepted and means the same loop.
    res_p = cgx_torch.auto_solve(a_t, t(b), None if x0 is None else t(x0),
                                 tol=1e-6, backend="padded")
    assert torch.equal(res_p.x, res_t.x)


def _cuda_like(n, dtype=torch.float32):
    """A stand-in with what select_backend reads of a CUDA vector."""
    return SimpleNamespace(device=torch.device("cuda", 0), shape=(n,),
                           dtype=dtype, dim=lambda: 1)


@pytest.mark.parametrize("op,n_side,device,dtype,precond,expect", [
    ("p3d", 60, "cuda", torch.float32, None, "resident_stencil"),
    ("p3d", 58, "cuda", torch.float32, None, "xla"),      # below the min
    ("p3d", 60, "cpu", torch.float32, None, "xla"),
    ("p3d", 60, "cuda", torch.float64, None, "xla"),      # K2 is fp32
    ("p3d", 60, "cuda", torch.float32, "jacobi", "xla"),
    ("p27", 60, "cuda", torch.float32, None, "resident_stencil"),
    ("p2d", 500, "cuda", torch.float32, None, "resident_stencil"),
    ("p2d", 400, "cuda", torch.float32, None, "xla"),
])
def test_routing_table(op, n_side, device, dtype, precond, expect):
    a = {"p3d": lambda m: cgx_torch.poisson3d_stencil(m, m, m),
         "p27": lambda m: cgx_torch.poisson3d_27point(m, m, m),
         "p2d": lambda m: cgx_torch.poisson2d_stencil(m, m)}[op](n_side)
    n = a.shape[0]
    b = (_cuda_like(n, dtype) if device == "cuda"
         else torch.zeros(n, dtype=dtype))
    m = (lambda r: r) if precond else None
    assert cgx_torch.select_backend(a, b, m) == expect


def test_routing_sizes_straddle_the_threshold():
    assert 58 ** 3 < RESIDENT_MIN_ROWS <= 60 ** 3
    assert 400 ** 2 < RESIDENT_MIN_ROWS <= 500 ** 2


@pytest.mark.parametrize("backend", ["sr_stencil", "sr_dia", "wbell"])
def test_unported_backends_raise(backend):
    a = cgx_torch.poisson3d_stencil(4, 4, 4)
    if backend == "wbell":
        # Ported since: the route needs a WBELLMatrix and refuses others.
        with pytest.raises(ValueError, match="WBELLMatrix"):
            cgx_torch.auto_solve(a, torch.ones(64), backend=backend)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgx_torch.auto_solve(a, torch.ones(64), backend=backend)


def _scaled_dia(nx, ny, nz, seed, dtype=np.float32):
    data, offs, shape = scaled_dia_data(nx, ny, nz, seed)
    return cgx_torch.DIAMatrix(data=t(data.astype(dtype)), offsets=offs,
                               shape=shape)


@pytest.mark.parametrize("backend", ["fused_stencil", "fused_dia",
                                     "resident_dia"])
def test_ported_backends_match_cg_solve(backend):
    """Each route, named on a CPU tensor (its plain version), solves the
    system of cg_solve: ±2 iterations, x to rtol 5e-3 / atol 5e-4 (fp32
    sums in another order, cgx's own kernel-test bounds)."""
    if backend == "fused_stencil":
        a, m = cgx_torch.poisson3d_stencil(6, 8, 7), None
    else:
        a = _scaled_dia(6, 8, 7, seed=35)
        m = cgx_torch.JacobiPrecond.from_matrix(a)
    b = t(seeded(a.shape[0], seed=36, dtype=np.float32))
    hist = backend.startswith("fused")
    res = cgx_torch.auto_solve(a, b, tol=1e-6, maxiter=800,
                               preconditioner=m, backend=backend,
                               track_history=hist)
    ref = cgx_torch.cg_solve(a, b, tol=1e-6, maxiter=800, preconditioner=m,
                             track_history=hist)
    assert bool(res.converged) and bool(ref.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(n_(res.x), n_(ref.x), rtol=5e-3, atol=5e-4)
    if hist:
        assert res.history.shape == ref.history.shape == (801,)


def test_history_at_fused_size_takes_the_two_pass_engine():
    """A stencil of ≥ FUSED_MIN_ROWS rows with track_history=True leaves
    the whole-solve route for "fused_stencil", which raised
    NotImplementedError before the engine was ported; on a CPU tensor it
    runs the engine's plain version and returns cg_solve's history."""
    a = cgx_torch.poisson3d_stencil(150, 150, 150)
    n = a.shape[0]
    assert n >= FUSED_MIN_ROWS
    b = torch.ones(n, dtype=torch.float32)
    res = cgx_torch.auto_solve(a, b, backend="resident_stencil",
                               track_history=True, maxiter=3)
    ref = cgx_torch.cg_solve(a, b, maxiter=3, track_history=True)
    assert int(res.iterations) == 3 and res.history.shape == (4,)
    # Three fp32 iterations with sums of 3.4 M terms in another order, and
    # β from the CA identity α²·qq − rz, which cancels: the history to
    # 1e-4 relative, x to 1e-4 of its largest entry (measured 1.8e-5).
    np.testing.assert_allclose(n_(res.history), n_(ref.history), rtol=1e-4)
    np.testing.assert_allclose(n_(res.x), n_(ref.x), rtol=0,
                               atol=1e-4 * float(ref.x.abs().max()))


@pytest.mark.parametrize("op,n_side,device,dtype,precond,expect", [
    ("dia7", 60, "cuda", torch.float32, "jacobi", "resident_dia"),
    ("dia7", 60, "cuda", torch.float32, None, "resident_dia"),
    ("dia7", 58, "cuda", torch.float32, "jacobi", "xla"),   # below the min
    ("dia7", 60, "cpu", torch.float32, "jacobi", "xla"),
    ("dia7", 60, "cuda", torch.float64, "jacobi", "xla"),    # K2 is fp32
    ("dia7", 60, "cuda", torch.float32, "callable", "xla"),
    ("dia7_dirty", 60, "cuda", torch.float32, "jacobi", "xla"),
    ("dia27", 60, "cuda", torch.float32, "jacobi", "resident_dia"),
    ("dia2d_grid", 500, "cuda", torch.float32, "jacobi", "resident_dia"),
    ("dia2d", 500, "cuda", torch.float32, "jacobi", "xla"),  # no grid
])
def test_dia_routing_table(op, n_side, device, dtype, precond, expect):
    m = n_side
    if op.startswith("dia7"):
        a = poisson3d_dia(m, m, m, dtype=np.float32, device="cpu")
        if op == "dia7_dirty":
            data = a.data.clone()
            data[4, m * m - 1] = -1.0      # offset +1 across an x-plane
            a = dataclasses.replace(a, data=data)
    elif op == "dia27":
        a = poisson3d_dia27(m, m, m, variable=True, seed=0, device="cpu")
    else:
        a = poisson2d_dia(m, m, dtype=np.float32, device="cpu")
        if op == "dia2d_grid":
            a = dataclasses.replace(a, grid=(m, 1, m))
    n = a.shape[0]
    b = (_cuda_like(n, dtype) if device == "cuda"
         else torch.zeros(n, dtype=dtype))
    pre = {"jacobi": cgx_torch.JacobiPrecond.from_matrix(a),
           "callable": (lambda r: r), None: None}[precond]
    assert cgx_torch.select_backend(a, b, pre) == expect


def test_slice_end_to_end_matches_cgx():
    """auto_solve on a DIA with JacobiPrecond, the coefficient data and the
    preconditioner carried across from cgx: the "xla" route against
    cgx.auto_solve in fp64 (equal iterations, 1e-10), and the K2 route
    (its plain version, fp32) against cgx's resident kernel in interpret
    mode (±2 iterations, rtol 5e-3 / atol 5e-4)."""
    import importlib
    from cgx.sparse.types import DIAMatrix as JDIA
    jres = importlib.import_module("cgx.kernels.fused_resident")

    data, offs, shape = scaled_dia_data(6, 8, 7, seed=37)
    aj = JDIA(data=jnp.asarray(data), offsets=offs, shape=shape)
    mj = cgx.JacobiPrecond.from_matrix(aj)
    a_t = operator_from_cgx(aj, device="cpu")
    m_t = precond_from_cgx(mj, device="cpu")
    b = seeded(shape[0], seed=38)
    res_j = cgx.auto_solve(aj, jnp.asarray(b), tol=1e-8, preconditioner=mj)
    res_t = cgx_torch.auto_solve(a_t, t(b), tol=1e-8, preconditioner=m_t)
    assert int(res_t.iterations) == int(res_j.iterations)
    np.testing.assert_allclose(n_(res_t.x), np.asarray(res_j.x), rtol=1e-10,
                               atol=1e-10 * float(np.abs(res_j.x).max()))
    a32, b32 = a_t.astype(torch.float32), t(b.astype(np.float32))
    ref = jres.resident_dia_cg(aj.astype(jnp.float32),
                               jnp.asarray(b.astype(np.float32)), tol=1e-6,
                               maxiter=800, interpret=True)
    res = cgx_torch.auto_solve(a32, b32, tol=1e-6, maxiter=800,
                               preconditioner=cgx_torch.JacobiPrecond(
                                   m_t.inv_diag.float()),
                               backend="resident_dia")
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)


def test_unported_options_raise():
    a = cgx_torch.poisson3d_stencil(4, 4, 4)
    # A 2-D b is ported (cg_solve_multi), and so are its bf16 planes.
    assert bool(cgx_torch.auto_solve(a, torch.ones(64, 2)).converged.all())
    from cgx_torch.kernels.fused_multi import fused_dia_cg_multi
    res = fused_dia_cg_multi(poisson3d_dia(4, 4, 4, dtype=np.float32,
                                           device="cpu"), torch.ones(64, 2),
                             plane_dtype=torch.bfloat16)
    assert bool(res.converged.all())
    # mixed_precision is ported: the 64-row stencil is below
    # FUSED_MIN_ROWS and on the CPU, so it routes normally and is solved,
    # as tests/test_ir.py:89-95 checks in the reference.
    res = cgx_torch.auto_solve(a, torch.ones(64), tol=1e-6,
                               mixed_precision=True)
    assert bool(res.converged)
    with pytest.raises(ValueError):
        cgx_torch.auto_solve(a, torch.ones(64), backend="nope")
    # The whole-solve route keeps no history: small n falls back to the loop.
    res = cgx_torch.auto_solve(a, torch.ones(64, dtype=torch.float64),
                               backend="resident_stencil", track_history=True)
    assert res.history.shape == (65,)


def test_resident_route_on_cpu_tensor_matches_loop():
    a = cgx_torch.poisson3d_stencil(9, 8, 7)
    b = t(seeded(a.shape[0], seed=33, dtype=np.float32))
    res_r = cgx_torch.auto_solve(a, b, tol=1e-6, backend="resident_stencil")
    res_x = cgx_torch.auto_solve(a, b, tol=1e-6, backend="xla")
    assert abs(int(res_r.iterations) - int(res_x.iterations)) <= 1
    np.testing.assert_allclose(n_(res_r.x), n_(res_x.x), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("kind", ["stencil2d", "stencil3d", "27point"])
def test_operator_from_cgx_round_trip(kind):
    a_j = {"stencil2d": lambda: jst.Stencil2D(nx=5, ny=6, c_center=4.0,
                                              c_x=-1.5, c_y=-0.5,
                                              dtype_name="float64"),
           "stencil3d": lambda: jst.poisson3d_stencil(3, 4, 5),
           "27point": lambda: jst.poisson3d_27point(3, 4, 5)}[kind]()
    a_t = operator_from_cgx(a_j)
    assert type(a_t).__name__ == type(a_j).__name__
    for f in ("nx", "ny", "shape", "dtype_name"):
        assert getattr(a_t, f) == getattr(a_j, f)
    assert operator_from_cgx(a_t) == a_t
    x = seeded(a_j.shape[0], seed=34)
    y = tensor_from_numpy(x)
    assert y.dtype == torch.float64 and np.array_equal(n_(y), x)
    res = result_to_numpy(cgx_torch.cg_solve(a_t, t(x), tol=1e-8))
    assert res["converged"] and res["x"].shape == x.shape
    with pytest.raises(TypeError):
        operator_from_cgx(object())


@pytest.mark.parametrize("kind", ["dia_grid", "dia", "csr"])
def test_stored_operators_and_precond_round_trip(kind):
    """DIA (with and without grid) and CSR cross from cgx with their data,
    cross back unchanged, and solve the same system in both packages."""
    from cgx.io.poisson import poisson2d, poisson3d_dia
    if kind == "csr":
        aj = poisson2d(7, 6)
    else:
        aj = poisson3d_dia(4, 5, 6)
        if kind == "dia":
            aj = dataclasses.replace(aj, grid=None)
    a_t = operator_from_cgx(aj, device="cpu")
    assert type(a_t).__name__ == type(aj).__name__
    assert a_t.shape == aj.shape
    back = operator_from_cgx(a_t, device="cpu")
    if kind == "csr":
        for f in ("values", "col_indices", "indptr", "row_indices"):
            np.testing.assert_array_equal(n_(getattr(a_t, f)),
                                          np.asarray(getattr(aj, f)))
            assert torch.equal(getattr(back, f), getattr(a_t, f))
    else:
        assert a_t.offsets == aj.offsets and a_t.grid == aj.grid
        np.testing.assert_array_equal(n_(a_t.data), np.asarray(aj.data))
        assert back.grid == a_t.grid and torch.equal(back.data, a_t.data)
    mj = cgx.JacobiPrecond.from_matrix(aj)
    m_t = precond_from_cgx(mj, device="cpu")
    np.testing.assert_array_equal(n_(m_t.inv_diag), np.asarray(mj.inv_diag))
    b = seeded(aj.shape[0], seed=39)
    res_j = cgx.cg_solve(aj, jnp.asarray(b), tol=1e-10, preconditioner=mj)
    res_t = cgx_torch.cg_solve(a_t, t(b), tol=1e-10, preconditioner=m_t)
    # fp64: equal iterations, x to 1e-10.
    assert int(res_t.iterations) == int(res_j.iterations)
    np.testing.assert_allclose(n_(res_t.x), np.asarray(res_j.x), rtol=1e-10,
                               atol=1e-12)
    with pytest.raises(TypeError):
        precond_from_cgx(object())


def test_port_imports_no_jax():
    code = ("import cgx_torch, cgx_torch.interop, cgx_torch.kernels._build, "
            "cgx_torch.kernels.fused_resident, cgx_torch.kernels.fused_cg, "
            "cgx_torch.kernels.fused_engine, cgx_torch.kernels.fused_dia_cg, "
            "cgx_torch.sparse.types, cgx_torch.solve.precond, "
            "cgx_torch.io.poisson, cgx_torch.sparse.wbell, "
            "cgx_torch.kernels.wbell, cgx_torch.solve.wbell, "
            "cgx_torch.io.suitesparse, cgx_torch.io.matrix_market, "
            "cgx_torch.kernels.fused_multi, cgx_torch.solve.block, "
            "cgx_torch.kernels, cgx_torch.kernels.bsr, cgx_torch.io.legacy, "
            "cgx_torch.ops.spmv, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'cgx' not in sys.modules, 'cgx imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr



def test_chip_smoke_imports_no_jax_and_needs_a_card():
    """chip_smoke.py names neither JAX nor the JAX package in any import,
    and without a card it exits nonzero with no result line."""
    import ast
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    assert not [m for m in names if m.split(".")[0] in ("jax", "cgx")]
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, path], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout

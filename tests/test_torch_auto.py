"""The slice as a whole: cgx_torch.auto_solve against cgx.auto_solve, the
routing table, operator interop, and the port's independence of JAX."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

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
    operator_from_cgx, result_to_numpy, tensor_from_numpy)
from cgx_torch.solve.auto import RESIDENT_MIN_ROWS  # noqa: E402
from torch_parity import n_, seeded, t  # noqa: E402

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


@pytest.mark.parametrize("backend", ["sr_stencil", "sr_dia", "fused_stencil",
                                     "fused_dia", "resident_dia", "wbell"])
def test_unported_backends_raise(backend):
    a = cgx_torch.poisson3d_stencil(4, 4, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgx_torch.auto_solve(a, torch.ones(64), backend=backend)


def test_unported_options_raise():
    a = cgx_torch.poisson3d_stencil(4, 4, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgx_torch.auto_solve(a, torch.ones(64, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cgx_torch.auto_solve(a, torch.ones(64), mixed_precision=True)
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


def test_port_imports_no_jax():
    code = ("import cgx_torch, cgx_torch.interop, cgx_torch.kernels._build, "
            "cgx_torch.kernels.fused_resident, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'cgx' not in sys.modules, 'cgx imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


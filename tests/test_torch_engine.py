"""K3's plain version — the port's two-pass engine (FusedCG) and its
fused_stencil_cg / fused_dia_cg wrappers — against cgx's Pallas engine in
interpret mode, on the CPU and in fp32, with x0 and history."""
import importlib

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx.sparse.stencil as jst  # noqa: E402
from cgx.io import poisson as jpo  # noqa: E402
from cgx.sparse import types as jty  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.kernels import fused_dia_cg as tfd  # noqa: E402
from cgx_torch.kernels import fused_engine as k3  # noqa: E402
from cgx_torch.kernels.fused_cg import (  # noqa: E402
    build_fused, fused_stencil_cg)
from torch_parity import n_, scaled_dia_data, seeded, t  # noqa: E402

jfc = importlib.import_module("cgx.kernels.fused_cg")
jfd = importlib.import_module("cgx.kernels.fused_dia_cg")


def _close(res, ref, history=False):
    """cgx's own kernel-test bounds (tests/test_kernels.py:191-193,
    :219-220): ±2 iterations, x to rtol 5e-3 / atol 5e-4, the history
    over the common iterations to rtol 2e-2."""
    assert bool(res.converged) and bool(ref.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)
    if history:
        assert res.history.shape == tuple(ref.history.shape)
        k = min(int(res.iterations), int(ref.iterations))
        np.testing.assert_allclose(n_(res.history)[:k + 1],
                                   np.asarray(ref.history)[:k + 1],
                                   rtol=2e-2)


@pytest.mark.parametrize("case", ["p3d", "p3d_warm", "2d", "27point"])
def test_fused_stencil_cg_matches_cgx(case):
    s = {"p3d": lambda: jst.poisson3d_stencil(6, 8, 7),
         "p3d_warm": lambda: jst.poisson3d_stencil(6, 8, 7),
         "2d": lambda: jst.poisson2d_stencil(17, 13),
         "27point": lambda: jst.poisson3d_27point(6, 7, 5)}[case]()
    n = s.shape[0]
    b = seeded(n, seed=61, dtype=np.float32)
    x0 = ((0.1 * seeded(n, seed=62)).astype(np.float32)
          if case.endswith("warm") else None)
    ref = jfc.fused_stencil_cg(s, jnp.asarray(b),
                               None if x0 is None else jnp.asarray(x0),
                               tol=1e-5, maxiter=500, track_history=True,
                               interpret=True)
    before = (k3.fused_a_launches, k3.fused_b_launches)
    res = fused_stencil_cg(operator_from_cgx(s), t(b),
                           None if x0 is None else t(x0), tol=1e-5,
                           maxiter=500, track_history=True)
    # A CPU tensor takes the plain version, never a kernel.
    assert (k3.fused_a_launches, k3.fused_b_launches) == before
    _close(res, ref, history=True)


def _dia(kind):
    if kind == "scaled7":
        data, offs, shape = scaled_dia_data(6, 8, 7, seed=2)
        grid = None
    elif kind == "p2d_grid":
        a = jpo.poisson2d_dia(12, 9)
        data, offs, shape, grid = (np.asarray(a.data), a.offsets, a.shape,
                                   (12, 1, 9))
    else:
        a = jpo.poisson3d_dia27(5, 6, 7, variable=True, seed=4)
        data, offs, shape, grid = (np.asarray(a.data), a.offsets, a.shape,
                                   a.grid)
    aj = jty.DIAMatrix(data=jnp.asarray(data.astype(np.float32)),
                       offsets=offs, shape=shape, grid=grid)
    return aj, operator_from_cgx(aj, device="cpu")


@pytest.mark.parametrize("case", ["jacobi", "plain", "warm", "p2d_grid",
                                  "p27var"])
def test_fused_dia_cg_matches_cgx(case):
    aj, at = _dia({"p2d_grid": "p2d_grid",
                   "p27var": "p27var"}.get(case, "scaled7"))
    n = aj.shape[0]
    b = seeded(n, seed=63, dtype=np.float32)
    x0 = ((0.1 * seeded(n, seed=64)).astype(np.float32)
          if case == "warm" else None)
    kw = dict(tol=1e-5, maxiter=800, jacobi=case != "plain",
              track_history=True)
    ref = jfd.fused_dia_cg(aj, jnp.asarray(b),
                           None if x0 is None else jnp.asarray(x0),
                           interpret=True, **kw)
    res = tfd.fused_dia_cg(at, t(b), None if x0 is None else t(x0), **kw)
    _close(res, ref, history=True)


def test_chunked_run_equals_solve():
    """init / run to k = 5 / run to the end / result is the solve."""
    aj, at = _dia("scaled7")
    eng, e, _ = tfd.build_fused_dia(at, torch.float32)
    b = e * t(seeded(at.shape[0], seed=65, dtype=np.float32))
    full = eng.solve(b, tol=1e-6, maxiter=400, track_history=True)
    tol_sq = k3.threshold(b, 1e-6, 0.0, eng.weight)
    st = eng.init(b, history_len=401)
    st = eng.run(st, 5, tol_sq)
    assert int(st.k) == 5
    st = eng.run(st, 400, tol_sq)
    res = eng.result(st, tol_sq, 400)
    assert int(res.iterations) == int(full.iterations)
    assert torch.equal(res.x, full.x) and torch.equal(res.history,
                                                      full.history)


def test_engine_operator_is_the_scaled_matrix():
    """Ã·v of the engine (symmetric mode and all planes) equals
    E·A·E·v through the generic DIA SpMV, fp32 to 1e-6 relative."""
    _, at = _dia("p27var")
    v = t(seeded(at.shape[0], seed=66, dtype=np.float32))
    sym, e, _ = tfd.build_fused_dia(at, torch.float32)
    full, _, _ = tfd.build_fused_dia(at, torch.float32,
                                     assume_symmetric=False)
    assert sym.sym and not full.sym and sym.planes.shape[0] == 13
    ref = e * cgx_torch.spmv(at, e * v)
    for eng in (sym, full):
        y = eng.matvec(v)
        np.testing.assert_allclose(n_(y), n_(ref), rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))
    q, pq, qq = sym.kernel_a(v)       # CPU: the plain kernel A
    assert torch.equal(q, sym.matvec(v))
    assert float(pq) == pytest.approx(float(torch.dot(q, v)), rel=1e-5)
    assert float(qq) == pytest.approx(float(torch.dot(q, q)), rel=1e-5)


def test_warm_start_at_solution_and_fixed_count():
    s = jst.poisson3d_stencil(4, 8, 6)
    b = seeded(192, seed=67, dtype=np.float32)
    ref = jfc.fused_stencil_cg(s, jnp.asarray(b), tol=0.0, maxiter=25,
                               interpret=True)
    res = fused_stencil_cg(operator_from_cgx(s), t(b), tol=0.0, maxiter=25)
    assert int(res.iterations) == 25
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=1e-3,
                               atol=1e-4)
    again = fused_stencil_cg(operator_from_cgx(s), t(b), res.x, tol=1e-4,
                             maxiter=500)
    assert int(again.iterations) == 0


def test_unported_engine_options_raise():
    # The one-pass engine (K6) is ported: build_fused(one_pass=True) gives
    # it, and its plain solve matches cgx's one-pass engine in interpret
    # mode within cgx's kernel-test bounds.
    sj = jst.poisson3d_stencil(6, 8, 7)
    eng = build_fused(operator_from_cgx(sj), torch.float32, one_pass=True)
    assert type(eng).__name__ == "OnePassCG"
    b = seeded(sj.shape[0], seed=68, dtype=np.float32)
    ref = jfc.fused_stencil_cg(sj, jnp.asarray(b), tol=1e-5, maxiter=500,
                               track_history=True, interpret=True,
                               one_pass=True)
    _close(eng.solve(t(b), tol=1e-5, maxiter=500, track_history=True), ref,
           history=True)
    # bf16 planes are ported: the solve converges, in bf16 planes and fp32
    # vectors, to the rounded operator's solution.
    _, at = _dia("scaled7")
    res = tfd.fused_dia_cg(at, torch.ones(at.shape[0]), tol=1e-6,
                           maxiter=500, plane_dtype=torch.bfloat16)
    assert bool(res.converged) and res.x.dtype == torch.float32
    eng, _, _ = tfd.build_fused_dia(at, torch.float32,
                                    plane_dtype=torch.bfloat16)
    assert eng.planes.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="planes"):
        k3.FusedCG(4, 4, 4, ((0, 0, 0),), coeffs=(None,))

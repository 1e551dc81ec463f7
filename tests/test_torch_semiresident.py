"""K4's plain version — the port's semi-resident solve (sr_stencil_cg,
sr_dia_cg, sr_cg_call, the card's tier plan) — against cgx's Pallas kernel
in interpret mode, as tests/test_semiresident.py runs it, at that file's
sizes, on the CPU and in fp32.

cgx sums in fp32, the port exactly (fp64, rounded once), so the two are
held to cgx's own kernel-test bounds (tests/test_kernels.py:191-193):
±2 iterations and x to rtol 5e-3 / atol 5e-4.  Inside the port every tier
equals the two-pass engine's plain solve (K3) bit for bit.
"""
import importlib

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
import cgx.sparse.stencil as jst  # noqa: E402
from cgx.sparse import types as jty  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.kernels import fused_dia_cg as tfd  # noqa: E402
from cgx_torch.kernels import fused_semiresident as k4  # noqa: E402
from cgx_torch.kernels.fused_cg import (  # noqa: E402
    fused_stencil_cg, stencil_taps)
from torch_parity import n_, scaled_dia_data, seeded, t  # noqa: E402

jsr = importlib.import_module("cgx.kernels.fused_semiresident")

TAPS7 = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
         (1, 0, 0), (-1, 0, 0))


def _close(res, ref):
    assert bool(res.converged) and bool(ref.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)


def _same(res, ref):
    assert int(res.iterations) == int(ref.iterations)
    assert torch.equal(res.x, ref.x)
    assert torch.equal(res.residual_norm_sq, ref.residual_norm_sq)


def _stencil(case):
    taps27 = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dz in (-1, 0, 1))
    return {"p3d": lambda: jst.poisson3d_stencil(12, 10, 11),
            "2d": lambda: jst.poisson2d_stencil(33, 29),
            "27point": lambda: jst.GeneralStencil3D(
                nx=8, ny=9, nz=10, taps=taps27,
                coeffs=tuple(26.5 if tp == (0, 0, 0) else -1.0
                             for tp in taps27))}[case]()


@pytest.mark.parametrize("case,mode", [("p3d", "rpq"), ("p3d", "rp"),
                                       ("p3d", "p"), ("2d", "rp"),
                                       ("27point", "rpq")])
def test_sr_stencil_matches_cgx_and_k3(case, mode):
    s = _stencil(case)
    b = seeded(s.shape[0], seed=71, dtype=np.float32)
    ref = jsr.sr_stencil_cg(s, jnp.asarray(b), tol=1e-6, maxiter=3000,
                            mode=mode, interpret=True)
    st = operator_from_cgx(s, device="cpu")
    res = k4.sr_stencil_cg(st, t(b), tol=1e-6, maxiter=3000, mode=mode)
    _close(res, ref)
    assert res.history.shape == (0,)
    # The tiers differ in what they store, not in the algebra: each equals
    # the two-pass engine's plain solve.
    _same(res, fused_stencil_cg(st, t(b), tol=1e-6, maxiter=3000))


def test_sr_x0_correction_solve():
    s = jst.poisson3d_stencil(10, 9, 8)
    n = s.shape[0]
    b = seeded(n, seed=72, dtype=np.float32)
    x0 = (0.1 * seeded(n, seed=73)).astype(np.float32)
    ref = jsr.sr_stencil_cg(s, jnp.asarray(b), jnp.asarray(x0), tol=1e-6,
                            maxiter=1000, mode="rp", interpret=True)
    res = k4.sr_stencil_cg(operator_from_cgx(s, device="cpu"), t(b), t(x0),
                           tol=1e-6, maxiter=1000, mode="rp")
    _close(res, ref)
    st = operator_from_cgx(s, device="cpu")
    true = cgx_torch.cg_solve(st, t(b), t(x0), tol=1e-6, maxiter=1000)
    assert abs(int(res.iterations) - int(true.iterations)) <= 2


def _dia(seed, dims=(10, 9, 11)):
    data, offs, shape = scaled_dia_data(*dims, seed=seed)
    aj = jty.DIAMatrix(data=jnp.asarray(data.astype(np.float32)),
                       offsets=offs, shape=shape)
    return aj, operator_from_cgx(aj, device="cpu")


@pytest.mark.parametrize("jacobi", [True, False])
def test_sr_dia_matches_cgx_and_k3(jacobi):
    aj, at = _dia(seed=74)
    assert jsr.sr_dia_supported(aj) and k4.sr_dia_supported(at)
    b = seeded(aj.shape[0], seed=75, dtype=np.float32)
    ref = jsr.sr_dia_cg(aj, jnp.asarray(b), tol=1e-6, maxiter=1000,
                        jacobi=jacobi, interpret=True)
    before = k4.sr_cg_planes_launches
    res = k4.sr_dia_cg(at, t(b), tol=1e-6, maxiter=1000, jacobi=jacobi)
    assert k4.sr_cg_planes_launches == before          # CPU: no kernel
    _close(res, ref)
    k3 = tfd.fused_dia_cg(at, t(b), tol=1e-6, maxiter=1000, jacobi=jacobi)
    assert int(res.iterations) == int(k3.iterations)
    assert torch.equal(res.x, k3.x)


@pytest.mark.parametrize("mode", ["rp", "p"])
def test_sr_dia_rp_p_tiers_match_rpq(mode):
    aj, at = _dia(seed=76, dims=(8, 6, 7))
    b = seeded(aj.shape[0], seed=77, dtype=np.float32)
    ref = jsr.sr_dia_cg(aj, jnp.asarray(b), tol=1e-6, maxiter=500,
                        interpret=True, mode=mode)
    res = k4.sr_dia_cg(at, t(b), tol=1e-6, maxiter=500, mode=mode)
    _close(res, ref)
    _same(res, k4.sr_dia_cg(at, t(b), tol=1e-6, maxiter=500, mode="rpq"))


def test_sr_dia_x0_and_wide_band():
    """The initial-guess path (r₀ = b − A·x₀) and the 27-point variable
    DIA with grid metadata (13 symmetric planes)."""
    aj, at = _dia(seed=78, dims=(7, 9, 8))
    n = aj.shape[0]
    b = seeded(n, seed=79, dtype=np.float32)
    x0 = (0.1 * seeded(n, seed=80)).astype(np.float32)
    ref = jsr.sr_dia_cg(aj, jnp.asarray(b), jnp.asarray(x0), tol=1e-6,
                        maxiter=1000, interpret=True)
    _close(k4.sr_dia_cg(at, t(b), t(x0), tol=1e-6, maxiter=1000), ref)
    from cgx_torch.io.poisson import poisson3d_dia27
    d27 = poisson3d_dia27(5, 6, 7, variable=True, seed=4, device="cpu")
    b27 = t(seeded(d27.shape[0], seed=81, dtype=np.float32))
    m = cgx_torch.JacobiPrecond.from_matrix(d27)
    res = k4.sr_dia_cg(d27, b27, tol=1e-6, maxiter=500, inv_diag=m.inv_diag)
    cg = cgx_torch.cg_solve(d27, b27, tol=1e-6, maxiter=500,
                            preconditioner=m)
    assert abs(int(res.iterations) - int(cg.iterations)) <= 2
    np.testing.assert_allclose(n_(res.x), n_(cg.x), rtol=5e-3, atol=5e-4)


def test_sr_dia_bf16_planes_equal_prerounded():
    """bf16 planes are widened as they are loaded: the bf16 mode equals
    the fp32 solve on the planes rounded through bf16, bit for bit."""
    _, at = _dia(seed=82, dims=(9, 8, 7))
    b = t(seeded(at.shape[0], seed=83, dtype=np.float32))
    nx, ny, nz, taps, coeffs, planes, e, w, sym = tfd.dia_prep(
        at, torch.float32)
    g = k4.make_sr_geometry(nx, ny, nz, taps, n_planes=planes.shape[0],
                            weighted=True, sym=sym, plane_isz=2)
    assert g.mode == "rpq"
    kw = dict(coeffs=coeffs, w=w, tol=1e-6, maxiter=500,
              b_norm_sq=torch.sum(b * b))
    narrow = k4.sr_cg(g, e * b, planes=planes, plane_dtype=torch.bfloat16,
                      **kw)
    _same(narrow, k4.sr_cg(g, e * b, planes=planes.to(torch.bfloat16)
                           .float(), **kw))
    assert bool(narrow.converged)


@pytest.mark.parametrize("mode", ["rpq", "p"])
def test_sr_chained_resume_equals_one_call(mode):
    s = cgx_torch.poisson3d_stencil(9, 10, 11)
    nx, ny, nz, taps, coeffs = stencil_taps(s)
    g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode)
    b = t(seeded(s.shape[0], seed=84, dtype=np.float32))
    full = k4.sr_cg_call(g, b, coeffs=coeffs, tol=1e-6, maxiter=1000)
    x, r, p, k, rz, _ = k4.sr_cg_call(g, b, coeffs=coeffs, tol=1e-6,
                                      maxiter=9)
    rest = k4.sr_cg_call(g, b, coeffs=coeffs, tol=1e-6, maxiter=991,
                         resume=(x, r, p, rz[0], rz[1]))
    assert int(k) == 9 and int(k) + int(rest[3]) == int(full[3])
    for got, want in zip(rest[:3] + rest[4:5], full[:3] + full[4:5]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["sr_stencil", "sr_dia"])
def test_auto_solve_sr_backends_match_cgx(backend):
    if backend == "sr_stencil":
        aj, mj, mt = jst.poisson3d_stencil(10, 11, 9), None, None
        at = operator_from_cgx(aj, device="cpu")
    else:
        aj, at = _dia(seed=85, dims=(9, 10, 8))
        mj = cgx.JacobiPrecond.from_matrix(aj)
        mt = cgx_torch.JacobiPrecond.from_matrix(at)
    b = seeded(aj.shape[0], seed=86, dtype=np.float32)
    kw = dict(tol=1e-6, maxiter=1500, backend=backend)
    ref = cgx.auto_solve(aj, jnp.asarray(b), preconditioner=mj, **kw)
    res = cgx_torch.auto_solve(at, t(b), preconditioner=mt, **kw)
    _close(res, ref)
    hist = cgx_torch.auto_solve(at, t(b), preconditioner=mt,
                                track_history=True, **kw)
    assert hist.history.shape == (1501,)
    with pytest.raises(ValueError, match="preconditioner"):
        cgx_torch.auto_solve(at, t(b), backend=backend,
                             preconditioner=cgx_torch.PolynomialPrecond(
                                 lambda v: v, torch.ones(1)))


def test_sr_tier_plan_is_the_cards():
    """The plan asks whether the tier's resident vectors (3, 2 or 1 fp32
    vectors, plus a window of each streamed plane) fit the H100's 50 MiB
    L2."""
    assert k4.SR_L2_BUDGET == 50 << 20
    assert k4.sr_mode(128, 128, 128, TAPS7) == "rpq"
    assert k4.sr_mode(160, 160, 160, TAPS7) == "rpq"     # 49.2 MB
    assert k4.sr_mode(180, 180, 180, TAPS7) == "rp"      # 46.7 MB
    assert k4.sr_mode(216, 216, 216, TAPS7) == "p"       # 40.3 MB
    assert k4.sr_mode(224, 224, 224, TAPS7) == "p"
    assert k4.sr_mode(288, 288, 288, TAPS7) is None      # 95.6 MB
    # A forced tier is taken as it is; an unknown one is refused.
    assert k4.make_sr_geometry(288, 288, 288, TAPS7, mode="p").mode == "p"
    with pytest.raises(ValueError, match="unknown mode"):
        k4.make_sr_geometry(8, 8, 8, TAPS7, mode="pq")
    with pytest.raises(ValueError, match="too large"):
        k4.make_sr_geometry(288, 288, 288, TAPS7)
    # Streamed planes plan rpq only; a bf16 plane window is half as large.
    assert k4._plan(160, 160, 160, TAPS7, 4, None, n_planes=4) == "rpq"
    assert k4._plan(180, 180, 180, TAPS7, 4, None, n_planes=4) is None
    data, offs, shape = scaled_dia_data(6, 5, 4, seed=0)
    d = cgx_torch.DIAMatrix(data=t(data.astype(np.float32)), offsets=offs,
                            shape=shape)
    assert k4.sr_dia_supported(d)
    assert not k4.sr_dia_supported(cgx_torch.poisson3d_stencil(4, 4, 4))


def test_sr_refusals():
    s = cgx_torch.poisson3d_stencil(4, 4, 4)
    with pytest.raises(ValueError, match="unsupported operator"):
        k4.sr_stencil_cg(cgx_torch.DIAMatrix(
            data=torch.zeros(1, 8), offsets=(0,), shape=(8, 8)),
            torch.ones(8))
    with pytest.raises(ValueError, match="dx"):
        k4.make_sr_geometry(4, 4, 4, ((2, 0, 0),))
    g = k4.make_sr_geometry(4, 4, 4, TAPS7[:1], n_planes=1)
    with pytest.raises(ValueError, match="planes"):
        k4.sr_cg(g, torch.ones(64), coeffs=(None,))
    data = np.zeros((3, 64), np.float32)
    data[1] = 4.0
    data[0, 3] = -1.0          # +1 offset crossing a z-line boundary
    d = cgx_torch.DIAMatrix(data=t(data), offsets=(1, 0, -1), shape=(64, 64),
                            grid=(4, 4, 4))
    with pytest.raises(ValueError, match="x-plane-crossing"):
        k4.sr_dia_cg(d, torch.ones(64))
    assert s.shape == (64, 64)

"""K2's plain version and the port's resident_stencil_cg against cgx's
whole-solve Pallas kernel in interpret mode (CPU, fp32)."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx.sparse.stencil as jst  # noqa: E402
from cgx.kernels import fused_resident as jres  # noqa: E402
from cgx.kernels.fused_cg import stencil_taps as j_taps  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.kernels import fused_resident as k2  # noqa: E402
from cgx_torch.kernels.fused_cg import stencil_taps, supports  # noqa: E402
from torch_parity import n_, seeded, t  # noqa: E402

DIMS = (10, 8, 9)


@pytest.fixture(scope="module")
def case():
    a_j = jst.poisson3d_stencil(*DIMS)
    n = a_j.shape[0]
    b = seeded(n, seed=21, dtype=np.float32)
    x0 = (0.1 * seeded(n, seed=22)).astype(np.float32)
    nx, ny, nz, taps, coeffs = j_taps(a_j)
    g = jres.make_resident_geometry(nx, ny, nz, taps)
    ref = jres.resident_cg(g, jnp.asarray(b), coeffs=coeffs, tol=1e-6,
                           maxiter=500, interpret=True)
    ref_warm = jres.resident_cg(g, jnp.asarray(b), jnp.asarray(x0),
                                coeffs=coeffs, tol=1e-6, maxiter=500,
                                interpret=True)
    return dict(a_j=a_j, a_t=operator_from_cgx(a_j), b=b, x0=x0, g=g,
                coeffs=coeffs, ref=ref, ref_warm=ref_warm)


def _close(res_x, its, ref):
    assert abs(int(its) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(n_(res_x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_reference_matches_pallas_interpret(case, warm):
    spec = stencil_taps(case["a_t"])
    x0 = t(case["x0"]) if warm else None
    x, _, _, k, rz, tol_sq = k2.resident_cg_reference(
        spec, t(case["b"]), x0, tol=1e-6, maxiter=500)
    ref = case["ref_warm" if warm else "ref"]
    _close(x, k, ref)
    assert float(rz[1]) <= float(tol_sq)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_resident_stencil_cg_cpu_matches_pallas(case, warm):
    before = k2.resident_cg_launches
    x0 = t(case["x0"]) if warm else None
    res = k2.resident_stencil_cg(case["a_t"], t(case["b"]), x0, tol=1e-6,
                                 maxiter=500)
    # A CPU tensor takes the plain version, never the kernel.
    assert k2.resident_cg_launches == before
    assert bool(res.converged)
    assert res.iterations.dtype == torch.int32
    _close(res.x, res.iterations, case["ref_warm" if warm else "ref"])


def test_resume_mid_solve_reaches_same_x(case):
    spec = stencil_taps(case["a_t"])
    b = t(case["b"])
    full = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=500)
    part = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=11)
    x, r, p, k, rz, _ = part
    assert int(k) == 11
    rest = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=500,
                               resume=(x, r, p, rz[0], rz[1]))
    assert int(k) + int(rest[3]) == int(full[3])
    np.testing.assert_array_equal(n_(rest[0]), n_(full[0]))


def test_resume_from_cgx_state(case):
    """A mid-solve state of cgx's kernel (layout space, flattened) resumes
    in the port and lands on cgx's uninterrupted solution."""
    g, b = case["g"], case["b"]
    x_l, r_l, p_l, k, rz, _ = jres.resident_cg_call(
        g, jnp.asarray(b), coeffs=case["coeffs"], tol=1e-6, maxiter=9,
        interpret=True)
    flat = [t(np.asarray(jres._from_layout(g, v))) for v in (x_l, r_l, p_l)]
    rz = np.asarray(rz)
    res = k2.resident_cg_call(stencil_taps(case["a_t"]), t(b), tol=1e-6,
                              maxiter=500,
                              resume=(*flat, float(rz[0, 0]),
                                      float(rz[0, 1])))
    _close(res[0], int(k[0, 0]) + int(res[3]), case["ref"])


def test_supported_operators():
    assert k2.resident_supported(operator_from_cgx(jst.poisson3d_27point(
        4, 5, 6)))
    assert k2.resident_supported(operator_from_cgx(jst.poisson2d_stencil(
        9, 7)))
    assert not k2.resident_supported(operator_from_cgx(
        jst.poisson3d_stencil(4, 5, 6)), torch.float64)
    wide = operator_from_cgx(jst.GeneralStencil3D(
        nx=4, ny=4, nz=4, taps=((0, 0, 0), (2, 0, 0)), coeffs=(1.0, 0.1)))
    assert stencil_taps(wide) is None and not supports(wide)
    assert not k2.resident_supported(wide)
    with pytest.raises(ValueError):
        k2.resident_stencil_cg(wide, torch.ones(64))


@pytest.mark.parametrize("kind", ["2d_cold", "2d_warm", "27point"])
def test_reference_other_operators(kind):
    """The plain version on a 27-point and a 2-D stencil against cgx."""
    if kind == "27point":
        a_j = jst.poisson3d_27point(6, 7, 5)
    else:
        a_j = jst.poisson2d_stencil(13, 11)
    n = a_j.shape[0]
    b = seeded(n, seed=23, dtype=np.float32)
    x0 = (0.1 * seeded(n, seed=24)).astype(np.float32) \
        if kind == "2d_warm" else None
    nx, ny, nz, taps, coeffs = j_taps(a_j)
    g = jres.make_resident_geometry(nx, ny, nz, taps)
    ref = jres.resident_cg(g, jnp.asarray(b),
                           None if x0 is None else jnp.asarray(x0),
                           coeffs=coeffs, tol=1e-6, maxiter=500,
                           interpret=True)
    res = k2.resident_stencil_cg(operator_from_cgx(a_j), t(b),
                                 None if x0 is None else t(x0), tol=1e-6,
                                 maxiter=500)
    _close(res.x, res.iterations, ref)


"""Parity of the port's stencils, K1's plain version, blas and spmv/spmm
dispatch with the JAX package (CPU)."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
import cgx.sparse.stencil as jst  # noqa: E402
import cgx_torch  # noqa: E402
from cgx.kernels.stencil import stencil3d_spmv_pallas  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.kernels import stencil as k1  # noqa: E402
from torch_parity import n_, seeded, t  # noqa: E402

OPERATORS = {
    "stencil2d": lambda: jst.Stencil2D(nx=7, ny=9, c_center=4.5, c_x=-1.25,
                                       c_y=-0.75),
    "stencil3d": lambda: jst.Stencil3D(nx=6, ny=5, nz=7, c_center=6.5,
                                       c_x=-1.0, c_y=-1.5, c_z=-0.5),
    "27point": lambda: jst.poisson3d_27point(5, 6, 4),
    "general_wide": lambda: jst.GeneralStencil3D(
        nx=5, ny=6, nz=7, taps=((0, 0, 0), (0, 0, 2), (0, -2, 0),
                                (1, 1, -1), (-1, 0, 3)),
        coeffs=(5.0, -0.5, -0.25, -1.0, 0.125)),
}


@pytest.mark.parametrize("kind", sorted(OPERATORS))
def test_matvec_matches_cgx_fp64(kind):
    a_j = OPERATORS[kind]()
    a_t = operator_from_cgx(a_j)
    x = seeded(a_j.shape[0], seed=1)
    y_j = np.asarray(a_j.matvec(jnp.asarray(x)))
    y_t = n_(a_t.matvec(t(x)))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(n_(a_t.diagonal()),
                               np.asarray(a_j.diagonal()))
    assert a_t.shape == a_j.shape


@pytest.mark.parametrize("dims,br", [((5, 7, 6), 16), ((8, 8, 8), 32),
                                     ((11, 9, 13), 24), ((6, 6, 6), 8)])
def test_k1_reference_matches_pallas(dims, br):
    nx, ny, nz = dims
    x = seeded(nx * ny * nz, seed=2, dtype=np.float32)
    y_j = stencil3d_spmv_pallas(jnp.asarray(x), nx=nx, ny=ny, nz=nz,
                                block_rows=br, interpret=True)
    y_ref = k1.stencil3d_spmv_reference(t(x), nx, ny, nz)
    np.testing.assert_allclose(n_(y_ref), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    # The wrapper takes the plain version on a CPU tensor, not the kernel.
    before = k1.stencil3d_spmv_launches
    y_w = k1.stencil3d_spmv(t(x), nx=nx, ny=ny, nz=nz)
    assert torch.equal(y_w, y_ref)
    assert k1.stencil3d_spmv_launches == before


def test_spmv_spmm_dispatch():
    for kind in ("stencil2d", "stencil3d", "27point"):
        a_j = OPERATORS[kind]()
        a_t = operator_from_cgx(a_j)
        n = a_j.shape[0]
        x = seeded(n, seed=3)
        np.testing.assert_allclose(n_(cgx_torch.spmv(a_t, t(x))),
                                   np.asarray(cgx.spmv(a_j, jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
        xs = np.stack([seeded(n, seed=s) for s in (4, 5, 6)], axis=1)
        np.testing.assert_allclose(n_(cgx_torch.spmm(a_t, t(xs))),
                                   np.asarray(cgx.spmm(a_j, jnp.asarray(xs))),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError):
        cgx_torch.spmv(object(), torch.zeros(3))
    with pytest.raises(TypeError):
        cgx_torch.spmm(np.eye(3), torch.zeros(3, 2))


def test_blas_matches_cgx():
    from cgx.ops import blas as jb
    from cgx_torch.ops import blas as tb
    a, b = seeded(1000, seed=7), seeded(1000, seed=8)
    np.testing.assert_allclose(float(tb.dot(t(a), t(b))),
                               float(jb.dot(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-12)
    np.testing.assert_allclose(float(tb.norm(t(a))),
                               float(jb.norm(jnp.asarray(a))), rtol=1e-12)
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_allclose(
        float(tb.dot_compensated(t(a32), t(b32))),
        float(jb.dot_compensated(jnp.asarray(a32), jnp.asarray(b32))),
        rtol=1e-6)
    d = np.array([2.0, 0.0, -4.0])
    np.testing.assert_array_equal(n_(tb.safe_recip(t(d))),
                                  np.asarray(jb.safe_recip(jnp.asarray(d))))
    np.testing.assert_allclose(n_(tb.axpy(2.0, t(a), t(b))), 2.0 * a + b)
    with pytest.raises(ValueError):
        tb.dot(torch.zeros(3), torch.zeros(4))


"""The index plan of K5's redesigned kernel A, on the CPU.

K5 A (``multi_a2``, the 2.5-D march): :func:`march_plan`'s tiles cover
every row once, every tap's staged read is the divmod neighbour (the flat
one for a plane tap), and the plain walk in tile order
(:func:`march_reference`) gives the plain kernel A's q bit for bit and its
sums to 1e-6; on one small DIA-27 case it is held against cgx's multi
kernel A in interpret mode.  An operator whose taps reach too far for the
march's stage takes the first kernel A, and the fused multi-RHS route
still solves it.  No CUDA library is needed.
"""
import importlib

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx_torch  # noqa: E402
from cgx.io import poisson as jpo  # noqa: E402
from cgx.sparse import types as jty  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.io.poisson import poisson3d_dia27  # noqa: E402
from cgx_torch.kernels import fused_multi as k5  # noqa: E402
from cgx_torch.kernels.fused_cg import stencil_taps  # noqa: E402
from cgx_torch.kernels.fused_dia_cg import dia_prep  # noqa: E402
from torch_parity import scaled_dia_data, t, wide_reach_dia  # noqa: E402

jfm = importlib.import_module("cgx.kernels.fused_multi")


def _spec(op, dims):
    """``(nx, ny, nz, taps, coeffs, planes, weight, sym)`` of a case: the
    3-D and 2-D 7-point stencils, the 27-point stencil, the scaled DIA-7,
    and DIA-27 with symmetric (``dia27``) or all 27 (``dia27_full``)
    planes."""
    nx, ny, nz = dims
    if op in ("p3d", "2d", "27point"):
        a = {"p3d": lambda: cgx_torch.poisson3d_stencil(nx, ny, nz),
             "2d": lambda: cgx_torch.poisson2d_stencil(nx, nz),
             "27point": lambda: cgx_torch.poisson3d_27point(nx, ny, nz)}[op]()
        return stencil_taps(a) + (None, None, False)
    if op == "dia7":
        data, offs, shape = scaled_dia_data(nx, ny, nz, seed=5)
        d = cgx_torch.DIAMatrix(data=t(data.astype(np.float32)),
                                offsets=offs, shape=shape)
    else:
        d = poisson3d_dia27(nx, ny, nz, variable=True, seed=3, device="cpu")
    nx, ny, nz, taps, coeffs, planes, _, w, sym = dia_prep(
        d, torch.float32,
        assume_symmetric=False if op == "dia27_full" else None)
    return nx, ny, nz, taps, coeffs, planes, w, sym


def _multi(op, dims):
    nx, ny, nz, taps, coeffs, planes, w, sym = _spec(op, dims)
    return k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                           weight=w, sym=sym)


def _block(k, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (k, n)).astype(np.float32))


# -- K5 A: the march ------------------------------------------------------

@pytest.mark.parametrize("op,dims,tj,length", [
    ("p3d", (37, 41, 53), None, None), ("p3d", (37, 41, 53), 4, 5),
    ("27point", (9, 10, 11), 16, 3), ("p3d", (1, 9, 10), None, None),
    ("dia27", (3, 3, 5), 8, 16), ("2d", (13, 1, 17), None, 4)])
def test_march_tiles_cover_every_row_once(op, dims, tj, length):
    """Every row belongs to exactly one block's tile and chunk, the nodes
    of a tile past the grid's edge (a tile larger than the grid) are left
    idle, and the grid is tiles × chunks."""
    nx, ny, nz, taps = _spec(op, dims)[:4]
    plan = k5.march_plan(nx, ny, nz, taps, tj=tj, length=length)
    assert plan.tj // plan.rows * plan.tk == k5.TILE_THREADS
    assert plan.tj % plan.rows == 0 and plan.hk % 4 == 0
    seen = np.zeros(nx * ny * nz, dtype=np.int64)
    for b in range(plan.grid):
        i0, i1, j0, k0 = k5.march_block(plan, b, nx)
        assert 0 <= i0 < i1 <= nx and j0 < ny and k0 < nz
        i, j, k = np.meshgrid(np.arange(i0, i1), j0 + np.arange(plan.tj),
                              k0 + np.arange(plan.tk), indexing="ij")
        live = (j < ny) & (k < nz)
        np.add.at(seen, ((i * ny + j) * nz + k)[live], 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("op,dims", [
    ("p3d", (37, 41, 53)), ("27point", (7, 9, 6)), ("dia7", (6, 8, 7)),
    ("dia27", (7, 6, 8)), ("p3d", (1, 9, 10)), ("27point", (3, 2, 5))])
def test_march_halo_reads_the_divmod_neighbours(op, dims):
    """For every row of every block and every tap, the staged element the
    kernel reads — plane i + dx, line j − j0 + hj + dy, element k − k0 + hk
    + dk — holds the flat index row + off, which for a tap inside the grid
    is the divmod neighbour; the mirror reads likewise; and every staged
    element read lies in [0, n)."""
    nx, ny, nz, taps, coeffs, _, _, sym = _spec(op, dims)
    n = nx * ny * nz
    plan = k5.march_plan(nx, ny, nz, taps)
    lines, width = plan.tj + 2 * plan.hj, plan.tk + 2 * plan.hk
    for b in range(plan.grid):
        i0, i1, j0, k0 = k5.march_block(plan, b, nx)
        i, jx, kx = np.meshgrid(np.arange(i0, i1), np.arange(plan.tj),
                                np.arange(plan.tk), indexing="ij")
        j, k = j0 + jx, k0 + kx
        live = (j < ny) & (k < nz)
        row = (i * ny + j) * nz + k
        for (dx, dy, dk), c in zip(taps, coeffs):
            for sgn in ((1, -1) if c is None and sym else (1,)):
                ex, ey, ez = sgn * dx, sgn * dy, sgn * dk
                line, elem = jx + plan.hj + ey, kx + plan.hk + ez
                assert ((line >= 0) & (line < lines)).all()
                assert ((elem >= 0) & (elem < width)).all()
                flat = k5.march_flat(plan, ny, nz, i + ex, j0, k0, line, elem)
                off = (ex * ny + ey) * nz + ez
                assert (flat == row + off)[live].all()
                inside = ((i + ex >= 0) & (i + ex < nx) & (j + ey >= 0)
                          & (j + ey < ny) & (k + ez >= 0) & (k + ez < nz))
                nb = ((i + ex) * ny + j + ey) * nz + k + ez
                assert (flat == nb)[live & inside].all()
                read = live & (inside if c is not None else
                               (row + off >= 0) & (row + off < n))
                assert ((flat >= 0) & (flat < n))[read].all()


@pytest.mark.parametrize("op,dims,k,tj,length", [
    ("p3d", (9, 10, 11), 3, None, None), ("p3d", (37, 41, 53), 1, 4, 7),
    ("2d", (13, 1, 17), 5, None, None), ("27point", (7, 9, 6), 4, 16, 2),
    ("dia7", (6, 8, 7), 4, None, 3), ("dia27", (7, 6, 8), 3, None, None),
    ("dia27_full", (5, 6, 7), 2, 2, 2), ("dia27", (1, 9, 10), 4, None, None)])
def test_march_walk_equals_plain_kernel_a(op, dims, k, tj, length):
    """The march in tile order gives the plain kernel A's q bit for bit
    (every row's taps, masks, products and sums in tap order) and its
    exact sums to 1e-6 (fp64 sums in the march's order)."""
    eng = _multi(op, dims)
    p = _block(k, eng.n, seed=11 + k)
    if k > 1:
        p[-1] = 0.0
    plan = k5.march_plan(eng.nx, eng.ny, eng.nz, eng.taps, tj=tj,
                         length=length)
    q, pq, qq = k5.march_reference(eng, p, plan)
    q_ref, pq_ref, qq_ref = eng.kernel_a_reference(p)
    assert torch.equal(q, q_ref)
    for g, r in ((pq, pq_ref), (qq, qq_ref)):
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())


def test_march_walk_against_cgx_multi_kernel_a():
    """DIA-27 (plain CG, symmetric planes): cgx's multi kernel A, in
    interpret mode, forms r₀ = b − A·x₀ from x₀ = P at b = 0, so its
    residual Σ q_j² per column is its kernel A's q; the march's q gives
    the same sums (cgx sums in fp32: 1e-5)."""
    a = jpo.poisson3d_dia27(6, 7, 5, variable=True, seed=2)
    aj = jty.DIAMatrix(data=jnp.asarray(np.asarray(a.data, np.float32)),
                       offsets=a.offsets, shape=a.shape, grid=a.grid)
    n, k = aj.shape[0], 3
    p = _block(k, n, seed=21)
    ref = jfm.fused_dia_cg_multi(aj, jnp.zeros((n, k), jnp.float32),
                                 jnp.asarray(p.numpy().T), maxiter=0,
                                 jacobi=False, interpret=True)
    at = operator_from_cgx(aj, device="cpu")
    nx, ny, nz, taps, coeffs, planes, _, w, sym = dia_prep(
        at, torch.float32, jacobi=False)
    assert sym
    eng = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                          weight=w, sym=sym)
    q, _, qq = k5.march_reference(eng, p, k5.march_plan(nx, ny, nz, taps))
    got = (q.double() ** 2).sum(dim=1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.residual_norm_sq),
                               rtol=1e-5)
    np.testing.assert_allclose(qq.numpy(), np.asarray(ref.residual_norm_sq),
                               rtol=1e-5)


def test_march_plan_refuses_what_the_kernel_cannot_stage():
    """A tile height that its rows a thread do not divide, or taps reaching
    further than a block's shared memory holds, raise.  At DIA-27 160³ the
    default tile is 16 lines of 32 nodes, two a thread, and on a card of
    528 blocks at once the chunks fill one wave."""
    with pytest.raises(ValueError):
        k5.march_plan(8, 8, 8, ((0, 0, 0),), tj=3)
    with pytest.raises(ValueError):
        k5.march_plan(8, 200, 8, ((0, 0, 0), (0, 90, 0), (0, -90, 0)))
    plan = k5.march_plan(160, 160, 160, ((0, 0, 0), (1, 1, 1)))
    assert (plan.tj, plan.tk, plan.rows, plan.hj, plan.hk) == (16, 32, 2, 1,
                                                                4)
    assert plan.grid == 10 * 5 * 10 and plan.smem_bytes == 4 * 4 * 18 * 40 * 4
    full = k5.march_plan(160, 160, 160, ((0, 0, 0), (1, 1, 1)), blocks=528)
    assert full.length == 16 and full.grid == 500
    s224 = k5.march_plan(224, 224, 224, ((0, 0, 0), (1, 0, 0)), blocks=528)
    assert (s224.length, s224.grid) == (45, 14 * 7 * 5)


# -- K5 A by the operator's reach -----------------------------------------

@pytest.mark.parametrize("case,march", [
    ("p3d", True), ("dia27", True), (2, True), (37, True), (38, False),
    (47, False)])
def test_march_or_first_kernel_a_by_reach(case, march):
    """Kernel A's design follows the operator's shape: the march wherever
    its stage holds the taps' halo (the stencils, DIA-27, a DIA operator
    reaching up to 37 lines in y at the default 16 × 32 tile), else the
    first kernel A (38 lines and more: the ring would pass the block's
    shared memory), whose plan is then not built."""
    if isinstance(case, int):
        d = wide_reach_dia(4, 96, 16, case)
        nx, ny, nz, taps, coeffs, planes, _, w, sym = dia_prep(
            d, torch.float32)
        eng = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs,
                              planes=planes, weight=w, sym=sym)
        assert max(abs(dy) for _, dy, _ in taps) == case
    else:
        eng = _multi(case, (9, 10, 11))
    if march:
        assert eng.march is not None and eng.a_design() == k5._MARCH
        assert eng.march.smem_bytes <= k5.SMEM_LIMIT
    else:
        assert eng.march is None and eng.a_design() == k5._FIRST_DESIGN


@pytest.mark.parametrize("k", [1, 3])
def test_wide_reach_multi_solve_on_the_fused_route(k):
    """A Jacobi-PCG multi-RHS solve of an operator reaching 40 lines in y
    goes through the fused route (K5, the first kernel A on the card) and
    converges to the batched loop's answer."""
    from cgx_torch.solve import block

    a = wide_reach_dia(4, 96, 16, 40)
    m = cgx_torch.JacobiPrecond.from_matrix(a)
    b = _block(k, a.shape[0], seed=41).T.contiguous()
    assert block._multi_route(a, b, m, "fused")[0] == "fused"
    got = block.cg_solve_multi(a, b, preconditioner=m, backend="fused",
                               tol=1e-6, maxiter=2000)
    ref = block.cg_solve_multi(a, b, preconditioner=m, backend="xla",
                               tol=1e-6, maxiter=2000)
    assert bool(got.converged.all())
    scale = float(ref.x.abs().max())
    assert float((got.x - ref.x).abs().max()) <= 1e-4 * scale


def test_multi_tile_sweep_needs_a_card():
    """The sweep behind ``march_plan``'s defaults has no CPU mode: without
    a card it exits with code 2 before it builds anything."""
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", "cgx_torch.experiments.multi_tile_sweep"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "needs a CUDA card" in proc.stderr

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and skip without one.  They import neither JAX nor
cgx, so they also run where JAX is missing; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""
import dataclasses
import os
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cgx_torch  # noqa: E402
from cgx_torch.io.poisson import poisson2d_dia, poisson3d_dia27  # noqa: E402
from cgx_torch.kernels import bsr as kb  # noqa: E402
from cgx_torch.kernels import fused_dia_cg as fdia  # noqa: E402
from cgx_torch.kernels import fused_engine as k3  # noqa: E402
from cgx_torch.kernels import fused_onepass as k6  # noqa: E402
from cgx_torch.kernels import fused_resident as k2  # noqa: E402
from cgx_torch.kernels import fused_semiresident as k4  # noqa: E402
from cgx_torch.kernels import stencil as k1  # noqa: E402
from cgx_torch.kernels import wbell as kw  # noqa: E402
from cgx_torch.kernels.fused_cg import (  # noqa: E402
    build_fused, fused_stencil_cg, stencil_taps)
from cgx_torch.dist.halo import cut_ghost_rows  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    cuda_device, scaled_dia_data, seeded, t, wide_reach_dia)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dims", [(5, 7, 6), (37, 41, 53)])
def test_k1_kernel_matches_plain(cuda_device, dims):
    nx, ny, nz = dims
    x = t(seeded(nx * ny * nz, seed=9, dtype=np.float32), cuda_device)
    before = k1.stencil3d_spmv_launches
    y = k1.stencil3d_spmv(x, nx=nx, ny=ny, nz=nz)
    torch.cuda.synchronize()
    assert k1.stencil3d_spmv_launches == before + 1
    y_ref = k1.stencil3d_spmv_reference(x, nx, ny, nz)
    # fp32, at most 7 terms summed in another order.
    assert float((y - y_ref).abs().max()) <= 1e-6 * float(y_ref.abs().max())
    with pytest.raises(TypeError):
        k1.stencil3d_spmv(x.double(), nx=nx, ny=ny, nz=nz)


@pytest.mark.parametrize("dims,offset", [((5, 7, 6), 0), ((37, 41, 53), 0),
                                         ((16, 24, 32), 0), ((16, 24, 32), 1),
                                         ((128, 128, 128), 0)])
def test_k1_march_equals_first_design(cuda_device, dims, offset):
    """The march equals K1's first design (``_before_spmv``) bit for bit:
    the scalar form at nz % 4 != 0 and on a misaligned x (a view at offset
    1), the float4 form otherwise; one launch, and within 1e-6 · max|y| of
    the plain version."""
    nx, ny, nz = dims
    n = nx * ny * nz
    buf = t(seeded(n + offset, seed=dims[0] + offset, dtype=np.float32),
            cuda_device)
    x = buf[offset:]
    coeffs = (6.5, -1.25, -0.75, -1.5)
    before = k1.stencil3d_spmv_launches
    y = k1.stencil3d_spmv(x, nx=nx, ny=ny, nz=nz, coeffs=coeffs)
    torch.cuda.synchronize()
    assert k1.stencil3d_spmv_launches == before + 1
    first = k1._before_spmv(x, nx, ny, nz, coeffs)
    torch.cuda.synchronize()
    assert k1.stencil3d_spmv_launches == before + 1
    assert torch.equal(y, first)
    y_ref = k1.stencil3d_spmv_reference(x, nx, ny, nz, coeffs)
    assert float((y - y_ref).abs().max()) <= 1e-6 * float(y_ref.abs().max())
    assert torch.equal(k1.stencil3d_spmv(x, nx=nx, ny=ny, nz=nz,
                                         coeffs=coeffs), y)


@pytest.mark.parametrize("op", ["p3d_small", "p3d", "27point", "2d"])
def test_k2_kernel_matches_plain(cuda_device, op):
    a = {"p3d_small": lambda: cgx_torch.poisson3d_stencil(10, 8, 9),
         "p3d": lambda: cgx_torch.poisson3d_stencil(33, 29, 31),
         "27point": lambda: cgx_torch.poisson3d_27point(17, 19, 15),
         "2d": lambda: cgx_torch.poisson2d_stencil(61, 67)}[op]()
    spec = stencil_taps(a)
    b = t(seeded(a.shape[0], seed=25, dtype=np.float32), cuda_device)
    b_copy = b.clone()
    before = k2.resident_cg_launches
    res = k2.resident_stencil_cg(a, b, tol=1e-6, maxiter=2000)
    torch.cuda.synchronize()
    assert k2.resident_cg_launches == before + 1
    assert torch.equal(b, b_copy)
    x_ref, _, _, k_ref, _, _ = k2.resident_cg_reference(spec, b, tol=1e-6,
                                                        maxiter=2000)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(k_ref)) <= 2
    assert float((res.x - x_ref).norm() / x_ref.norm()) <= 1e-4
    again = k2.resident_stencil_cg(a, b, tol=1e-6, maxiter=2000)
    assert torch.equal(again.x, res.x)


def test_k2_resume_and_warm_start(cuda_device):
    a = cgx_torch.poisson3d_stencil(20, 18, 22)
    spec = stencil_taps(a)
    b = t(seeded(a.shape[0], seed=26, dtype=np.float32), cuda_device)
    full = k2.resident_stencil_cg(a, b, tol=1e-6, maxiter=2000)
    x, r, p, k, rz, _ = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=7)
    assert int(k) == 7
    rest = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=2000,
                               resume=(x, r, p, rz[0], rz[1]))
    assert 7 + int(rest[3]) == int(full.iterations)
    assert torch.equal(rest[0], full.x)
    x0 = t(0.1 * seeded(a.shape[0], seed=27, dtype=np.float32), cuda_device)
    warm = k2.resident_stencil_cg(a, b, x0, tol=1e-6, maxiter=2000)
    ref = k2.resident_cg_reference(spec, b, x0, tol=1e-6, maxiter=2000)
    assert abs(int(warm.iterations) - int(ref[3])) <= 2
    assert float((warm.x - ref[0]).norm() / ref[0].norm()) <= 1e-4


def test_auto_solve_on_card_routes_to_k2(cuda_device):
    a = cgx_torch.poisson3d_stencil(60, 60, 60)
    b = torch.ones(a.shape[0], dtype=torch.float32, device=cuda_device)
    assert cgx_torch.select_backend(a, b) == "resident_stencil"
    before = k2.resident_cg_launches
    res = cgx_torch.auto_solve(a, b, tol=1e-6)
    assert k2.resident_cg_launches == before + 1
    assert bool(res.converged)
    before1 = k1.stencil3d_spmv_launches
    r = b - cgx_torch.spmv(a, res.x)
    assert k1.stencil3d_spmv_launches == before1 + 1
    assert float(r.norm() / b.norm()) <= 1e-3


def _dia(op, dev):
    """A DIA operator on the card: the scaled 7-point D·A·D, the variable
    27-point one, or the 2-D 5-point one with grid metadata."""
    if op == "dia7":
        data, offs, shape = scaled_dia_data(33, 29, 31, seed=3)
        return cgx_torch.DIAMatrix(data=t(data.astype(np.float32), dev),
                                   offsets=offs, shape=shape)
    if op == "dia27":
        return poisson3d_dia27(17, 19, 15, variable=True, seed=1, device=dev)
    a = poisson2d_dia(61, 67, dtype=np.float32, device=dev)
    return cgx_torch.DIAMatrix(data=a.data.to(dev), offsets=a.offsets,
                               shape=a.shape, grid=(61, 1, 67))


@pytest.mark.parametrize("op,jacobi", [("dia7", True), ("dia7", False),
                                       ("dia27", True), ("dia2d", True)])
def test_k2_planes_kernel_matches_plain(cuda_device, op, jacobi):
    a = _dia(op, cuda_device)
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        a, torch.float32, jacobi=jacobi)
    spec = (nx, ny, nz, taps, coeffs)
    b = t(seeded(a.shape[0], seed=28, dtype=np.float32), cuda_device)
    b_s = b if e is None else e * b
    kw = dict(planes=planes, weight=w, sym=sym, tol=1e-6, maxiter=4000)
    before = k2.resident_dia_launches
    x, _, _, k, rz, tol_sq = k2.resident_cg_call(spec, b_s, **kw)
    torch.cuda.synchronize()
    assert k2.resident_dia_launches == before + 1
    x_ref, _, _, k_ref, _, _ = k2.resident_cg_reference(spec, b_s, **kw)
    assert float(rz[1]) <= float(tol_sq)
    # fp32 sums in another order: ±2 iterations, x to 1e-4 relative.
    assert abs(int(k) - int(k_ref)) <= 2
    assert float((x - x_ref).norm() / x_ref.norm()) <= 1e-4
    again = k2.resident_cg_call(spec, b_s, **kw)
    assert torch.equal(again[0], x) and int(again[3]) == int(k)


def test_k2_planes_resume_and_dia_entry(cuda_device):
    a = _dia("dia7", cuda_device)
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        a, torch.float32)
    spec = (nx, ny, nz, taps, coeffs)
    b = t(seeded(a.shape[0], seed=29, dtype=np.float32), cuda_device)
    b_s = e * b
    kw = dict(planes=planes, weight=w, sym=sym, tol=1e-6)
    full = k2.resident_cg_call(spec, b_s, maxiter=4000, **kw)
    x, r, p, k, rz, _ = k2.resident_cg_call(spec, b_s, maxiter=7, **kw)
    assert int(k) == 7
    rest = k2.resident_cg_call(spec, b_s, maxiter=4000,
                               resume=(x, r, p, rz[0], rz[1]), **kw)
    assert 7 + int(rest[3]) == int(full[3])
    assert torch.equal(rest[0], full[0])
    before = k2.resident_dia_launches
    res = k2.resident_dia_cg(a, b, tol=1e-6, maxiter=4000)
    assert k2.resident_dia_launches == before + 1
    assert bool(res.converged)
    assert torch.equal(res.x, e * full[0])


def _k2_case(op, dev):
    """``(spec, b, kwargs)`` of a K2 solve: the constant stencils, or the
    DIA operators through ``dia_prep`` (weighted Jacobi scaling, or plain
    with ``dia7_plain``)."""
    if op in ("p3d", "27point", "2d"):
        a = {"p3d": lambda: cgx_torch.poisson3d_stencil(33, 29, 31),
             "27point": lambda: cgx_torch.poisson3d_27point(17, 19, 15),
             "2d": lambda: cgx_torch.poisson2d_stencil(61, 67)}[op]()
        b = t(seeded(a.shape[0], seed=75, dtype=np.float32), dev)
        return stencil_taps(a), b, {}
    a = _dia("dia7" if op == "dia7_plain" else op, dev)
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        a, torch.float32, jacobi=op != "dia7_plain")
    b = t(seeded(a.shape[0], seed=76, dtype=np.float32), dev)
    return ((nx, ny, nz, taps, coeffs), b if e is None else e * b,
            dict(planes=planes, weight=w, sym=sym))


@pytest.mark.parametrize("op", ["p3d", "27point", "2d", "dia7", "dia27",
                                "dia7_plain"])
def test_k2_two_phase_equals_three_phase_at_one_grid(cuda_device, op):
    """The two-phase kernel forms the three-phase kernel's p and q and takes
    its sums over the same rows: at one grid the two agree bit for bit (x,
    r, p, the iteration count and (rz, rw)).  ``dia7`` is weighted
    Jacobi."""
    spec, b, kw = _k2_case(op, cuda_device)
    grid = min(k2.resident_grid(spec, cuda_device, **kw),
               k2._three_phase_grid(spec, cuda_device, **kw))
    launches = (k2.resident_cg_launches, k2.resident_dia_launches)
    new = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=4000, grid=grid,
                              **kw)
    after = (k2.resident_cg_launches, k2.resident_dia_launches)
    old = k2._three_phase_call(spec, b, tol=1e-6, maxiter=4000, grid=grid,
                               **kw)
    torch.cuda.synchronize()
    assert sum(after) == sum(launches) + 1
    assert (k2.resident_cg_launches, k2.resident_dia_launches) == after
    assert int(new[3]) == int(old[3]) > 0
    for got, want in zip(new[:3] + new[4:5], old[:3] + old[4:5]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["p3d", "dia27"])
def test_k2_resume_across_the_exit(cuda_device, op):
    """After 7 iterations the kernel leaves p = r + β·p_old in the state's
    buffer (the three-phase kernel's p, bit for bit at one grid), and
    resuming from that state gives the one-call solve bit for bit."""
    spec, b, kw = _k2_case(op, cuda_device)
    grid = min(k2.resident_grid(spec, cuda_device, **kw),
               k2._three_phase_grid(spec, cuda_device, **kw))
    kw = dict(kw, tol=1e-6, grid=grid)
    full = k2.resident_cg_call(spec, b, maxiter=4000, **kw)
    x, r, p, k, rz, _ = k2.resident_cg_call(spec, b, maxiter=7, **kw)
    old = k2._three_phase_call(spec, b, maxiter=7, **kw)
    assert int(k) == 7
    for got, want in zip((x, r, p, rz), old[:3] + old[4:5]):
        assert torch.equal(got, want)
    rest = k2.resident_cg_call(spec, b, maxiter=4000,
                               resume=(x, r, p, rz[0], rz[1]), **kw)
    assert 7 + int(rest[3]) == int(full[3])
    for got, want in zip(rest[:3] + rest[4:5], full[:3] + full[4:5]):
        assert torch.equal(got, want)
    # No iteration at all: p comes back as r (fresh) or as given (resume).
    none = k2.resident_cg_call(spec, b, maxiter=0, **kw)
    assert int(none[3]) == 0 and torch.equal(none[2], none[1])
    again = k2.resident_cg_call(spec, b, maxiter=0,
                                resume=(x, r, p, rz[0], rz[1]), **kw)
    assert torch.equal(again[2], p) and torch.equal(again[0], x)


def _engine(op, dev):
    if op == "p3d":
        return build_fused(cgx_torch.poisson3d_stencil(33, 29, 31),
                           torch.float32), None
    if op == "2d":
        return build_fused(cgx_torch.poisson2d_stencil(61, 67),
                           torch.float32), None
    eng, e, _ = fdia.build_fused_dia(_dia(op, dev), torch.float32)
    return eng, e


@pytest.mark.parametrize("op", ["p3d", "2d", "dia7", "dia27"])
def test_k3_matches_plain(cuda_device, op):
    eng, e = _engine(op, cuda_device)
    b = t(seeded(eng.n, seed=30, dtype=np.float32), cuda_device)
    b_s = b if e is None else e * b
    before = (k3.fused_a_launches, k3.fused_b_launches)
    res = eng.solve(b_s, tol=1e-6, maxiter=4000, track_history=True)
    torch.cuda.synchronize()
    its = int(res.iterations)
    assert k3.fused_a_launches - before[0] >= its + 1
    assert k3.fused_b_launches - before[1] >= its
    ref = eng.solve_reference(b_s, tol=1e-6, maxiter=4000,
                              track_history=True)
    assert bool(res.converged)
    assert abs(its - int(ref.iterations)) <= 2
    assert float((res.x - ref.x).norm() / ref.x.norm()) <= 1e-4
    assert res.history.shape == (4001,)
    m = min(its, int(ref.iterations))
    np.testing.assert_allclose(res.history[:m + 1].cpu().numpy(),
                               ref.history[:m + 1].cpu().numpy(), rtol=2e-2)
    again = eng.solve(b_s, tol=1e-6, maxiter=4000, track_history=True)
    assert torch.equal(again.x, res.x)
    assert torch.equal(again.history, res.history)
    x0 = 0.1 * t(seeded(eng.n, seed=31, dtype=np.float32), cuda_device)
    warm = eng.solve(b_s, x0, tol=1e-6, maxiter=4000)
    warm_ref = eng.solve_reference(b_s, x0, tol=1e-6, maxiter=4000)
    assert abs(int(warm.iterations) - int(warm_ref.iterations)) <= 2
    assert float((warm.x - warm_ref.x).norm() / warm_ref.x.norm()) <= 1e-4


@pytest.mark.parametrize("op", ["p3d", "dia7", "dia27"])
def test_k3_single_steps_match_plain(cuda_device, op):
    eng, e = _engine(op, cuda_device)
    p = t(seeded(eng.n, seed=32, dtype=np.float32), cuda_device)
    q, pq, qq = eng.kernel_a(p)
    q_ref, pq_ref, qq_ref = eng.kernel_a_reference(p)
    # Same products and sums per row: equal to 1e-6 of the largest entry;
    # the block sums to 1e-5 relative.
    assert float((q - q_ref).abs().max()) <= 1e-6 * float(q_ref.abs().max())
    assert abs(float(pq) - float(pq_ref)) <= 1e-5 * abs(float(pq_ref))
    assert abs(float(qq) - float(qq_ref)) <= 1e-5 * abs(float(qq_ref))
    rz = torch.sum(p * p)
    x = torch.zeros_like(p)
    got = eng.kernel_b(rz, pq_ref, qq_ref, x, p, p, q_ref)
    ref = eng.kernel_b_reference(rz, pq_ref, qq_ref, x, p, p, q_ref)
    for g, r in zip(got[:3], ref[:3]):
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())
    for g, r in zip(got[3:], ref[3:]):
        assert abs(float(g) - float(r)) <= 1e-5 * abs(float(r))


def test_auto_solve_on_card_routes_dia_and_history(cuda_device):
    data, offs, shape = scaled_dia_data(60, 60, 60, seed=4)
    a = cgx_torch.DIAMatrix(data=t(data.astype(np.float32), cuda_device),
                            offsets=offs, shape=shape)
    m = cgx_torch.JacobiPrecond.from_matrix(a)
    b = torch.ones(a.shape[0], dtype=torch.float32, device=cuda_device)
    assert cgx_torch.select_backend(a, b, m) == "resident_dia"
    before = k2.resident_dia_launches
    res = cgx_torch.auto_solve(a, b, tol=1e-6, preconditioner=m)
    assert k2.resident_dia_launches == before + 1
    assert bool(res.converged)
    s = cgx_torch.poisson3d_stencil(150, 150, 150)
    bs = torch.ones(s.shape[0], dtype=torch.float32, device=cuda_device)
    before = (k2.resident_cg_launches, k3.fused_a_launches)
    res = cgx_torch.auto_solve(s, bs, tol=1e-6, track_history=True,
                               maxiter=50)
    assert k2.resident_cg_launches == before[0]
    assert k3.fused_a_launches > before[1]
    assert int(res.iterations) == 50 and res.history.shape == (51,)


def _wbell(case, dev, value_dtype=None):
    """A WBELL operator on the card: random SPD matrices of one group, of
    five groups (plus pad groups), and the thermal2 stand-in at 4,912
    rows."""
    import scipy.sparse as sp
    from cgx_torch.io.suitesparse import standin

    if case == "thermal":
        a = standin("thermal2", scale=0.004, device=dev)
    else:
        n, density = {"one_group": (700, 0.01), "five_groups": (5000,
                                                                0.002)}[case]
        r = sp.random(n, n, density=density, random_state=n, format="csr")
        a = sp.csr_matrix((r + r.T) + sp.eye(n) * (2.0 + density * n))
    return cgx_torch.wbell_from_csr(a, device=dev, value_dtype=value_dtype)


@pytest.mark.parametrize("case,k,bf16", [
    ("one_group", 1, False), ("five_groups", 3, False), ("thermal", 4, False),
    ("thermal", 9, False), ("thermal", 1, True), ("five_groups", 4, True)])
def test_wbell_kernels_match_plain(cuda_device, case, k, bf16):
    """K7, K8 and K9 against their plain versions on the same operands:
    equal bit for bit (each product and sum rounded on its own, in the
    same order), pad groups zero, two runs bitwise equal, one launch each.
    k = 3 and 9 leave columns of a chunk unused; bf16 planes upcast."""
    a = _wbell(case, cuda_device, torch.bfloat16 if bf16 else None)
    plan = kw.build_tier_plan(a)
    x = t(np.random.default_rng(k).standard_normal(
        (k, a.nt, 8, 128)).astype(np.float32), cuda_device)
    runs = {
        "k7": (lambda: kw.wbell_spmm(a, x), "wbell_resident_launches",
               kw.wbell_resident_reference(a, x)),
        "k8": (lambda: kw.wbell_spmm_tiered(plan, x), "wbell_tiered_launches",
               kw.wbell_tiered_reference(plan, x)),
        "k9": (lambda: kw.wbell_spmm(a, x, backend="windowed"),
               "wbell_windowed_launches", kw.wbell_windowed_reference(a, x)),
    }
    for name, (run, counter, ref) in runs.items():
        before = getattr(kw, counter)
        y = run()
        torch.cuda.synchronize()
        assert getattr(kw, counter) == before + 1, name
        assert float((y - ref).abs().max()) == 0.0, name
        assert torch.equal(run(), y), name
        assert float(y[:, a.ng_real:].abs().max()) == 0.0, name
    assert torch.equal(runs["k7"][2], runs["k8"][2])


@pytest.mark.parametrize("case,k,bf16", [
    ("one_group", 1, False), ("five_groups", 3, False), ("thermal", 4, False),
    ("thermal", 9, False), ("thermal", 1, True), ("five_groups", 4, True)])
def test_wbell_row_kernels_match_plain(cuda_device, case, k, bf16):
    """K7 and K9 over their row layouts against the layouts' plain version
    (rows_product) and against the plane walk they replace: equal bit for
    bit, one launch each, two runs equal, pad groups zero."""
    a = _wbell(case, cuda_device, torch.bfloat16 if bf16 else None)
    x = t(np.random.default_rng(k + 40).standard_normal(
        (k, a.nt, 8, 128)).astype(np.float32), cuda_device)
    for backend, rows, counter, planes in (
            ("resident", a.rows, "wbell_resident_launches", kw._planes_k7),
            ("windowed", a.windowed_rows, "wbell_windowed_launches",
             kw._planes_k9)):
        before = getattr(kw, counter)
        y = kw.wbell_spmm(a, x, backend=backend)
        torch.cuda.synchronize()
        assert getattr(kw, counter) == before + 1, backend
        assert torch.equal(y, kw.rows_product(rows, x)), backend
        assert torch.equal(y, planes(a, x)), backend
        assert torch.equal(kw.wbell_spmm(a, x, backend=backend), y), backend
        assert float(y[:, a.ng_real:].abs().max()) == 0.0, backend


def test_wbell_row_kernel_wide_columns(cuda_device, monkeypatch):
    """K7 over a layout with absolute int32 columns (where a group spans
    more than 16 bits of x) equals K7 over 16-bit offsets."""
    from cgx_torch.sparse import wbell as sw

    a = _wbell("thermal", cuda_device)
    x = t(np.random.default_rng(3).standard_normal(
        (2, a.nt, 8, 128)).astype(np.float32), cuda_device)
    monkeypatch.setattr(sw, "ROW_OFFSET_LIMIT", 1024)
    wide = sw.row_layout(a.values, a.lc, a.resident_walk, a.p_og, a.p_ga,
                         a.nt)
    assert wide.cols.dtype == torch.int32
    y = kw.wbell_resident_raw(a.p_og, a.p_ga, a.lc, a.values, x, rows=wide)
    torch.cuda.synchronize()
    assert torch.equal(y, kw.wbell_spmm(a, x))
    assert torch.equal(y, kw.rows_product(wide, x))


def test_wbell_windowed_refuses_a_window_past_shared_memory(cuda_device):
    """K9's C entry refuses a window whose two buffers pass a block's
    shared memory, and the next launch runs."""
    a = _wbell("five_groups", cuda_device)
    x = torch.zeros((1, a.nt, 8, 128), device=cuda_device)
    big = dataclasses.replace(a.windowed_rows, window=40000)
    with pytest.raises(RuntimeError, match="cudaError"):
        kw._launch_rows(big, x, "K9")
    y = kw.wbell_spmm(a, x, backend="windowed")
    torch.cuda.synchronize()
    assert float(y.abs().max()) == 0.0


@pytest.mark.parametrize("span", [32, 64])
def test_wbell_windowed_kernel_at_wide_spans(cuda_device, span):
    """K9 at spans whose windows the layout cuts into parts of 28 groups:
    equal to its plain version and to both plane walks bit for bit."""
    import scipy.sparse as sp

    n, m = 36_000, 78_000
    rng = np.random.default_rng(8)
    r = sp.csr_matrix((rng.random(m), (rng.integers(0, n, m),
                                       rng.integers(0, n, m))), shape=(n, n))
    a = cgx_torch.wbell_from_csr(
        sp.csr_matrix((r + r.T) + sp.eye(n) * 4.0), span=span,
        order="natural", balance_window=0, device=cuda_device)
    x = t(np.random.default_rng(span).standard_normal(
        (3, a.nt, 8, 128)).astype(np.float32), cuda_device)
    y = kw.wbell_spmm(a, x, backend="windowed")
    torch.cuda.synchronize()
    assert a.windowed_rows.window == 28 * 1024
    assert torch.equal(y, kw.rows_product(a.windowed_rows, x))
    assert torch.equal(y, kw._planes_k9(a, x))
    assert torch.equal(y, kw._planes_k7(a, x))


def test_wbell_kernels_refuse_what_they_do_not_take(cuda_device):
    a = _wbell("one_group", cuda_device)
    x = torch.zeros((1, a.nt, 8, 128), device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kw.wbell_resident_raw(a.p_og, a.p_ga, a.lc, a.values.double(), x)
    with pytest.raises(TypeError, match="float32 vectors"):
        kw.wbell_resident_raw(a.p_og, a.p_ga, a.lc, a.values, x.double())
    with pytest.raises(ValueError, match="internal layout"):
        kw.wbell_spmv(a, x[0, 0])


def test_wbell_auto_solve_on_card(cuda_device):
    """auto_solve routes a WBELLMatrix to "wbell": K7 once per iteration
    (Jacobi) and bit for bit the plain version's trajectory; a 2-D b runs
    K8 and each column equals its single-RHS solve."""
    a = _wbell("thermal", cuda_device)
    n = a.n
    b = torch.ones(n, dtype=torch.float32, device=cuda_device)
    m = cgx_torch.JacobiPrecond(inv_diag=1.0 / a.from_internal(a.diagonal()))
    assert cgx_torch.select_backend(a, b, m) == "wbell"
    before = kw.wbell_resident_launches
    res = cgx_torch.auto_solve(a, b, tol=1e-6, preconditioner=m)
    torch.cuda.synchronize()
    its = int(res.iterations)
    assert bool(res.converged)
    assert kw.wbell_resident_launches - before == its
    idi = a.to_internal(m.inv_diag)
    ref = cgx_torch.cg_solve(
        lambda v: kw.wbell_resident_reference(a, v[None])[0],
        a.to_internal(b), tol=1e-6, maxiter=n, preconditioner=lambda r: r * idi)
    assert int(ref.iterations) == its
    assert torch.equal(a.from_internal(ref.x), res.x)
    B = t(np.random.default_rng(5).standard_normal((n, 2)).astype(np.float32),
          cuda_device)
    before = kw.wbell_tiered_launches
    multi = cgx_torch.auto_solve(a, B, tol=1e-6, preconditioner=m)
    assert kw.wbell_tiered_launches - before == int(multi.iterations.max())
    for j in range(2):
        one = cgx_torch.auto_solve(a, B[:, j].contiguous(), tol=1e-6,
                                   preconditioner=m)
        assert int(one.iterations) == int(multi.iterations[j])
        assert torch.equal(one.x, multi.x[:, j])
    for pc in ("poly", "block_jacobi"):
        assert bool(cgx_torch.auto_solve(a, b, tol=1e-6,
                                         preconditioner=pc).converged)


def _multi(op, dev):
    """K5's engine for a case, and its Jacobi scaling: the 3-D and 2-D
    constant stencils, DIA-7 and DIA-27 with symmetric planes, and DIA-27
    with all 27 planes (the non-symmetric mode)."""
    from cgx_torch.kernels.fused_multi import FusedCGMulti

    if op in ("p3d", "2d"):
        a = (cgx_torch.poisson3d_stencil(33, 29, 31) if op == "p3d"
             else cgx_torch.poisson2d_stencil(61, 67))
        nx, ny, nz, taps, coeffs = stencil_taps(a)
        return FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs), None
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        _dia(op.split("_")[0], dev), torch.float32,
        assume_symmetric=False if op.endswith("full") else None)
    assert sym == (not op.endswith("full"))
    return FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                        weight=w, sym=sym), e


def _multi_block(n, k, seed, dev):
    """A seeded (k, n) block whose last row is zero when k > 1."""
    p = t(np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32), dev)
    if k > 1:
        p[-1] = 0.0
    return p


@pytest.mark.parametrize("op,k", [
    ("p3d", 1), ("p3d", 3), ("2d", 8), ("dia7", 3), ("dia27", 1),
    ("dia27", 8), ("dia27_full", 3), ("dia27", 11)])
def test_k5_single_steps_match_plain(cuda_device, op, k):
    """K5's kernels A and B, one launch each, against their plain versions
    and K3's kernel A per column; a zero column is frozen (x and r kept,
    p = r) and stays finite.  The kernels take 4 columns per pass: k = 8
    runs two full groups, k = 1 and 3 leave lanes unused, k = 11 runs
    three groups (4, 4 and 3)."""
    from cgx_torch.kernels import fused_multi as k5

    eng, _ = _multi(op, cuda_device)
    p = _multi_block(eng.n, k, 40 + k, cuda_device)
    before = (k5.multi_a_launches, k5.multi_b_launches)
    q, pq, qq = eng.kernel_a(p)
    torch.cuda.synchronize()
    q_ref, pq_ref, qq_ref = eng.kernel_a_reference(p)
    # The same products and sums per row, in tap order: q bit for bit.
    assert torch.equal(q, q_ref)
    one = k3.FusedCG(eng.nx, eng.ny, eng.nz, eng.taps, coeffs=eng.coeffs,
                     planes=eng.planes, weight=eng.weight, sym=eng.sym)
    for j in range(k):
        assert torch.equal(q[j], one.kernel_a(p[j])[0])
    # Exact fp64 sums in another order, one rounding: to 1e-6 relative.
    for g, r in ((pq, pq_ref), (qq, qq_ref)):
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())
    rz = torch.sum(p.double() ** 2, dim=1).float()
    x = 0.5 * p
    got = eng.kernel_b(rz, pq_ref, qq_ref, x, p, p, q_ref)
    torch.cuda.synchronize()
    ref = eng.kernel_b_reference(rz, pq_ref, qq_ref, x, p, p, q_ref)
    assert (k5.multi_a_launches, k5.multi_b_launches) == (before[0] + 1,
                                                          before[1] + 1)
    for g, r in zip(got[:3], ref[:3]):
        assert torch.isfinite(g).all()
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())
    for g, r in zip(got[3:], ref[3:]):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    if k > 1:
        assert torch.equal(got[0][-1], x[-1]) and torch.equal(got[1][-1],
                                                              p[-1])
        assert torch.equal(got[2][-1], p[-1])


@pytest.mark.parametrize("op,k", [("p3d", 4), ("dia7", 8), ("dia27", 3),
                                  ("dia27_full", 2), ("p3d", 11)])
def test_k5_matches_plain(cuda_device, op, k):
    """K5's solve (cold and warm) against its plain version on the card:
    the shared count ±2, x to 1e-4; two runs bit-identical; at least one
    (A, B) pair per iteration."""
    from cgx_torch.kernels import fused_multi as k5

    eng, e = _multi(op, cuda_device)
    b = t(np.random.default_rng(50 + k).standard_normal((k, eng.n)).astype(
        np.float32), cuda_device)
    b = b if e is None else e * b
    x0 = 0.1 * _multi_block(eng.n, k, 60 + k, cuda_device)
    for start in (None, x0):
        before = k5.multi_b_launches
        res = eng.solve(b, start, tol=1e-6, maxiter=4000)
        torch.cuda.synchronize()
        its = int(res.iterations[0])
        assert k5.multi_b_launches - before >= its
        assert bool(res.converged.all())
        ref = eng.solve_reference(b, start, tol=1e-6, maxiter=4000)
        assert abs(its - int(ref.iterations[0])) <= 2
        assert float((res.x - ref.x).norm() / ref.x.norm()) <= 1e-4
        again = eng.solve(b, start, tol=1e-6, maxiter=4000)
        assert torch.equal(again.x, res.x)
        assert torch.equal(again.iterations, res.iterations)


def test_auto_solve_on_card_routes_multi(cuda_device):
    """A 2-D b at FUSED_MIN_ROWS or more: the stencil runs K5 (no K2 or
    K3), the narrow-band DIA runs K3 per column (no K5)."""
    from cgx_torch.kernels import fused_multi as k5

    s = cgx_torch.poisson3d_stencil(150, 150, 150)
    b = t(np.random.default_rng(70).standard_normal((s.shape[0], 2)).astype(
        np.float32), cuda_device)
    before = (k5.multi_a_launches, k3.fused_a_launches,
              k2.resident_cg_launches)
    res = cgx_torch.auto_solve(s, b, tol=1e-6, maxiter=20)
    assert k5.multi_a_launches > before[0]
    assert (k3.fused_a_launches, k2.resident_cg_launches) == before[1:]
    assert res.iterations.tolist() == [20, 20] and res.x.shape == b.shape
    data, offs, shape = scaled_dia_data(150, 150, 150, seed=5)
    a = cgx_torch.DIAMatrix(data=t(data.astype(np.float32), cuda_device),
                            offsets=offs, shape=shape)
    m = cgx_torch.JacobiPrecond.from_matrix(a)
    before = (k5.multi_a_launches, k3.fused_a_launches)
    res = cgx_torch.auto_solve(a, b, tol=1e-6, maxiter=10, preconditioner=m)
    assert k5.multi_a_launches == before[0]
    assert k3.fused_a_launches > before[1]
    assert res.iterations.tolist() == [10, 10]


# -- K11: the block-ELL SpMM ---------------------------------------------------

def _bell(nbr, wb, bs, seed, device, dtype=torch.float32, pad=True):
    """A seeded BlockELL over nbr block rows and columns: wb distinct
    sorted block columns per row; with ``pad``, every third row keeps fewer
    real blocks (the rest zero, pointing at column 0)."""
    rng = np.random.default_rng(seed)
    cols = np.sort(np.stack([rng.choice(nbr, wb, replace=False)
                             for _ in range(nbr)]), axis=1).astype(np.int32)
    vals = rng.standard_normal((nbr, wb, bs, bs)).astype(np.float32)
    if pad and wb > 1:
        for i in range(0, nbr, 3):
            keep = 1 + i % wb
            vals[i, keep:] = 0.0
            cols[i, keep:] = 0
    return kb.BlockELL(values=t(vals, device).to(dtype),
                       block_cols=t(cols, device), shape=(nbr * bs, nbr * bs))


def _held_to_plain(a, x):
    """K11 once (one launch), its plain version, and a second run."""
    before = kb.bell_spmm_launches
    y = kb.bell_spmm(a, x)
    torch.cuda.synchronize()
    assert kb.bell_spmm_launches == before + 1
    y_ref = kb.bell_spmm_reference(a, x)
    assert y.dtype == torch.float32 and y.shape == y_ref.shape
    # fp32 accumulation in another order than the plain matmul's.
    assert float((y - y_ref).abs().max()) <= 1e-5 * float(y_ref.abs().max())
    assert torch.equal(kb.bell_spmm(a, x), y)
    return y


@pytest.mark.parametrize("k", [1, 7, 64, 256])
@pytest.mark.parametrize("bs", [8, 16, 64])
def test_k11_matches_plain(cuda_device, bs, k):
    a = _bell(24, 4, bs, 80 + bs + k, cuda_device)
    x = t(np.random.default_rng(k).standard_normal(
        (a.shape[1], k)).astype(np.float32), cuda_device)
    _held_to_plain(a, x)


@pytest.mark.parametrize("dtype,bs,k", [("bf16", 16, 33), ("bf16", 64, 256),
                                        ("fp32", 128, 70), ("bf16", 128, 64),
                                        ("fp32", 37, 5)])
def test_k11_bf16_odd_and_dynamic_blocks(cuda_device, dtype, bs, k):
    """bf16 operands (fp32 out), an odd block, and bs = 128 (dynamic shared
    memory)."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    a = _bell(10, 3, bs, 90 + bs, cuda_device, dtype=dt)
    x = t(np.random.default_rng(bs).standard_normal(
        (a.shape[1], k)).astype(np.float32), cuda_device).to(dt)
    _held_to_plain(a, x)


def test_k11_wb1_and_inert_padding(cuda_device):
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    diag = sp.csr_matrix(sp.block_diag(
        [rng.standard_normal((8, 8)) for _ in range(12)], format="csr"))
    d = sp.lil_matrix((64, 64))
    d.setdiag(2.0)
    d[0, :] = 1.0
    d[:, 0] = 1.0
    for s, wb_one in ((diag, True), (sp.csr_matrix(d), False)):
        csr = cgx_torch.csr_from_scipy(s.astype(np.float32),
                                       device=cuda_device)
        a = kb.bell_from_bsr(cgx_torch.bsr_from_csr(csr, 8))
        assert (a.wb == 1) == wb_one
        x = t(rng.standard_normal((s.shape[0], 4)).astype(np.float32),
              cuda_device)
        y = _held_to_plain(a, x)
        ref = s.astype(np.float32) @ x.double().cpu().numpy()
        assert float(np.abs(y.double().cpu().numpy() - ref).max()) <= \
            1e-5 * float(np.abs(ref).max())
        yv = kb.bell_spmv(a, x[:, 0])
        assert torch.equal(yv, y[:, 0])


def test_k11_engines_and_refusals(cuda_device):
    a = _bell(6, 2, 8, 7, cuda_device)
    x = t(np.ones((a.shape[1], 3), np.float32), cuda_device)
    before = kb.bell_spmm_launches
    ys = [kb.bell_spmm(a, x, engine=e) for e in ("auto", "resident", "dma")]
    assert kb.bell_spmm_launches == before + 3
    assert all(torch.equal(y, ys[0]) for y in ys)
    with pytest.raises(TypeError):
        kb.bell_spmm(a.astype(torch.float64), x.double())
    with pytest.raises(TypeError):
        kb.bell_spmm(a, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        kb.bell_spmm(a, x[:-8])
    big = kb.BlockELL(values=torch.zeros((1, 1, 129, 129),
                                         device=cuda_device),
                      block_cols=torch.zeros((1, 1), dtype=torch.int32,
                                             device=cuda_device),
                      shape=(129, 129))
    with pytest.raises(ValueError):
        kb.bell_spmm(big, torch.zeros((129, 1), device=cuda_device))
    assert kb.bell_spmm_launches == before + 3


# -- K11's paths: tiled, mma, rows and general ---------------------------------

def _bell_case(nbr, wb, bs, k, dtype, device, seed):
    a = _bell(nbr, wb, bs, seed, device, dtype=dtype)
    x = t(np.random.default_rng(seed + 1).standard_normal(
        (a.shape[1], k)).astype(np.float32), device).to(dtype)
    return a, x


@pytest.mark.parametrize("path,nbr,bs,k,dtype", [
    ("tiled", 24, 64, 256, torch.float32),
    ("tiled", 13, 8, 132, torch.float32),     # ragged k: 128 + 4 columns
    ("tiled", 5, 128, 64, torch.float32),     # bs 128: a smaller tile
    ("tiled", 260, 16, 32, torch.float32),    # K12 in two chunks, 8 threads
    ("general", 260, 16, 16, torch.float32),  # a tiled block of 4 threads
    ("mma", 24, 64, 256, torch.bfloat16),
    ("mma", 9, 32, 136, torch.bfloat16),      # ragged k
    ("mma", 5, 128, 64, torch.bfloat16),
    ("mma", 270, 16, 8, torch.bfloat16),
    ("rows", 37, 8, 4, torch.float32),        # 37 block rows, 32 per block
    ("rows", 300, 8, 1, torch.float32),
    ("rows", 11, 16, 8, torch.float32),
    ("rows", 9, 3, 3, torch.float32),         # scalar reads
    ("rows", 10, 12, 2, torch.float32),
    ("general", 10, 37, 5, torch.float32),
    ("general", 10, 16, 33, torch.bfloat16),
    ("general", 10, 64, 3, torch.bfloat16)])
def test_k11_path_counts_and_equals(cuda_device, path, nbr, bs, k, dtype):
    """Each shape takes its path (its counter moves, no other does); tiled
    and rows equal the general path bit for bit, mma is within 1e-5 of the
    plain version's peak; two runs, K12 and P2 equal K11 bit for bit."""
    from cgx_torch.experiments import bell_pair_proto as p2

    a, x = _bell_case(nbr, 4, bs, k, dtype, cuda_device, 40 + bs + k)
    assert kb.bell_plan(bs, k, dtype, True).path == path
    before, total = kb.bell_path_launches(), kb.bell_spmm_launches
    y = kb.bell_spmm(a, x)
    torch.cuda.synchronize()
    moved = {p: v - before[p] for p, v in kb.bell_path_launches().items()}
    assert moved == {p: int(p == path) for p in kb.PATHS}
    assert kb.bell_spmm_launches == total + 1
    y_ref = kb.bell_spmm_reference(a, x)
    assert y.dtype == torch.float32 and y.shape == y_ref.shape
    assert float((y - y_ref).abs().max()) <= 1e-5 * float(y_ref.abs().max())
    assert torch.equal(kb.bell_spmm(a, x), y)
    general = kb._k11(a, x, kb.bell_plan(bs, k, dtype, True, path="general"))
    if path in ("tiled", "rows"):
        assert torch.equal(general, y)
    assert torch.equal(kb.bell_spmm(a, x, engine="prefetch"), y)
    y2 = p2.bell_spmm_paired(a.block_cols, a.values, x.reshape(-1, bs, k),
                             k=k)
    assert torch.equal(y2.reshape(-1, k), y)


def test_k11_unaligned_pointer_takes_general(cuda_device):
    """x one float past a 16-byte boundary: the general path, equal to the
    tiled path's Y bit for bit; the C entry refuses a tiled plan there and
    a plan whose threads disagree with its own."""
    a, x = _bell_case(12, 4, 64, 64, torch.float32, cuda_device, 5)
    buf = torch.empty(x.numel() + 1, device=cuda_device)
    xu = buf[1:].view_as(x)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    before = kb.bell_path_launches()
    y = kb.bell_spmm(a, xu)
    torch.cuda.synchronize()
    assert kb.bell_path_launches()["general"] == before["general"] + 1
    assert torch.equal(y, kb.bell_spmm(a, x))
    tiled = kb.bell_plan(64, 64, torch.float32, True)
    assert tiled.path == "tiled"
    with pytest.raises(RuntimeError, match="tiled path"):
        kb._k11(a, xu, tiled)
    wrong = dataclasses.replace(tiled, threads=tiled.threads * 2)
    with pytest.raises(RuntimeError, match="cudaError"):
        kb._k11(a, x, wrong)


# -- Mixed precision: the bf16 modes of K3, K2 and K5, IR, faults C1/C2 -------

def _ragged(op, dev):
    """A ragged 37×41×53 operator: the 7-point stencil, or the scaled
    DIA-7 and the variable DIA-27 with grid metadata."""
    if op == "p3d":
        return cgx_torch.poisson3d_stencil(37, 41, 53)
    if op == "dia7":
        data, offs, shape = scaled_dia_data(37, 41, 53, seed=6)
        return cgx_torch.DIAMatrix(data=t(data.astype(np.float32), dev),
                                   offsets=offs, shape=shape)
    return poisson3d_dia27(37, 41, 53, variable=True, seed=2, device=dev)


def _narrow_engine(op, dev, dtype, plane_dtype=None):
    a = _ragged(op, dev)
    if op == "p3d":
        return build_fused(a, dtype), None
    eng, e, _ = fdia.build_fused_dia(a, dtype, plane_dtype=plane_dtype)
    return eng, e


def _same_sum(g, r):
    # Exact fp64 sums in another order, rounded to fp32 once.
    return abs(float(g) - float(r)) <= 1e-6 * abs(float(r))


@pytest.mark.parametrize("op", ["p3d", "dia7", "dia27"])
def test_k3_bf16_vectors_equal_plain(cuda_device, op):
    """K3 A and B with bf16 vectors (and bf16 planes) equal their plain
    versions bit for bit: widen, sum in fp32, round once."""
    eng, _ = _narrow_engine(op, cuda_device, torch.bfloat16)
    p = t(seeded(eng.n, seed=71, dtype=np.float32),
          cuda_device).to(torch.bfloat16)
    before = k3.fused_a_launches
    q, pq, qq = eng.kernel_a(p)
    torch.cuda.synchronize()
    assert k3.fused_a_launches == before + 1 and q.dtype == torch.bfloat16
    q_ref, pq_ref, qq_ref = eng.kernel_a_reference(p)
    assert torch.equal(q, q_ref)
    assert _same_sum(pq, pq_ref) and _same_sum(qq, qq_ref)
    rz = torch.sum(p.double() ** 2).float()
    x = 0.5 * p
    got = eng.kernel_b(rz, pq_ref, qq_ref, x, p, p, q_ref)
    ref = eng.kernel_b_reference(rz, pq_ref, qq_ref, x, p, p, q_ref)
    for g, r in zip(got[:3], ref[:3]):
        assert g.dtype == torch.bfloat16 and torch.equal(g, r)
    for g, r in zip(got[3:], ref[3:]):
        assert _same_sum(g, r)


@pytest.mark.parametrize("op", ["dia7", "dia27"])
def test_k3_bf16_planes_equal_plain_and_prerounded(cuda_device, op):
    """K3 A with bf16 planes and fp32 vectors equals its plain version and
    the fp32 mode on the planes rounded through bf16, bit for bit."""
    eng, e = _narrow_engine(op, cuda_device, torch.float32, torch.bfloat16)
    assert eng.planes.dtype == torch.bfloat16
    eng32 = k3.FusedCG(eng.nx, eng.ny, eng.nz, eng.taps, coeffs=eng.coeffs,
                       planes=eng.planes.float(), weight=eng.weight,
                       sym=eng.sym)
    p = t(seeded(eng.n, seed=72, dtype=np.float32), cuda_device)
    q, pq, qq = eng.kernel_a(p)
    q_ref, _, _ = eng.kernel_a_reference(p)
    q32, pq32, qq32 = eng32.kernel_a(p)
    torch.cuda.synchronize()
    assert torch.equal(q, q_ref) and torch.equal(q, q32)
    assert float(pq) == float(pq32) and float(qq) == float(qq32)
    b = t(seeded(eng.n, seed=73, dtype=np.float32), cuda_device) * e
    res = eng.solve(b, tol=1e-6, maxiter=3000)
    res32 = eng32.solve(b, tol=1e-6, maxiter=3000)
    assert bool(res.converged)
    assert int(res.iterations) == int(res32.iterations)
    assert torch.equal(res.x, res32.x)


@pytest.mark.parametrize("op", ["dia7", "dia27"])
def test_k2_bf16_planes_equal_prerounded_at_one_grid(cuda_device, op):
    """K2 with bf16 planes equals K2 fp32 on the planes rounded through
    bf16 bit for bit when both run at one grid (the sums depend on it),
    and its plain version to K2's usual bounds."""
    a = _ragged(op, cuda_device)
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        a, torch.float32)
    spec = (nx, ny, nz, taps, coeffs)
    pl16 = planes.to(torch.bfloat16)
    g16 = k2.resident_grid(spec, cuda_device, planes=pl16, weight=w, sym=sym)
    g32 = k2.resident_grid(spec, cuda_device, planes=planes, weight=w,
                           sym=sym)
    grid = min(g16, g32)
    b = t(seeded(a.shape[0], seed=74, dtype=np.float32), cuda_device)
    b_s = e * b
    kw = dict(weight=w, sym=sym, tol=1e-6, maxiter=4000, grid=grid)
    before = k2.resident_dia_launches
    x, _, _, k, rz, _ = k2.resident_cg_call(spec, b_s, planes=pl16, **kw)
    x32, _, _, k32, rz32, _ = k2.resident_cg_call(spec, b_s,
                                                  planes=pl16.float(), **kw)
    torch.cuda.synchronize()
    assert k2.resident_dia_launches == before + 2
    assert int(k) == int(k32) and torch.equal(x, x32)
    assert torch.equal(rz, rz32)
    kw.pop("grid")
    x_ref, _, _, k_ref, _, _ = k2.resident_cg_reference(spec, b_s,
                                                        planes=pl16, **kw)
    assert abs(int(k) - int(k_ref)) <= 2
    assert float((x - x_ref).norm() / x_ref.norm()) <= 1e-4
    res = k2.resident_dia_cg(a, b, tol=1e-6, maxiter=4000,
                             plane_dtype=torch.bfloat16)
    assert bool(res.converged)


@pytest.mark.parametrize("op,k", [("dia7", 4), ("dia27", 3),
                                  ("dia27_full", 5)])
def test_k5_bf16_planes_equal_plain_and_prerounded(cuda_device, op, k):
    """K5 A with bf16 planes equals its plain version and the fp32 mode
    on the planes rounded through bf16, bit for bit; so does the solve."""
    from cgx_torch.kernels.fused_multi import FusedCGMulti

    eng32, e = _multi(op, cuda_device)
    pl16 = eng32.planes.to(torch.bfloat16)
    eng = FusedCGMulti(eng32.nx, eng32.ny, eng32.nz, eng32.taps,
                       coeffs=eng32.coeffs, planes=pl16, weight=eng32.weight,
                       sym=eng32.sym)
    pre = FusedCGMulti(eng32.nx, eng32.ny, eng32.nz, eng32.taps,
                       coeffs=eng32.coeffs, planes=pl16.float(),
                       weight=eng32.weight, sym=eng32.sym)
    p = _multi_block(eng.n, k, 75, cuda_device)
    q, pq, qq = eng.kernel_a(p)
    q_ref, _, _ = eng.kernel_a_reference(p)
    q_pre, pq_pre, qq_pre = pre.kernel_a(p)
    torch.cuda.synchronize()
    assert torch.equal(q, q_ref) and torch.equal(q, q_pre)
    assert torch.equal(pq, pq_pre) and torch.equal(qq, qq_pre)
    b = (_multi_block(eng.n, k, 76, cuda_device) * e[None]).contiguous()
    res = eng.solve(b, tol=1e-6, maxiter=3000)
    res_pre = pre.solve(b, tol=1e-6, maxiter=3000)
    assert torch.equal(res.iterations, res_pre.iterations)
    assert torch.equal(res.x, res_pre.x)


@pytest.mark.parametrize("mode", ["stencil_bf16", "dia_planes", "dia_none"])
def test_ir_on_card_matches_plain(cuda_device, mode):
    """ir_cg_solve on the card (K3 in its narrow mode, fp32 K3 A for the
    outer residual) against the same loop through the plain versions."""
    from cgx_torch.solve.ir import ir_cg_solve_reference

    if mode == "stencil_bf16":
        a, m, kw = _ragged("p3d", cuda_device), None, {}
    else:
        a = _ragged("dia7", cuda_device)
        m = (cgx_torch.JacobiPrecond.from_matrix(a)
             if mode == "dia_planes" else None)
        kw = (dict(inner_dtype=torch.float32,
                   inner_plane_dtype=torch.bfloat16, inner_tol=5e-3)
              if mode == "dia_planes" else {})
    b = t(seeded(a.shape[0], seed=77, dtype=np.float32), cuda_device)
    before = (k3.fused_a_launches, k3.fused_b_launches)
    res = cgx_torch.ir_cg_solve(a, b, tol=1e-6, maxiter=6000,
                                preconditioner=m, **kw)
    torch.cuda.synchronize()
    assert k3.fused_a_launches > before[0] and k3.fused_b_launches > before[1]
    ref = ir_cg_solve_reference(a, b, tol=1e-6, maxiter=6000,
                                preconditioner=m, **kw)
    assert bool(res.converged) and bool(ref.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    assert float((res.x - ref.x).norm() / ref.x.norm()) <= 1e-4
    # The fp32 true residual it reports meets tol; in fp64 the kernel's
    # answer is as good as the plain version's (the DIA-7's fp32 operator
    # rounding leaves ~1.6e-6 there on both).
    assert float(res.residual_norm_sq) <= 1.001e-12 * float(b.norm()) ** 2
    a64 = a if mode == "stencil_bf16" else a.astype(torch.float64)

    def relres(x):
        r = b.double() - cgx_torch.spmv(a64, x.double())
        return float(r.norm() / b.double().norm())

    assert relres(res.x) <= 1.5 * relres(ref.x) + 1e-7


def test_auto_solve_mixed_precision_on_card(cuda_device, monkeypatch):
    """With FUSED_MIN_ROWS lowered, auto_solve(mixed_precision=True) runs
    K3 in its bf16-vector mode on a stencil and in its plane mode on a
    DIA-27 operator, and never K2."""
    import cgx_torch.solve.auto as auto

    monkeypatch.setattr(auto, "FUSED_MIN_ROWS", 1000)
    monkeypatch.setattr(auto, "RESIDENT_MIN_ROWS", 1000)
    for op in ("p3d", "dia27"):
        a = _ragged(op, cuda_device)
        m = None if op == "p3d" else cgx_torch.JacobiPrecond.from_matrix(a)
        b = t(seeded(a.shape[0], seed=78, dtype=np.float32), cuda_device)
        before = (k3.fused_a_launches, k2.resident_cg_launches
                  + k2.resident_dia_launches)
        res = cgx_torch.auto_solve(a, b, tol=1e-6, preconditioner=m,
                                   mixed_precision=True)
        torch.cuda.synchronize()
        assert bool(res.converged)
        assert k3.fused_a_launches > before[0]
        assert k2.resident_cg_launches + k2.resident_dia_launches \
            == before[1]


def test_c1_fp64_stencil_solve_on_card_equals_cpu(cuda_device):
    """Fault C1: an fp64 Stencil3D solve on the card takes the plain
    matvec (K1 is fp32 only) and equals the CPU solve."""
    a = cgx_torch.poisson3d_stencil(12, 10, 11)
    b = seeded(a.shape[0], seed=79)
    before = k1.stencil3d_spmv_launches
    res = cgx_torch.auto_solve(a, t(b, cuda_device), tol=1e-10)
    assert k1.stencil3d_spmv_launches == before
    cpu = cgx_torch.auto_solve(a, t(b), tol=1e-10)
    assert bool(res.converged) and res.x.dtype == torch.float64
    assert abs(int(res.iterations) - int(cpu.iterations)) <= 1
    np.testing.assert_allclose(res.x.cpu().numpy(), cpu.x.numpy(),
                               rtol=1e-9, atol=1e-12)


def test_c2_csr_products_are_bitwise_reproducible(cuda_device):
    """Fault C2: the CSR/COO/BSR products sum each row in storage order
    without atomics, so two runs on the card, and the CPU, agree bit for
    bit."""
    from cgx_torch.io.poisson import poisson3d

    a = poisson3d(40, 40, 40, dtype=np.float32, device=cuda_device)
    x = t(seeded(a.shape[0], seed=80, dtype=np.float32), cuda_device)
    y1 = cgx_torch.spmv(a, x)
    y2 = cgx_torch.spmv(a, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    cpu = poisson3d(40, 40, 40, dtype=np.float32, device="cpu")
    assert torch.equal(y1.cpu(), cgx_torch.spmv(cpu, x.cpu()))
    X = torch.stack([x, 2 * x, -x], dim=1)
    assert torch.equal(cgx_torch.spmm(a, X), cgx_torch.spmm(a, X))
    bsr = cgx_torch.bsr_from_csr(a, 8)
    assert torch.equal(cgx_torch.spmv(bsr, x), cgx_torch.spmv(bsr, x))


# -- The semi-resident whole-solve kernel K4 and the one-pass engine K6 ------
# Both take K3's sums over K3's partition, so on the card they equal K3's
# solve bit for bit; against their plain versions (the same algebra, fp64
# sums in torch's order) they are held to K3's bounds: ±2 iterations and
# x to 1e-4 relative.

def _stencil(op):
    return {"p3d": lambda: cgx_torch.poisson3d_stencil(37, 41, 53),
            "27point": lambda: cgx_torch.poisson3d_27point(17, 19, 15),
            "2d": lambda: cgx_torch.poisson2d_stencil(61, 67)}[op]()


def _near(res, ref):
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    assert float((res.x.cpu() - ref.x.cpu()).norm()
                 / ref.x.cpu().norm()) <= 1e-4


def _same(res, ref):
    assert int(res.iterations) == int(ref.iterations)
    assert torch.equal(res.x, ref.x)
    assert torch.equal(res.residual_norm_sq, ref.residual_norm_sq)


@pytest.mark.parametrize("op,mode", [("p3d", "rpq"), ("p3d", "rp"),
                                     ("p3d", "p"), ("27point", "rpq"),
                                     ("27point", "p"), ("2d", "rp")])
def test_k4_stencil_equals_k3_and_plain(cuda_device, op, mode):
    a = _stencil(op)
    b = t(seeded(a.shape[0], seed=40, dtype=np.float32), cuda_device)
    before = (k4.sr_cg_launches, k2.resident_cg_launches,
              k3.fused_a_launches)
    res = k4.sr_stencil_cg(a, b, tol=1e-6, maxiter=4000, mode=mode)
    torch.cuda.synchronize()
    assert (k4.sr_cg_launches, k2.resident_cg_launches,
            k3.fused_a_launches) == (before[0] + 1,) + before[1:]
    assert bool(res.converged)
    _same(res, fused_stencil_cg(a, b, tol=1e-6, maxiter=4000))
    _near(res, k4.sr_stencil_cg(a, b.cpu(), tol=1e-6, maxiter=4000,
                                mode=mode))
    _same(k4.sr_stencil_cg(a, b, tol=1e-6, maxiter=4000, mode=mode), res)


def _dia_pair(op, dev):
    a = _ragged(op, dev)
    cpu = cgx_torch.DIAMatrix(data=a.data.cpu(), offsets=a.offsets,
                              shape=a.shape, grid=a.grid)
    return a, cpu


@pytest.mark.parametrize("op,mode,jacobi", [
    ("dia7", "rpq", True), ("dia7", "rp", True), ("dia7", "p", True),
    ("dia7", "rpq", False), ("dia27", "rpq", True), ("dia27", "rp", True)])
def test_k4_dia_equals_k3_and_plain(cuda_device, op, mode, jacobi):
    a, a_cpu = _dia_pair(op, cuda_device)
    b = t(seeded(a.shape[0], seed=41, dtype=np.float32), cuda_device)
    kw = dict(tol=1e-6, maxiter=4000, jacobi=jacobi)
    # 7-tap plane operators in rpq run the first design (_design_for).
    ran = ("sr_cg_first_launches" if op == "dia7" and mode == "rpq"
           else "sr_cg_planes_launches")
    before = {c: getattr(k4, c) for c in ("sr_cg_first_launches",
                                          "sr_cg_planes_launches")}
    res = k4.sr_dia_cg(a, b, mode=mode, **kw)
    torch.cuda.synchronize()
    assert {c: getattr(k4, c) - v for c, v in before.items()} == {
        c: int(c == ran) for c in before}
    assert bool(res.converged)
    _same(res, fdia.fused_dia_cg(a, b, **kw))
    _near(res, k4.sr_dia_cg(a_cpu, b.cpu(), mode=mode, **kw))


@pytest.mark.parametrize("op", ["dia7", "dia27"])
def test_k4_bf16_planes_equal_prerounded(cuda_device, op):
    """bf16 planes are widened as they are loaded: the bf16 mode equals
    fp32 K4 on the planes rounded through bf16 at one partition, and K3's
    bf16 plane mode bit for bit."""
    a, _ = _dia_pair(op, cuda_device)
    b = t(seeded(a.shape[0], seed=42, dtype=np.float32), cuda_device)
    bf16 = torch.bfloat16
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        a, torch.float32)
    g = k4.make_sr_geometry(nx, ny, nz, taps, mode="rpq",
                            n_planes=planes.shape[0], weighted=True, sym=sym)
    grids = k3.FusedCG(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                       weight=w, sym=sym).grids(cuda_device)
    kw = dict(coeffs=coeffs, w=w, tol=1e-6, maxiter=300, grids=grids,
              b_norm_sq=torch.sum(b * b))
    before = k4.sr_cg_bf16_launches
    narrow = k4.sr_cg(g, e * b, planes=planes, plane_dtype=bf16, **kw)
    assert k4.sr_cg_bf16_launches == before + 1
    _same(narrow, k4.sr_cg(g, e * b, planes=planes.to(bf16).float(), **kw))
    _same(k4.sr_dia_cg(a, b, tol=1e-6, maxiter=300, plane_dtype=bf16),
          fdia.fused_dia_cg(a, b, tol=1e-6, maxiter=300, plane_dtype=bf16))


@pytest.mark.parametrize("mode", ["rpq", "rp"])
def test_k4_resume_equals_one_call(cuda_device, mode):
    a = _stencil("p3d")
    nx, ny, nz, taps, coeffs = stencil_taps(a)
    g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode)
    b = t(seeded(a.shape[0], seed=43, dtype=np.float32), cuda_device)
    full = k4.sr_cg_call(g, b, coeffs=coeffs, tol=1e-6, maxiter=4000)
    # An odd split leaves the newest p in the second buffer of rp.
    x, r, p, k, rz, _ = k4.sr_cg_call(g, b, coeffs=coeffs, tol=1e-6,
                                      maxiter=7)
    rest = k4.sr_cg_call(g, b, coeffs=coeffs, tol=1e-6, maxiter=4000 - 7,
                         resume=(x, r, p, rz[0], rz[1]))
    assert int(k) == 7 and int(k) + int(rest[3]) == int(full[3])
    for got, want in zip(rest[:3], full[:3]):
        assert torch.equal(got, want)
    assert torch.equal(rest[4], full[4])


def test_k4_x0_and_auto_solve_on_card(cuda_device):
    a = _stencil("p3d")
    b = t(seeded(a.shape[0], seed=44, dtype=np.float32), cuda_device)
    x0 = 0.1 * t(seeded(a.shape[0], seed=45, dtype=np.float32), cuda_device)
    res = k4.sr_stencil_cg(a, b, x0, tol=1e-6, maxiter=4000, mode="p")
    _near(res, k4.sr_stencil_cg(a, b.cpu(), x0.cpu(), tol=1e-6,
                                maxiter=4000, mode="p"))
    d, _ = _dia_pair("dia7", cuda_device)
    m = cgx_torch.JacobiPrecond.from_matrix(d)
    before = (k4.sr_cg_launches,
              k4.sr_cg_planes_launches + k4.sr_cg_first_launches,
              k2.resident_cg_launches, k2.resident_dia_launches,
              k3.fused_a_launches)
    s = cgx_torch.auto_solve(a, b, tol=1e-6, backend="sr_stencil")
    r = cgx_torch.auto_solve(d, b, tol=1e-6, preconditioner=m,
                             backend="sr_dia")
    torch.cuda.synchronize()
    # The DIA solve runs either K4 kernel (_design_for), counted once.
    assert (k4.sr_cg_launches,
            k4.sr_cg_planes_launches + k4.sr_cg_first_launches,
            k2.resident_cg_launches, k2.resident_dia_launches,
            k3.fused_a_launches) == (before[0] + 1, before[1] + 1) + before[2:]
    assert bool(s.converged) and bool(r.converged)
    _same(r, fdia.fused_dia_cg(d, b, tol=1e-6, maxiter=d.shape[0],
                               inv_diag=m.inv_diag))


@pytest.mark.parametrize("op", ["p3d", "27point", "2d"])
def test_k6_equals_k3_and_plain(cuda_device, op):
    a = _stencil(op)
    b = t(seeded(a.shape[0], seed=46, dtype=np.float32), cuda_device)
    kw = dict(tol=1e-6, maxiter=4000, track_history=True)
    before = (k6.onepass_launches, k3.fused_a_launches, k3.fused_b_launches)
    one = fused_stencil_cg(a, b, one_pass=True, **kw)
    torch.cuda.synchronize()
    its = int(one.iterations)
    assert k6.onepass_launches - before[0] >= its + 1
    # One K3 kernel-A launch at init, no kernel B.
    assert (k3.fused_a_launches, k3.fused_b_launches) == (before[1] + 1,
                                                          before[2])
    two = fused_stencil_cg(a, b, **kw)
    _same(one, two)
    assert torch.equal(one.history, two.history)
    plain = build_fused(a, torch.float32, one_pass=True).solve_reference(
        b, **kw)
    _near(one, plain)
    m = min(its, int(plain.iterations))
    np.testing.assert_allclose(one.history[:m + 1].cpu().numpy(),
                               plain.history[:m + 1].cpu().numpy(),
                               rtol=2e-2)
    x0 = 0.1 * t(seeded(a.shape[0], seed=47, dtype=np.float32), cuda_device)
    _same(fused_stencil_cg(a, b, x0, tol=1e-6, maxiter=4000, one_pass=True),
          fused_stencil_cg(a, b, x0, tol=1e-6, maxiter=4000))


@pytest.mark.parametrize("op", ["p3d", "27point"])
def test_k6_launch_shape_is_balanced(cuda_device, op):
    """K6's grid splits both of K3's partitions evenly: every block sweeps
    the same number of virtual blocks.  The first design's kernel, kept as
    the "before", equals the redesign and K3 bit for bit and counts no
    launch."""
    a = _stencil(op)
    eng = build_fused(a, torch.float32, one_pass=True)
    grid, ga, gb = eng.shape(cuda_device)
    assert grid >= 1 and ga % grid == 0 and gb % grid == 0
    b = t(seeded(a.shape[0], seed=49, dtype=np.float32), cuda_device)
    kw = dict(tol=1e-6, maxiter=4000, track_history=True)
    before = k6.onepass_launches
    old = k6._before_solve(eng, b, **kw)
    torch.cuda.synchronize()
    assert k6.onepass_launches == before
    new = eng.solve(b, **kw)
    _same(new, old)
    assert torch.equal(new.history, old.history)
    _same(new, fused_stencil_cg(a, b, **kw))


@pytest.mark.parametrize("share", [(1, 2), (3, 4)])
def test_k6_any_grid_equals_k3(cuda_device, monkeypatch, share):
    """Launched on a grid that does not divide K3's (some blocks sweep one
    virtual block more), K6 still takes K3's sums: bit for bit."""
    a = _stencil("p3d")
    eng = build_fused(a, torch.float32, one_pass=True)
    _, ga, _ = eng.shape(cuda_device)
    grid = ga * share[0] // share[1] + 1
    monkeypatch.setattr(k6, "_cached_shape", lambda *args: grid)
    b = t(seeded(a.shape[0], seed=50, dtype=np.float32), cuda_device)
    kw = dict(tol=1e-6, maxiter=4000, track_history=True)
    one = eng.solve(b, **kw)
    two = fused_stencil_cg(a, b, **kw)
    _same(one, two)
    assert torch.equal(one.history, two.history)


def test_k6_single_step_matches_plain(cuda_device):
    eng = build_fused(_stencil("p3d"), torch.float32, one_pass=True)
    b = t(seeded(eng.n, seed=48, dtype=np.float32), cuda_device)
    st = eng.init(b)
    got = eng.kernel_c(st.rz, st.x, st.r, st.p)
    ref = eng.kernel_c_reference(st.rz, st.x, st.r, st.p)
    for g, r in zip(got[:3], ref[:3]):
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())
    for g, r in zip(got[3], ref[3]):
        assert _same_sum(g, r)
    with pytest.raises(ValueError, match="constant-coefficient"):
        k6.OnePassCG(4, 4, 4, ((0, 0, 0),), coeffs=(None,))


# -- K10, K12 and the prototypes P1–P3 -----------------------------------------

@pytest.mark.parametrize("case,k,bf16", [
    ("one_group", 3, False), ("five_groups", 9, False), ("thermal", 4, False),
    ("five_groups", 4, True)])
def test_k10_equals_k7_and_plain(cuda_device, case, k, bf16):
    """K10 reads K7's row layout and reads and writes the stacked layout,
    summing as K7: equal to K7's Y (restacked), to its plain version and
    to its first design (the plane walk) bit for bit, one launch, two runs
    equal.  k = 9 runs two column chunks."""
    a = _wbell(case, cuda_device, torch.bfloat16 if bf16 else None)
    xb = t(np.random.default_rng(k).standard_normal(
        (k, a.nt, 8, 128)).astype(np.float32), cuda_device)
    xs = kw.to_stacked(xb)
    before = kw.wbell_stacked_launches
    y = kw.wbell_spmm_stacked(a, xs)
    torch.cuda.synchronize()
    assert kw.wbell_stacked_launches == before + 1
    assert torch.equal(y, kw.to_stacked(kw.wbell_spmm(a, xb)))
    assert torch.equal(y, kw.wbell_stacked_reference(a, xs))
    assert torch.equal(y, kw.to_stacked(kw.rows_product(a.rows, xb)))
    assert torch.equal(y, kw._planes_k10(a, xs))
    assert torch.equal(kw.wbell_spmm_stacked(a, xs), y)
    with pytest.raises(TypeError, match="float32 vectors"):
        kw._launch_rows(a.rows, xs.double(), "K10", stacked=True)


def test_k10_int32_columns(cuda_device, monkeypatch):
    """K10 over a row layout with absolute int32 columns (where a group
    spans more than 16 bits of x): equal to K7 over the same layout, to the
    layout's plain product (restacked) and to the plane walk bit for
    bit."""
    from cgx_torch.sparse import wbell as sw

    a = _wbell("thermal", cuda_device)
    monkeypatch.setattr(sw, "ROW_OFFSET_LIMIT", 1024)
    assert a.rows.cols.dtype == torch.int32
    xb = t(np.random.default_rng(5).standard_normal(
        (4, a.nt, 8, 128)).astype(np.float32), cuda_device)
    xs = kw.to_stacked(xb)
    y = kw.wbell_spmm_stacked(a, xs)
    torch.cuda.synchronize()
    assert torch.equal(y, kw.to_stacked(kw.wbell_spmm(a, xb)))
    assert torch.equal(y, kw.to_stacked(kw.rows_product(a.rows, xb)))
    assert torch.equal(y, kw._planes_k10(a, xs))


@pytest.mark.parametrize("nbr,bs,k,dtype", [
    (300, 8, 7, torch.float32), (513, 16, 64, torch.float32),
    (260, 64, 33, torch.bfloat16)])
def test_k12_equals_k11_in_chunks(cuda_device, nbr, bs, k, dtype):
    """"prefetch" launches K11's kernel once per chunk of 256 block rows
    (the last one ragged) into one Y: equal to K11 bit for bit."""
    a = _bell(nbr, 2, bs, 70 + nbr, cuda_device, dtype=dtype)
    x = t(np.random.default_rng(nbr).standard_normal(
        (a.shape[1], k)).astype(np.float32), cuda_device).to(dtype)
    before = (kb.bell_spmm_launches, kb.bell_prefetch_launches)
    y = kb.bell_spmm(a, x, engine="prefetch")
    torch.cuda.synchronize()
    chunks = -(-nbr // kb.PREFETCH_ROWS)
    assert (kb.bell_spmm_launches, kb.bell_prefetch_launches) == (
        before[0], before[1] + chunks)
    assert torch.equal(y, kb.bell_spmm(a, x))
    ref = kb.bell_prefetch_reference(a, x)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("wb,bs,k,dtype", [
    (2, 8, 1, torch.float32), (4, 16, 70, torch.float32),
    (8, 64, 256, torch.float32), (2, 128, 64, torch.float32),
    (4, 64, 33, torch.bfloat16), (2, 37, 5, torch.float32)])
def test_p2_equals_k11(cuda_device, wb, bs, k, dtype):
    """Two slots per shared-memory round, the same FMAs in the same order:
    equal to K11 bit for bit (bs 128 uses 197 KB of shared memory)."""
    from cgx_torch.experiments import bell_pair_proto as p2

    a = _bell(24, wb, bs, 50 + bs + k, cuda_device, dtype=dtype)
    x = t(np.random.default_rng(k).standard_normal(
        (a.shape[1], k)).astype(np.float32), cuda_device).to(dtype)
    before = p2.bell_pair_launches
    y = p2.bell_spmm_paired(a.block_cols, a.values, x.reshape(-1, bs, k),
                            k=k)
    torch.cuda.synchronize()
    assert p2.bell_pair_launches == before + 1
    assert torch.equal(y.reshape(-1, k), kb.bell_spmm(a, x))
    ref = p2.bell_pair_reference(a.block_cols, a.values,
                                 x.reshape(-1, bs, k), k=k)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    odd = _bell(4, 3, 8, 1, cuda_device)
    with pytest.raises(ValueError, match="even"):
        p2.bell_spmm_paired(odd.block_cols, odd.values,
                            torch.zeros((4, 8, 2), device=cuda_device), k=2)


@pytest.mark.parametrize("case,k", [("thermal", 1), ("thermal", 4),
                                    ("five_groups", 3)])
def test_p1_equals_plain_and_k7(cuda_device, case, k):
    """P1 runs the row kernel over the row layout of build_tiers' planes in
    class-major order: one launch on P1's counter alone, equal to the
    layout's plain version, to its plane walk's and to the plane-walking
    kernel it replaces bit for bit, to K7 within fp32 summation order."""
    from cgx_torch.experiments import tier_proto as p1

    a = _wbell(case, cuda_device)
    v, lc, pg, steps = p1.build_tiers(a, 8)
    walk = p1.tier_walk(pg, v, a.nt)
    rows = p1.tier_rows(pg, lc, v, a.nt, walk)
    x = t(np.random.default_rng(k).standard_normal(
        (k, a.nt, 8, 128)).astype(np.float32), cuda_device)
    before = (p1.tier_spmm_launches, kw.wbell_tiered_launches,
              kw.wbell_resident_launches)
    y = p1.tier_spmm(pg, lc, v, x, steps=steps, splane=8, rows=rows)
    torch.cuda.synchronize()
    assert (p1.tier_spmm_launches, kw.wbell_tiered_launches,
            kw.wbell_resident_launches) == (before[0] + 1,) + before[1:]
    assert torch.equal(y, kw.rows_product(rows, x))
    assert torch.equal(y, p1.tier_spmm_reference(pg, lc, v, x, steps=steps,
                                                 splane=8))
    assert torch.equal(y, p1._planes_p1(pg, lc, v, x, walk))
    assert torch.equal(p1.tier_spmm(pg, lc, v, x, steps=steps, splane=8), y)
    y7 = kw.wbell_spmm(a, x)
    assert float((y - y7).abs().max()) <= 1e-5 * float(y7.abs().max())


@pytest.mark.parametrize("case,k,bf16", [
    ("thermal", 4, False), ("five_groups", 3, False), ("thermal", 4, True)])
def test_k8_equals_k7_bitwise(cuda_device, case, k, bf16):
    """K8 runs the row kernel over its tier plan's layout, the matrix's
    (the plan's planes in its walk give the same arrays, built on the
    card): one launch on K8's counter, equal to K7 and to the plane walk
    it replaces bit for bit."""
    a = _wbell(case, cuda_device, torch.bfloat16 if bf16 else None)
    plan = kw.build_tier_plan(a)
    assert plan.rows is a.rows
    own = kw.tiered_rows(plan.packed, plan.lc, plan.values, plan.walk,
                         plan.nt)
    assert torch.equal(own.cols, a.rows.cols)
    assert torch.equal(own.values, a.rows.values)
    x = t(np.random.default_rng(k + 80).standard_normal(
        (k, a.nt, 8, 128)).astype(np.float32), cuda_device)
    before = (kw.wbell_tiered_launches, kw.wbell_resident_launches)
    y = kw.wbell_spmm_tiered(plan, x)
    torch.cuda.synchronize()
    assert (kw.wbell_tiered_launches, kw.wbell_resident_launches) == (
        before[0] + 1, before[1])
    assert torch.equal(y, kw.wbell_spmm(a, x))
    assert torch.equal(y, kw._planes_k8(plan, x))
    assert torch.equal(y, kw.rows_product(plan.rows, x))


@pytest.mark.parametrize("case", ["thermal", "five_groups"])
def test_p3_equals_plain_and_fp64(cuda_device, case):
    """P3, the segmented row kernel over the layout of half-block planes
    built on the host: equal to the layout's plain version, to its plane
    walk's and to the plane-walking kernel it replaces bit for bit, within
    1e-5 of the fp64 product (of the peak)."""
    import scipy.sparse as sp
    from cgx_torch.experiments import halfblock_proto as p3
    from cgx_torch.io.suitesparse import standin

    if case == "thermal":
        s = standin("thermal2", scale=0.004, device="cpu")
        s = sp.csr_matrix((s.values.numpy().astype(np.float64),
                           s.col_indices.numpy(), s.indptr.numpy()),
                          shape=s.shape)
    else:
        r = sp.random(5000, 5000, density=0.002, random_state=5000,
                      format="csr")
        s = sp.csr_matrix((r + r.T) + sp.eye(5000) * 12.0)
    a = cgx_torch.wbell_from_csr(s, device=cuda_device)
    v, lc, og, ga, _, _ = p3.build_halfblock(s, 16, device=cuda_device)
    packed = (og << 16) | ga
    walk = p3.half_walk(packed, lc, v, a.nt, 16)
    rows = p3.half_rows(packed, lc, v, a.nt, walk)
    assert rows.segmented
    xv = np.random.default_rng(3).standard_normal(s.shape[0]).astype(
        np.float32)
    xi = a.to_internal(t(xv, cuda_device))[None]
    before = (p3.half_spmv_launches, kw.wbell_resident_launches)
    y = p3.half_spmv(packed, lc, v, xi, span=16, splane=64, rows=rows)
    torch.cuda.synchronize()
    assert (p3.half_spmv_launches, kw.wbell_resident_launches) == (
        before[0] + 1, before[1])
    assert torch.equal(y, kw.rows_product(rows, xi))
    assert torch.equal(y, p3.half_reference(packed, lc, v, xi, span=16,
                                            splane=64))
    assert torch.equal(y, p3._planes_p3(packed, lc, v, xi, walk))
    assert torch.equal(p3.half_spmv(packed, lc, v, xi, span=16, splane=64), y)
    truth = s @ xv.astype(np.float64)
    got = a.from_internal(y[0]).double().cpu().numpy()
    assert np.abs(got - truth).max() <= 1e-5 * np.abs(truth).max()


@pytest.mark.parametrize("wide", [False, True])
def test_p3_segmented_kernel_on_dense_blocks(cuda_device, monkeypatch, wide):
    """The segmented row kernel where segments hold 8 entries (dense 8×8
    blocks), k = 2, beside 16-bit column offsets and int32 indices: equal
    to the layout's plain version and to the plane walk bit for bit."""
    import scipy.sparse as sp
    from cgx_torch.experiments import halfblock_proto as p3
    from cgx_torch.sparse import wbell as sw

    rng = np.random.default_rng(60)
    pattern = sp.random(300, 300, density=0.01, random_state=61,
                        format="csr")
    s = sp.kron(((pattern + pattern.T) + sp.eye(300)).tocsr(),
                np.ones((8, 8)), format="csr")
    s.data = rng.standard_normal(s.nnz)
    a = cgx_torch.wbell_from_csr(s, device=cuda_device)
    if wide:
        monkeypatch.setattr(sw, "ROW_OFFSET_LIMIT", 1024)
    v, lc, og, ga, _, _ = p3.build_halfblock(s, 16, device=cuda_device)
    packed = (og << 16) | ga
    walk = p3.half_walk(packed, lc, v, a.nt, 16)
    rows = p3.half_rows(packed, lc, v, a.nt, walk)
    assert rows.cols.dtype == (torch.int32 if wide else torch.int16)
    x = t(rng.standard_normal((2, a.nt, 8, 128)).astype(np.float32),
          cuda_device)
    y = p3.half_spmv(packed, lc, v, x, span=16, splane=64, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(y, kw.rows_product(rows, x))
    assert torch.equal(y, p3.half_reference(packed, lc, v, x, span=16,
                                            splane=64, walk=walk))
    assert torch.equal(y, p3._planes_p3(packed, lc, v, x, walk))


# -- The redesigned kernels A of K3 and K5 against their first designs --------

def _k3_case(op, dev):
    """K3's engine for a case of the redesign's checks: the fp32 modes of
    test_k3_single_steps_match_plain, bf16 vectors and bf16 planes on the
    ragged 37×41×53 operators."""
    mode, _, op = op.rpartition(":")
    if mode == "bf16":
        return _narrow_engine(op, dev, torch.bfloat16)[0]
    if mode == "planes":
        return _narrow_engine(op, dev, torch.float32, torch.bfloat16)[0]
    if mode == "ragged":
        return _narrow_engine(op, dev, torch.float32)[0]
    return _engine(op, dev)[0]


_K3_CASES = ["p3d", "dia7", "dia27", "ragged:p3d", "bf16:p3d", "bf16:dia7",
             "bf16:dia27", "planes:dia7", "planes:dia27"]


@pytest.mark.parametrize("op", _K3_CASES)
def test_k3_redesigned_a_equals_first_design(cuda_device, op):
    """The redesigned kernel A (the carried node, two rows in flight)
    equals the first one bit for bit: q and the 2·ga partials of K3's
    partition; only the redesign counts launches."""
    eng = _k3_case(op, cuda_device)
    p = t(seeded(eng.n, seed=90, dtype=np.float32), cuda_device).to(
        eng.dtype)
    before = k3.fused_a_launches
    q0, part0 = k3._before_kernel_a(eng, p)
    torch.cuda.synchronize()
    assert k3.fused_a_launches == before
    q, part = eng._kernel_a_call(p, design=k3._REDESIGN)
    torch.cuda.synchronize()
    assert k3.fused_a_launches == before + 1
    assert torch.equal(q, q0) and torch.equal(part, part0)


@pytest.mark.parametrize("op", _K3_CASES)
def test_k3_redesigned_b_equals_first_design(cuda_device, op):
    """The redesigned kernel B (p·q and q·q from the control block, its
    partials folded once a launch) equals the first one bit for bit for
    one step: x', r', p' and its partials."""
    from cgx_torch.kernels import _build

    eng = _k3_case(op, cuda_device)
    p = t(seeded(eng.n, seed=95, dtype=np.float32), cuda_device).to(
        eng.dtype)
    q, pq, qq = eng.kernel_a(p)
    rz = torch.sum(p.double() ** 2).float()
    x = (0.5 * p.float()).to(eng.dtype)
    outs = []
    for design in (k3._REDESIGN, k3._FIRST_DESIGN):
        lib, args, out = eng._kernel_b_setup(rz, pq, qq, x, p, p, q, design)
        _build.check(lib.cgx_fused_b(*args), "K3 B launch")
        outs.append(out)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("op", _K3_CASES)
def test_k3_solves_equal_first_design(cuda_device, op):
    """A whole K3 solve through the redesigned kernels (the partials folded
    once a launch) equals the first design's: x, iterations, history."""
    eng = _k3_case(op, cuda_device)
    b = t(seeded(eng.n, seed=91, dtype=np.float32), cuda_device).to(
        eng.dtype)
    kw = dict(tol=1e-6, maxiter=300, track_history=True)
    new = eng.solve(b, **kw)
    old = k3._before_solve(eng, b, **kw)
    assert int(new.iterations) == int(old.iterations)
    assert torch.equal(new.x, old.x) and torch.equal(new.history,
                                                     old.history)


@pytest.mark.parametrize("op", ["p3d", "dia7", "dia27", "bf16:p3d"])
def test_k3_grids_unchanged(cuda_device, op):
    """``FusedCG.grids`` is still the first kernels' occupancy: on the H100
    8 blocks an SM of kernel A at 7 taps and 4 at 27, which K4 and K6 take
    over; the redesigned kernel A runs no more blocks than that."""
    eng = _k3_case(op, cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ga, gb = eng.grids(cuda_device)
    assert ga == (4 if len(eng.taps) > 7 else 8) * sms and gb % sms == 0
    assert 1 <= eng.a_launch_grid(cuda_device, ga) <= ga


def test_k3_redesigned_a_on_any_grid(cuda_device, monkeypatch):
    """Launched on fewer blocks than K3's partition (blocks then walk
    several of its virtual blocks), the redesigned kernel A and the solve
    still equal the first design bit for bit."""
    eng = _k3_case("dia7", cuda_device)
    ga = eng.grids(cuda_device)[0]
    monkeypatch.setattr(type(eng), "a_launch_grid",
                        lambda self, dev, g: g // 3 + 1)
    p = t(seeded(eng.n, seed=92, dtype=np.float32), cuda_device)
    q, part = eng._kernel_a_call(p, design=k3._REDESIGN)
    q0, part0 = k3._before_kernel_a(eng, p)
    assert torch.equal(q, q0) and torch.equal(part, part0)
    kw = dict(tol=1e-6, maxiter=300, track_history=True)
    new, old = eng.solve(p, **kw), k3._before_solve(eng, p, **kw)
    assert ga // 3 + 1 < ga
    assert int(new.iterations) == int(old.iterations)
    assert torch.equal(new.x, old.x) and torch.equal(new.history,
                                                     old.history)


@pytest.mark.parametrize("op,k", [
    ("p3d", 1), ("dia27", 3), ("dia27_full", 8), ("2d", 11), ("dia7", 4)])
def test_k5_march_equals_first_kernel_a(cuda_device, op, k):
    """K5's march equals the first kernel A in q bit for bit for k = 1, 3,
    8 and 11 (one to three groups of 4 columns), its sums within 1e-6 (fp64
    sums in another order); only the march counts launches."""
    from cgx_torch.kernels import fused_multi as k5

    eng, _ = _multi(op, cuda_device)
    p = _multi_block(eng.n, k, 93 + k, cuda_device)
    before = k5.multi_a_launches
    q0, pq0, qq0 = k5._before_kernel_a(eng, p)
    torch.cuda.synchronize()
    assert k5.multi_a_launches == before
    q, pq, qq = eng.kernel_a(p)
    torch.cuda.synchronize()
    assert k5.multi_a_launches == before + 1
    assert torch.equal(q, q0)
    for g, r in ((pq, pq0), (qq, qq0)):
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())


@pytest.mark.parametrize("op", ["p3d", "dia27"])
def test_k5_solves_bit_identical(cuda_device, op):
    """Two K5 solves through the march are bit-identical (the sums' order
    is fixed), and they take the first kernel A's iteration count ±2."""
    from cgx_torch.kernels import fused_multi as k5

    eng, e = _multi(op, cuda_device)
    b = t(np.random.default_rng(94).standard_normal((4, eng.n)).astype(
        np.float32), cuda_device)
    b = b if e is None else e * b
    one = eng.solve(b, tol=1e-6, maxiter=4000)
    two = eng.solve(b, tol=1e-6, maxiter=4000)
    assert torch.equal(one.x, two.x)
    assert torch.equal(one.iterations, two.iterations)
    old = k5._before_solve(eng, b, tol=1e-6, maxiter=4000)
    assert abs(int(one.iterations[0]) - int(old.iterations[0])) <= 2
    assert bool(one.converged.all())


@pytest.mark.parametrize("k", [1, 4])
def test_k5_wide_reach_takes_the_first_kernel_a(cuda_device, k):
    """An operator reaching 40 lines in y, more than the march's stage
    holds, runs K5 with the first kernel A (counted as K5 A's launches)
    through ``cg_solve_multi(backend="fused")`` and converges to the
    batched loop's answer."""
    from cgx_torch.kernels import fused_multi as k5
    from cgx_torch.solve import block

    a = wide_reach_dia(8, 96, 16, 40).to(cuda_device)
    m = cgx_torch.JacobiPrecond.from_matrix(a)
    b = _multi_block(a.shape[0], k, 96, cuda_device).T.contiguous()
    b[:, -1] = 1.0
    before = k5.multi_a_launches
    got = block.cg_solve_multi(a, b, preconditioner=m, backend="fused",
                               tol=1e-6, maxiter=2000)
    torch.cuda.synchronize()
    assert k5.multi_a_launches > before
    ref = block.cg_solve_multi(a, b, preconditioner=m, backend="xla",
                               tol=1e-6, maxiter=2000)
    assert bool(got.converged.all())
    scale = float(ref.x.abs().max())
    assert float((got.x - ref.x).abs().max()) <= 1e-4 * scale


# -- K4's and K3 B's redesigns against their first designs ---------------------

def _sr_case(op, dev, mode, plane_dtype=None, jacobi=True):
    """``(g, b_s, kw, user_solve, k3_solve, scale)`` of a K4 case on the
    ragged 37×41×53 operators (the 27-point stencil at 17×19×15): the
    geometry, the solve-space right-hand side, :func:`k4.sr_cg_call`'s
    arguments, the user entry and K3's solve of the same system, and the
    scaling from the solve space."""
    b = t(seeded(37 * 41 * 53, seed=96, dtype=np.float32), dev)
    if op in ("p3d", "27point"):
        a = _ragged("p3d", dev) if op == "p3d" else _stencil("27point")
        b = b[:a.shape[0]].contiguous()
        nx, ny, nz, taps, coeffs = stencil_taps(a)
        g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode)
        return (g, b, dict(coeffs=coeffs, tol=1e-6, maxiter=2000),
                lambda: k4.sr_stencil_cg(a, b, tol=1e-6, maxiter=2000,
                                         mode=mode),
                lambda: fused_stencil_cg(a, b, tol=1e-6, maxiter=2000), None)
    a = _ragged(op, dev)
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        a, torch.float32, jacobi=jacobi)
    g = k4.make_sr_geometry(nx, ny, nz, taps, mode=mode,
                            n_planes=planes.shape[0], weighted=w is not None,
                            sym=sym)
    kw = dict(coeffs=coeffs, w=w, planes=planes, plane_dtype=plane_dtype,
              tol=1e-6, maxiter=2000, b_norm_sq=torch.sum(b * b))
    dkw = dict(tol=1e-6, maxiter=2000, jacobi=jacobi, plane_dtype=plane_dtype)
    return (g, b if e is None else e * b, kw,
            lambda: k4.sr_dia_cg(a, b, mode=mode, **dkw),
            lambda: fdia.fused_dia_cg(a, b, **dkw), e)


_SR_CASES = [("p3d", "rpq", None, True), ("p3d", "rp", None, True),
             ("p3d", "p", None, True), ("27point", "rpq", None, True),
             ("27point", "p", None, True), ("dia7", "rpq", None, True),
             ("dia7", "rp", None, True), ("dia7", "p", None, True),
             ("dia7", "rpq", None, False), ("dia27", "rpq", None, True),
             ("dia27", "rp", None, True), ("dia7", "rpq", "bf16", True),
             ("dia27", "rpq", "bf16", True)]


@pytest.mark.parametrize("smaller", [False, True])
@pytest.mark.parametrize("op,mode,pdt,jacobi", _SR_CASES)
def test_k4_redesign_equals_first_design_and_k3(cuda_device, monkeypatch,
                                                op, mode, pdt, jacobi,
                                                smaller):
    """The redesigned K4 (one fold at each barrier, K3's occupancy, carried
    nodes, two rows in flight at 27 taps) equals its first design bit for
    bit — x, r, p, the iteration count and (rz, rw) — and K3's solve
    through the user entry, on its default grid and on a smaller one that
    divides nothing; only the package's path counts a launch (7-tap plane
    operators in rpq run the first design there)."""
    pdt = None if pdt is None else torch.bfloat16
    g, b, kw, user, k3_solve, e = _sr_case(op, cuda_device, mode, pdt,
                                           jacobi)
    if smaller:
        monkeypatch.setattr(k4, "_cached_grid",
                            lambda ga, gb, cap, sms: cap // 3 + 1)
    counter = ("sr_cg_launches", "sr_cg_planes_launches",
               "sr_cg_first_launches")
    counts = [getattr(k4, c) for c in counter]
    old = k4._before_call(g, b, **kw)
    torch.cuda.synchronize()
    assert [getattr(k4, c) for c in counter] == counts
    new = k4.sr_cg_call(g, b, **kw)
    torch.cuda.synchronize()
    eng = k3.FusedCG(g.nx, g.ny, g.nz, g.taps, coeffs=kw["coeffs"],
                     planes=kw.get("planes"), weight=kw.get("w"), sym=g.sym)
    ran = ("sr_cg_first_launches"
           if k4._design_for(g, eng) == k4._FIRST_DESIGN
           else "sr_cg_planes_launches" if "planes" in kw
           else "sr_cg_launches")
    assert [getattr(k4, c) - v for c, v in zip(counter, counts)] == [
        int(c == ran) for c in counter]
    assert int(new[3]) == int(old[3])
    for u, v in zip(new[:3] + new[4:5], old[:3] + old[4:5]):
        assert torch.equal(u, v)
    res = user()
    _same(res, k3_solve())
    x = new[0] if e is None else e * new[0]
    assert int(res.iterations) == int(new[3]) and torch.equal(res.x, x)


def test_k4_grid_divides_k3_grids(cuda_device):
    """At 7 taps and at 27 K4's grid splits both of K3's partitions evenly
    and fits the card's blocks at once."""
    for op in ("p3d", "27point", "dia27"):
        g, _, kw, *_ = _sr_case(op, cuda_device, "rpq")
        eng = k3.FusedCG(g.nx, g.ny, g.nz, g.taps, coeffs=kw["coeffs"],
                         planes=kw.get("planes"), weight=kw.get("w"),
                         sym=g.sym)
        ga, gb = eng.grids(cuda_device)
        grid = k4.sr_launch_grid(g, eng, cuda_device, ga, gb)
        cap = k4._occupancy(_lib(), cuda_device, g, eng, k4._REDESIGN)
        assert 1 <= grid <= cap and ga % grid == 0 and gb % grid == 0


def test_k4_resume_through_both_designs(cuda_device):
    """A solve split at an odd count and resumed through either design
    equals one call of either, bit for bit (rp: p in the second buffer)."""
    g, b, kw, *_ = _sr_case("p3d", cuda_device, "rp")
    full = k4.sr_cg_call(g, b, **kw)
    x, r, p, k, rz, _ = k4._before_call(g, b, **dict(kw, maxiter=7))
    rest = k4.sr_cg_call(g, b, **dict(kw, maxiter=2000 - 7,
                                      resume=(x, r, p, rz[0], rz[1])))
    assert int(k) + int(rest[3]) == int(full[3])
    for u, v in zip(rest[:3] + rest[4:5], full[:3] + full[4:5]):
        assert torch.equal(u, v)


def _lib():
    from cgx_torch.kernels import _build
    return _build.library()


@pytest.mark.parametrize("op", ["p3d", "dia7", "bf16:p3d", "bf16:dia7"])
def test_k3_b_rows_equal_first_design(cuda_device, op):
    """Kernel B with its rows in flight (two in bf16 vectors, one in fp32)
    equals the first kernel B bit for bit (x', r', p', its partials) in
    fp32 and bf16 vectors, weighted (DIA) and not, at n = 80,401 (not a
    multiple of 256)."""
    eng = _k3_case(op, cuda_device)
    p = t(seeded(eng.n, seed=97, dtype=np.float32), cuda_device).to(
        eng.dtype)
    q, pq, qq = eng.kernel_a(p)
    rz = torch.sum(p.double() ** 2).float()
    x = (0.5 * p.float()).to(eng.dtype)
    outs = []
    for design in (k3._REDESIGN, k3._FIRST_DESIGN):
        lib, args, out = eng._kernel_b_setup(rz, pq, qq, x, p, p, q, design)
        _build_check(lib.cgx_fused_b(*args))
        outs.append(out)
    torch.cuda.synchronize()
    assert eng.n % 256 != 0
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def _build_check(rc):
    from cgx_torch.kernels import _build
    _build.check(rc, "K3 B launch")


def test_k3_b_refuses_aliased_vectors(cuda_device):
    """The redesigned kernel B takes its vectors as __restrict__: its
    wrapper refuses vectors that share storage."""
    eng = _k3_case("dia7", cuda_device)
    v = t(seeded(eng.n, seed=98, dtype=np.float32), cuda_device)
    part = torch.zeros(2, dtype=torch.float64, device=cuda_device)
    ctl = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    q = torch.empty_like(v)
    with pytest.raises(ValueError, match="share storage"):
        eng._b_args(v, v.clone(), v, q, part, 1, part, 1, ctl, None)
    with pytest.raises(ValueError, match="share storage"):
        eng._b_args(v, v.clone(), v.clone(), eng.weight, part, 1, part, 1,
                    ctl, None)


# -- the accuracy and reliability layer on the card ---------------------------

def test_df64_on_card_equals_cpu(cuda_device):
    """The error-free transforms stay exact on the card (0 mismatches
    against fp64), and df_dot and the df64 ELL product equal the CPU's
    word for word: every step is one IEEE-rounded op on both."""
    import scipy.sparse as sp

    from cgx_torch.ops import df64 as d
    from cgx_torch.solve import hp

    rng = np.random.default_rng(51)
    a32 = (rng.standard_normal(1 << 16) * np.exp2(
        rng.integers(-12, 13, 1 << 16))).astype(np.float32)
    b32 = rng.standard_normal(1 << 16).astype(np.float32)
    ta, tb = t(a32, cuda_device), t(b32, cuda_device)
    p, e = d.two_prod(ta, tb)
    assert torch.equal(p.double() + e.double(), ta.double() * tb.double())
    s, se = d.two_sum(ta, tb)
    assert torch.equal(s.double() + se.double(), ta.double() + tb.double())
    x = rng.standard_normal(5000) * np.logspace(0, 4, 5000)
    y = rng.standard_normal(5000)
    on_card = d.df_dot(d.df_from_f64(x, cuda_device),
                       d.df_from_f64(y, cuda_device))
    on_cpu = d.df_dot(d.df_from_f64(x, "cpu"), d.df_from_f64(y, "cpu"))
    assert float(on_card.hi) == float(on_cpu.hi)
    assert float(on_card.lo) == float(on_cpu.lo)
    m = sp.random(700, 700, density=0.02, random_state=5, format="csr")
    m = (m + m.T + sp.eye(700) * 5.0).tocsr()
    v = rng.standard_normal(700)
    yc = hp.df64_ell_spmv(hp.df64_ell_from_csr(m, device=cuda_device),
                          d.df_from_f64(v, cuda_device))
    yh = hp.df64_ell_spmv(hp.df64_ell_from_csr(m, device="cpu"),
                          d.df_from_f64(v, "cpu"))
    assert torch.equal(yc.hi.cpu(), yh.hi) and torch.equal(yc.lo.cpu(),
                                                           yh.lo)


def test_ir_df64_wbell_on_card(cuda_device):
    """The refinement over K7 inners reaches its TRUE tolerance on the
    card, and K7 is what ran."""
    import scipy.sparse as sp

    from cgx_torch.ops.df64 import df_to_f64

    rng = np.random.default_rng(3)
    m = sp.random(600, 600, density=0.02, random_state=3, format="csr")
    m = (m + m.T + sp.eye(600) * 14.0).tocsr()
    d = sp.diags(np.logspace(0, 3, 600))
    m = (d @ m @ d).tocsr()
    b = rng.standard_normal(600)
    pre = cgx_torch.JacobiPrecond(inv_diag=t(
        (1.0 / m.diagonal()).astype(np.float32), cuda_device))
    before = kw.wbell_resident_launches
    res, info = cgx_torch.ir_df64_solve(m, b, tol=1e-8, inner_tol=1e-2,
                                        preconditioner=pre,
                                        inner_format="wbell",
                                        device=cuda_device)
    assert kw.wbell_resident_launches - before >= info["inner_iterations"]
    x = df_to_f64(res.x)
    assert np.linalg.norm(b - m @ x) / np.linalg.norm(b) <= 1.5e-8


@pytest.mark.parametrize("backend,op_kind", [
    ("resident", "stencil"), ("fused", "stencil"), ("fused", "dia"),
    ("fused", "dia7"), ("sr", "stencil"), ("sr", "dia"), ("sr", "dia7")])
def test_checkpointed_kernels_equal_monolithic(cuda_device, tmp_path,
                                               backend, op_kind):
    """A chunked solve through K2, K3 or K4 equals the kernel's monolithic
    solve under the same Jacobi bit for bit, on the 2-D Poisson DIA (a
    constant diagonal) and on the scaled DIA-7 D·A·D (a varying one); on a
    stencil (an unscaled state) a solve preempted after two chunks and
    resumed from its file does too."""
    from cgx_torch.kernels.fused_resident import resident_stencil_cg
    from cgx_torch.utils.checkpoint import make_checkpointed_solver

    if op_kind == "stencil":
        a, m = cgx_torch.poisson3d_stencil(24, 20, 18), None
    elif op_kind == "dia7":
        a = _dia("dia7", cuda_device)
        m = cgx_torch.JacobiPrecond.from_matrix(a)
    else:
        a = poisson2d_dia(48, 40, dtype=np.float32, device=cuda_device)
        a = cgx_torch.DIAMatrix(data=a.data, offsets=a.offsets,
                                shape=a.shape, grid=(48, 1, 40))
        m = cgx_torch.JacobiPrecond.from_matrix(a)
    b = t(seeded(a.shape[0], seed=17, dtype=np.float32), cuda_device)
    kind = "stencil" if op_kind == "stencil" else "dia"
    mono = {
        ("resident", "stencil"): lambda: resident_stencil_cg(
            a, b, tol=1e-6, maxiter=2000),
        ("fused", "stencil"): lambda: fused_stencil_cg(a, b, tol=1e-6,
                                                       maxiter=2000),
        ("fused", "dia"): lambda: fdia.fused_dia_cg(
            a, b, tol=1e-6, maxiter=2000, inv_diag=m.inv_diag),
        ("sr", "stencil"): lambda: k4.sr_stencil_cg(a, b, tol=1e-6,
                                                    maxiter=2000),
        ("sr", "dia"): lambda: k4.sr_dia_cg(a, b, tol=1e-6, maxiter=2000,
                                            inv_diag=m.inv_diag),
    }[backend, kind]()
    solve = make_checkpointed_solver(a, tol=1e-6, maxiter=2000,
                                     preconditioner=m, chunk=10,
                                     backend=backend)
    res = solve(b)
    assert int(res.iterations) == int(mono.iterations) > 20
    assert torch.equal(res.x, mono.x)
    if op_kind == "stencil":
        class Preempted(Exception):
            pass

        path = str(tmp_path / "ck.npz")
        seen = []

        def stop(state):
            seen.append(int(state.k))
            if len(seen) == 2:
                raise Preempted

        with pytest.raises(Preempted):
            solve(b, checkpoint_path=path, on_chunk=stop)
        again = solve(b, checkpoint_path=path)
        assert int(again.iterations) == int(res.iterations)
        assert torch.equal(again.x, res.x)


def test_native_format_on_card(cuda_device, tmp_path):
    """A WBELL operator saved and loaded onto the card gives K7's product
    bit for bit."""
    import scipy.sparse as sp

    from cgx_torch.io.native_format import load_matrix, save_matrix

    m = sp.random(900, 900, density=0.01, random_state=7, format="csr")
    w = cgx_torch.wbell_from_csr((m + m.T + sp.eye(900) * 9.0).tocsr(),
                                 device=cuda_device)
    path = str(tmp_path / "w.npz")
    save_matrix(path, w)
    w2, _ = load_matrix(path, device=cuda_device)
    x = w.to_internal(t(seeded(900, seed=4, dtype=np.float32), cuda_device))
    assert torch.equal(kw.wbell_spmv(w2, x), kw.wbell_spmv(w, x))


# -- distribution: the fused engines across ranks -------------------------------


def _dist_k3_whole(op, dev):
    dims = (16, 12, 20)
    if op == "stencil7":
        return build_fused(cgx_torch.poisson3d_stencil(*dims),
                           torch.float32), None
    if op == "bf16_vectors":
        return build_fused(cgx_torch.poisson3d_stencil(*dims),
                           torch.bfloat16), None
    if op == "dia7":
        from cgx_torch.io.poisson import poisson3d_dia
        a = poisson3d_dia(*dims, dtype=np.float32, device=dev)
        d = torch.from_numpy(np.random.default_rng(31).uniform(
            0.5, 2.0, a.shape[0]).astype(np.float32)).to(dev)
        a = dataclasses.replace(a, data=a.data * d)
        return fdia.build_fused_dia(a, torch.float32)[0], a
    a = poisson3d_dia27(*dims, variable=True, device=dev)
    kw = {"plane_dtype": torch.bfloat16} if op == "dia27_bf16" else {}
    return fdia.build_fused_dia(a, torch.float32, **kw)[0], a


@pytest.mark.parametrize("op", ["stencil7", "bf16_vectors", "dia7", "dia27",
                                "dia27_bf16"])
def test_dist_k3_shard_kernels(cuda_device, op):
    """K3 A of shard r of 4 on the card, its ghost planes cut from the
    neighbouring shards, gives the whole grid's q rows (the single-card
    kernel's) bit for bit, and equals its plain version; kernel B in the
    cross-rank mode equals its plain version (x', r', p' bit for bit, the
    fp64 sums to 1e-12)."""
    whole, a = _dist_k3_whole(op, cuda_device)
    p = t(seeded(whole.n, seed=41, dtype=np.float32), cuda_device).to(
        whole.dtype)
    q_whole = whole.kernel_a(p)[0]
    shards, plane = 4, whole.ny * whole.nz
    nl = whole.n // shards
    for r in range(shards):
        rows = slice(r * nl, (r + 1) * nl)
        if a is None:
            eng = k3.FusedCG(whole.nx // shards, whole.ny, whole.nz,
                             whole.taps, dtype=whole.dtype,
                             coeffs=whole.coeffs, shard=k3.Shard(r, shards))
        else:
            eng = fdia.build_fused_dia(a, torch.float32, n_shards=shards,
                                       rank=r,
                                       plane_dtype=whole.plane_dtype)[0]
        pe = cut_ghost_rows(p, r, shards, plane)
        before = k3.fused_a_launches
        q, s = eng.kernel_a_ext(pe)
        torch.cuda.synchronize()
        assert k3.fused_a_launches == before + 1
        q_ref, s_ref = eng.kernel_a_ext_reference(pe)
        assert torch.equal(q, q_whole[rows]) and torch.equal(q, q_ref)
        assert float(((s - s_ref).abs() / s_ref.abs()).max()) <= 1e-12
        x = (0.5 * p[rows].float()).to(whole.dtype)
        rz = torch.sum(p[rows].double() ** 2).float()
        out = eng.kernel_b_ext(rz, s, x, p[rows], p[rows], q)
        out_ref = eng.kernel_b_ext_reference(rz, s, x, p[rows], p[rows], q)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(out[:3], out_ref[:3]))
        assert float(((out[3] - out_ref[3]).abs()
                      / out_ref[3].abs()).max()) <= 1e-12


@pytest.mark.parametrize("op,k", [("stencil7", 4), ("dia27", 4),
                                  ("dia27", 5)])
def test_dist_k5_shard_kernels(cuda_device, op, k):
    """K5 A (the march) of shard r of 4, its ghost planes cut from the
    neighbours (a chunk's first and last planes reading them), gives the
    whole grid's Q rows bit for bit and equals its plain version; its
    cross-rank kernel B equals its plain version (k = 5: two column
    groups)."""
    from cgx_torch.kernels import fused_multi as k5

    dims = (16, 12, 20)
    if op == "stencil7":
        nx, ny, nz, taps, coeffs = stencil_taps(
            cgx_torch.poisson3d_stencil(*dims))
        prep = None
        whole = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs)
    else:
        a = poisson3d_dia27(*dims, variable=True, device=cuda_device)
        prep = fdia.dia_prep(a, torch.float32)
        nx, ny, nz, taps, coeffs, planes, _, w, sym = prep
        whole = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs,
                                planes=planes, weight=w, sym=sym)
    pb = t(seeded(k * whole.n, seed=43, dtype=np.float32),
           cuda_device).reshape(k, whole.n)
    q_whole = whole.kernel_a(pb)[0]
    shards, plane = 4, ny * nz
    nl = whole.n // shards
    for r in range(shards):
        rows = slice(r * nl, (r + 1) * nl)
        if prep is None:
            eng = k5.FusedCGMulti(nx // shards, ny, nz, taps, coeffs=coeffs,
                                  shard=k3.Shard(r, shards))
        else:
            eng = fdia.dia_shard_engine(prep, torch.float32,
                                        k3.Shard(r, shards),
                                        engine=k5.FusedCGMulti)[0]
        assert eng.a_design() == k5._MARCH
        pe = cut_ghost_rows(pb, r, shards, plane)
        q, s = eng.kernel_a_ext(pe)
        q_ref, s_ref = eng.kernel_a_ext_reference(pe)
        torch.cuda.synchronize()
        assert torch.equal(q, q_whole[:, rows]) and torch.equal(q, q_ref)
        assert float(((s - s_ref).abs() / s_ref.abs()).max()) <= 1e-12
        pr = pb[:, rows].contiguous()
        rz = torch.sum(pr.double() ** 2, dim=1).float()
        out = eng.kernel_b_ext(rz, s, 0.5 * pr, pr, pr, q)
        out_ref = eng.kernel_b_ext_reference(rz, s, 0.5 * pr, pr, pr, q)
        torch.cuda.synchronize()
        assert all(torch.equal(g, v) for g, v in zip(out[:3], out_ref[:3]))
        assert float(((out[3] - out_ref[3]).abs()
                      / out_ref[3].abs()).max()) <= 1e-12


@pytest.fixture(scope="module")
def nccl_mesh():
    """An NCCL group of one rank on the card (destroyed after the module),
    or a skip without a card."""
    import socket

    import torch.distributed as dist

    from cgx_torch import dist as tdist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card")

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tdist.initialize(f"tcp://localhost:{port}", 1, 0, device="cuda")
    assert dist.get_backend() == "nccl"
    yield tdist.make_row_mesh(1)
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["stencil", "dia7_jacobi", "multi_dia27"])
def test_dist_fused_one_rank_equals_single_card(cuda_device, nccl_mesh,
                                                case):
    """On an NCCL group of one rank the cross-rank kernels (fp64 sums
    all-reduced between the kernels, rounded once) solve as the
    single-card kernels, bit for bit; one all-reduce follows every kernel
    launch, two more start the solve, and nothing is sent."""
    from cgx_torch import dist as tdist
    from cgx_torch.dist import halo
    from cgx_torch.kernels import fused_multi as k5

    dims = (32, 24, 20)
    if case == "stencil":
        a = cgx_torch.poisson3d_stencil(*dims)
        b = t(seeded(a.shape[0], seed=47, dtype=np.float32), cuda_device)
        ref = fused_stencil_cg(a, b, tol=1e-6, maxiter=2000,
                               track_history=True)
        run = lambda: tdist.dist_fused_cg(  # noqa: E731
            a, b, nccl_mesh, tol=1e-6, maxiter=2000, track_history=True)
    elif case == "dia7_jacobi":
        from cgx_torch.io.poisson import poisson3d_dia
        a = poisson3d_dia(*dims, dtype=np.float32, device=cuda_device)
        b = t(seeded(a.shape[0], seed=53, dtype=np.float32), cuda_device)
        ref = fdia.fused_dia_cg(a, b, tol=1e-6, maxiter=2000)
        run = lambda: tdist.dist_fused_cg(  # noqa: E731
            a, b, nccl_mesh, jacobi=True, tol=1e-6, maxiter=2000)
    else:
        a = poisson3d_dia27(*dims, variable=True, device=cuda_device)
        b = t(seeded(a.shape[0] * 4, seed=59, dtype=np.float32),
              cuda_device).reshape(a.shape[0], 4)
        ref = k5.fused_dia_cg_multi(a, b, tol=1e-6, maxiter=2000)
        run = lambda: tdist.dist_fused_cg_multi(  # noqa: E731
            a, b, nccl_mesh, jacobi=True, tol=1e-6, maxiter=2000)
    multi = case == "multi_dia27"
    mod = k5 if multi else k3
    names = (("multi_a_launches", "multi_b_launches") if multi
             else ("fused_a_launches", "fused_b_launches"))
    before = [getattr(mod, nm) for nm in names]
    halo.reset_counters()
    res = run()
    torch.cuda.synchronize()
    launched = [getattr(mod, nm) - b0 for nm, b0 in zip(names, before)]
    comm = halo.counters()
    assert min(launched) > 0
    assert comm["all_reduces"] == 2 + sum(launched)
    assert comm["sends"] == comm["all_gathers"] == 0
    assert torch.equal(res.iterations, ref.iterations)
    assert torch.equal(res.x, ref.x)
    assert torch.equal(res.history, ref.history)

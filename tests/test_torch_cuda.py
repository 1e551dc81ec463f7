"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and skip without one.  They import neither JAX nor
cgx, so they also run where JAX is missing; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""
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
from cgx_torch.kernels import fused_resident as k2  # noqa: E402
from cgx_torch.kernels import stencil as k1  # noqa: E402
from cgx_torch.kernels import wbell as kw  # noqa: E402
from cgx_torch.kernels.fused_cg import build_fused, stencil_taps  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    cuda_device, scaled_dia_data, seeded, t)

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

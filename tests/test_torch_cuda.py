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
from cgx_torch.kernels import fused_resident as k2  # noqa: E402
from cgx_torch.kernels import stencil as k1  # noqa: E402
from cgx_torch.kernels.fused_cg import stencil_taps  # noqa: E402
from torch_parity import cuda_device, seeded, t  # noqa: E402,F401

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

"""K6's plain version — the port's one-pass engine (OnePassCG through
fused_stencil_cg(one_pass=True)) — against cgx's Pallas kernel in
interpret mode, as tests/test_onepass.py runs it, at that file's sizes, on
the CPU and in fp32.

cgx sums in fp32, the port exactly, so the two are held to cgx's kernel-
test bounds (±2 iterations, x to rtol 5e-3 / atol 5e-4, the history to
rtol 2e-2); inside the port the one-pass solve equals the two-pass
engine's plain solve (K3) bit for bit, history included.
"""
import importlib

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cgx.sparse.stencil as jst  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.kernels import fused_engine as k3  # noqa: E402
from cgx_torch.kernels import fused_onepass as k6  # noqa: E402
from cgx_torch.kernels.fused_cg import (  # noqa: E402
    build_fused, fused_stencil_cg)
from torch_parity import n_, seeded, t  # noqa: E402

jfc = importlib.import_module("cgx.kernels.fused_cg")


def _stencil(case):
    taps27 = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dz in (-1, 0, 1))
    return {"p3d": lambda: jst.poisson3d_stencil(12, 10, 11),
            "2d": lambda: jst.poisson2d_stencil(33, 29),
            "27point": lambda: jst.GeneralStencil3D(
                nx=8, ny=9, nz=10, taps=taps27,
                coeffs=tuple(26.5 if tp == (0, 0, 0) else -1.0
                             for tp in taps27)),
            "warm": lambda: jst.poisson3d_stencil(9, 7, 6)}[case]()


@pytest.mark.parametrize("case", ["p3d", "2d", "27point", "warm"])
def test_onepass_matches_cgx_and_k3(case):
    s = _stencil(case)
    n = s.shape[0]
    b = seeded(n, seed=91, dtype=np.float32)
    x0 = ((0.1 * seeded(n, seed=92)).astype(np.float32)
          if case == "warm" else None)
    kw = dict(tol=1e-6, maxiter=3000, track_history=True)
    ref = jfc.fused_stencil_cg(s, jnp.asarray(b),
                               None if x0 is None else jnp.asarray(x0),
                               interpret=True, one_pass=True, **kw)
    st = operator_from_cgx(s, device="cpu")
    x0_t = None if x0 is None else t(x0)
    before = k6.onepass_launches
    res = fused_stencil_cg(st, t(b), x0_t, one_pass=True, **kw)
    assert k6.onepass_launches == before             # CPU: no kernel
    assert bool(res.converged) and bool(ref.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(n_(res.x), np.asarray(ref.x), rtol=5e-3,
                               atol=5e-4)
    assert res.history.shape == tuple(ref.history.shape)
    k = min(int(res.iterations), int(ref.iterations))
    np.testing.assert_allclose(n_(res.history)[:k + 1],
                               np.asarray(ref.history)[:k + 1], rtol=2e-2)
    two = fused_stencil_cg(st, t(b), x0_t, **kw)
    assert int(res.iterations) == int(two.iterations)
    assert torch.equal(res.x, two.x) and torch.equal(res.history,
                                                     two.history)


def test_onepass_chunked_run_and_state():
    """init carries the four sums [Σr², Σr²·w, p·Ap, ‖Ap‖²]; a run to
    k = 5 and on to the end is the solve; one plain iteration equals one
    step of the two-pass engine."""
    s = cgx_torch.poisson3d_stencil(10, 8, 9)
    eng = build_fused(s, torch.float32, one_pass=True)
    assert isinstance(eng, k6.OnePassCG)
    b = t(seeded(eng.n, seed=93, dtype=np.float32))
    full = eng.solve(b, tol=1e-6, maxiter=500, track_history=True)
    tol_sq = k3.threshold(b, 1e-6, 0.0)
    st = eng.init(b, history_len=501)
    assert st.rz.shape == (4,)
    _, pq, qq = eng.kernel_a_reference(b)
    assert torch.equal(st.rz[2:], torch.stack([pq, qq]))
    st = eng.run(st, 5, tol_sq)
    assert int(st.k) == 5
    st = eng.run(st, 500, tol_sq)
    res = eng.result(st, tol_sq, 500)
    assert int(res.iterations) == int(full.iterations)
    assert torch.equal(res.x, full.x) and torch.equal(res.history,
                                                      full.history)
    st0 = eng.init(b)
    x, r, p, dots = eng.kernel_c(st0.rz, st0.x, st0.r, st0.p)
    two = k3.FusedCG(eng.nx, eng.ny, eng.nz, eng.taps, coeffs=eng.coeffs)
    q, pq0, qq0 = two.kernel_a_reference(b)
    want = two.kernel_b_reference(st0.rz[0], pq0, qq0, st0.x, b, b, q)
    for got, ref in zip((x, r, p, dots[0], dots[1]), want):
        assert torch.equal(got, ref)


def test_onepass_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="constant-coefficient"):
        k6.OnePassCG(8, 8, 8, ((0, 0, 0), (0, 0, 1), (0, 0, -1)),
                     coeffs=(1.0, None, None))
    with pytest.raises(ValueError, match="float32"):
        build_fused(cgx_torch.poisson3d_stencil(4, 4, 4), torch.bfloat16,
                    one_pass=True)
    with pytest.raises(ValueError, match="unsupported operator"):
        build_fused(cgx_torch.poisson3d_stencil(4, 4, 4).matvec,
                    torch.float32, one_pass=True)

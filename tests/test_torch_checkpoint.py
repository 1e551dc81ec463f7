"""Checkpoint and resume in the port (``cgx_torch.utils.checkpoint``,
``FusedCG.state_to_flat``/``state_from_flat``) against the JAX package.

The cases mirror ``tests/test_checkpoint.py`` on the same 8×7×6 and 2-D
Poisson operators, with the port on the CPU (each kernel backend through
its plain version).  Tolerances: a chunked solve equals the monolithic
solve of the same backend bit for bit (iterations and x); a resume from a
snapshot of an unscaled state equals the uninterrupted solve bit for bit,
and of a Jacobi-scaled state (the kernel backends on DIA) within 1e-5
relative and one iteration, since the file holds the unscaled state and
``e·(x/e)`` may move a last bit; a resume under another backend within
1e-4 of ``cg_solve`` (cgx's own tolerance); fp64 solves against cgx's
equal iterations and x within 1e-12 relative.  Snapshots cross between the packages in both
directions, bf16 fields included.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cgx_torch
from cgx_torch.io.poisson import poisson2d, poisson3d_dia
from cgx_torch.kernels.fused_dia_cg import fused_dia_cg
from cgx_torch.kernels.fused_cg import build_fused, fused_stencil_cg
from cgx_torch.kernels.fused_resident import (resident_dia_cg,
                                              resident_stencil_cg)
from cgx_torch.kernels.fused_semiresident import sr_dia_cg, sr_stencil_cg
from cgx_torch.solve.cg import cg_chunk, cg_init, cg_solve
from cgx_torch.solve.precond import JacobiPrecond
from cgx_torch.sparse.stencil import poisson3d_stencil
from cgx_torch.utils.checkpoint import (cg_solve_checkpointed, load_state,
                                        make_checkpointed_solver,
                                        save_state)
from torch_parity import n_, t

CPU = "cpu"
N3 = 8 * 7 * 6


class Preempt(Exception):
    pass


def _killer(after: int):
    """An ``on_chunk`` that raises after ``after`` chunks."""
    seen = []

    def hook(state):
        seen.append(int(state.k))
        if len(seen) == after:
            raise Preempt
    return hook


def _preempt(a, b, ckpt, after, **kw):
    with pytest.raises(Preempt):
        cg_solve_checkpointed(a, b, checkpoint_path=ckpt,
                              on_chunk=_killer(after), **kw)
    assert os.path.exists(ckpt)


def _rhs(rng, n, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(n)).to(dtype)


def _operator(kind):
    """The 8×7×6 operator of a kernel backend and its preconditioner."""
    if kind == "stencil":
        return poisson3d_stencil(8, 7, 6), None
    a = poisson3d_dia(8, 7, 6, dtype=np.float32, device=CPU)
    return a, JacobiPrecond.from_matrix(a)


def _same(res, ref):
    assert int(res.iterations) == int(ref.iterations)
    assert torch.equal(res.x, ref.x)


# -- the "xla" backend -------------------------------------------------------

def test_chunked_matches_monolithic(rng):
    import cgx.solve.cg as jcg
    from cgx.io.poisson import poisson2d as j_poisson2d

    a = poisson2d(12, 12, device=CPU)
    bn = rng.standard_normal(144)
    b = t(bn)
    ref = cg_solve(a, b, tol=0.0, maxiter=40)
    state = cg_init(a, b)
    for _ in range(4):
        state = cg_chunk(a, state, 10)
    assert int(state.k) == 40
    assert torch.equal(state.x, ref.x)
    ref_j = jcg.cg_solve(j_poisson2d(12, 12), jnp.asarray(bn), tol=0.0,
                         maxiter=40)
    np.testing.assert_allclose(n_(state.x), np.asarray(ref_j.x),
                               rtol=1e-12, atol=1e-14)


def test_snapshot_roundtrip(tmp_path, rng):
    a = poisson2d(10, 10, device=CPU)
    b = t(rng.standard_normal(100))
    state = cg_chunk(a, cg_init(a, b), 7)
    p = str(tmp_path / "snap.npz")
    save_state(p, state)
    back = load_state(p, device=CPU)
    for f in ("x", "r", "z", "p", "rz", "rr", "history"):
        assert torch.equal(getattr(state, f), getattr(back, f))
    assert int(back.k) == 7 and back.k.dtype == torch.int32
    # Written atomically: no temporary file is left beside it.
    assert os.listdir(tmp_path) == ["snap.npz"]


def test_resume_after_preemption_identical_trajectory(tmp_path, rng):
    """Kill and relaunch: the resumed solve is the uninterrupted one bit
    for bit, and cgx's within 1e-12 with the same count (fp64)."""
    from cgx.io.poisson import poisson2d as j_poisson2d
    from cgx.solve.precond import JacobiPrecond as JJacobi
    from cgx.utils.checkpoint import cg_solve_checkpointed as j_ckpt

    a = poisson2d(14, 14, device=CPU)
    bn = rng.standard_normal(196)
    b = t(bn)
    kw = dict(tol=1e-10, maxiter=400, preconditioner=JacobiPrecond
              .from_matrix(a), chunk=25)
    ref = cg_solve_checkpointed(a, b, **kw)
    ckpt = str(tmp_path / "cg.npz")
    _preempt(a, b, ckpt, 2, **kw)
    res = cg_solve_checkpointed(a, b, checkpoint_path=ckpt, **kw)
    assert bool(res.converged)
    _same(res, ref)
    aj = j_poisson2d(14, 14)
    ref_j = j_ckpt(aj, jnp.asarray(bn), tol=1e-10, maxiter=400,
                   preconditioner=JJacobi.from_matrix(aj), chunk=25)
    assert int(res.iterations) == int(ref_j.iterations)
    np.testing.assert_allclose(n_(res.x), np.asarray(ref_j.x), rtol=1e-12,
                               atol=1e-14)


def test_chunk_respects_maxiter(rng):
    a = poisson2d(8, 8, device=CPU)
    b = t(rng.standard_normal(64))
    res = cg_solve_checkpointed(a, b, tol=0.0, maxiter=33, chunk=10)
    assert int(res.iterations) == 33


def test_chunk_early_exit_on_tol(rng):
    a = poisson2d(8, 8, device=CPU)
    b = t(rng.standard_normal(64))
    state = cg_chunk(a, cg_init(a, b), 1000, b=b, tol=1e-10)
    assert int(state.k) == int(cg_solve(a, b, tol=1e-10,
                                        maxiter=1000).iterations)


def test_checkpointed_accepts_callable_matvec(rng):
    from conftest import random_spd_csr

    a = cgx_torch.csr_from_scipy(random_spd_csr(60, 0.1, rng), device=CPU)
    b = t(rng.standard_normal(60))
    res = cg_solve_checkpointed(lambda v: cgx_torch.spmv(a, v), b,
                                tol=1e-10, chunk=7, maxiter=200)
    ref = cg_solve(a, b, tol=1e-10, maxiter=200)
    assert bool(res.converged)
    _same(res, ref)


# -- the kernel backends -----------------------------------------------------

_MONO = {
    "fused": (fused_stencil_cg, fused_dia_cg),
    "resident": (resident_stencil_cg, resident_dia_cg),
    "sr": (sr_stencil_cg, sr_dia_cg),
}


@pytest.mark.parametrize("op_kind", ["stencil", "dia_jacobi"])
@pytest.mark.parametrize("backend", ["fused", "resident", "sr"])
def test_kernel_resume_after_preemption_identical_trajectory(
        tmp_path, rng, backend, op_kind):
    """Each kernel backend: the chunked solve is its monolithic solve bit
    for bit; a solve killed after two chunks and relaunched from its file
    lands on the uninterrupted one."""
    a, m = _operator(op_kind)
    b = _rhs(rng, N3)
    kw = dict(tol=1e-6, maxiter=400, preconditioner=m, chunk=25,
              backend=backend)
    ref = cg_solve_checkpointed(a, b, **kw)
    assert bool(ref.converged)
    mono = _MONO[backend][op_kind != "stencil"](a, b, tol=1e-6,
                                                maxiter=400)
    _same(ref, mono)

    ckpt = str(tmp_path / f"{backend}.npz")
    _preempt(a, b, ckpt, 2, **kw)
    res = cg_solve_checkpointed(a, b, checkpoint_path=ckpt, **kw)
    assert bool(res.converged)
    if op_kind != "stencil":
        # The file holds the unscaled state: e·(x̃/e) may move a last bit.
        assert abs(int(res.iterations) - int(ref.iterations)) <= 1
        np.testing.assert_allclose(n_(res.x), n_(ref.x), rtol=1e-5,
                                   atol=1e-6)
    else:
        _same(res, ref)


@pytest.mark.parametrize("backend", ["fused", "resident", "sr"])
def test_checkpoint_cross_backend_resume(tmp_path, rng, backend):
    """A snapshot of a kernel backend resumes under "xla", and an "xla"
    snapshot under the kernel backend; both land on cg_solve's answer."""
    a, m = _operator("dia_jacobi")
    b = _rhs(rng, N3)
    kw = dict(tol=1e-6, maxiter=400, preconditioner=m, chunk=20)
    ref = cg_solve(a, b, tol=1e-6, maxiter=400, preconditioner=m)
    for first, then in ((backend, "xla"), ("xla", backend)):
        ckpt = str(tmp_path / f"{first}_{then}.npz")
        _preempt(a, b, ckpt, 1, backend=first, **kw)
        res = cg_solve_checkpointed(a, b, checkpoint_path=ckpt,
                                    backend=then, **kw)
        assert bool(res.converged), (first, then)
        np.testing.assert_allclose(n_(res.x), n_(ref.x), rtol=1e-4,
                                   atol=1e-5)


def test_sr_checkpointed_with_initial_guess(rng):
    """x0 folds as r₀ = b − A·x0, the threshold on the original ‖b‖."""
    a = poisson3d_dia(8, 7, 6, dtype=np.float32, device=CPU)
    b = _rhs(rng, N3)
    x0 = _rhs(rng, N3) * 0.1
    res = cg_solve_checkpointed(a, b, x0, tol=1e-6, maxiter=400, chunk=25,
                                backend="sr")
    ref = cg_solve(a, b, x0, tol=1e-6, maxiter=400)
    assert bool(res.converged)
    np.testing.assert_allclose(n_(res.x), n_(ref.x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["resident", "sr"])
def test_whole_solve_maxiter_zero_reports_unconverged(rng, backend):
    """maxiter=0 on a fresh solve reports the TRUE initial residual, not
    convergence faked by the all-zero seed."""
    a = poisson3d_dia(8, 7, 6, dtype=np.float32, device=CPU)
    b = _rhs(rng, N3)
    res = cg_solve_checkpointed(a, b, tol=1e-6, maxiter=0, chunk=25,
                                backend=backend)
    assert not bool(res.converged)
    assert int(res.iterations) == 0
    np.testing.assert_allclose(float(res.residual_norm_sq),
                               float(torch.sum(b * b)), rtol=1e-5)


def test_fused_state_flat_round_trip(rng):
    """state_to_flat / state_from_flat: the identity on an unscaled state,
    and the unscaled form (x = e·x̃, r = r̃/e, z = e·r̃) of a scaled one."""
    from cgx_torch.kernels.fused_dia_cg import build_fused_dia

    s = poisson3d_stencil(8, 7, 6)
    eng = build_fused(s, torch.float32)
    b = _rhs(rng, N3)
    st = eng.run(eng.init(b), 9, torch.tensor(0.0))
    back = eng.state_from_flat(eng.state_to_flat(st))
    for f in ("x", "r", "p", "rz", "k"):
        assert torch.equal(getattr(back, f), getattr(st, f))

    a, m = _operator("dia_jacobi")
    eng, e, _ = build_fused_dia(a, torch.float32, inv_diag=m.inv_diag)
    st = eng.run(eng.init(e * b), 9, torch.tensor(0.0))
    flat = eng.state_to_flat(st, e)
    assert torch.equal(flat.x, e * st.x) and torch.equal(flat.z, e * st.r)
    assert torch.equal(flat.rz, st.rz[0]) and torch.equal(flat.rr, st.rz[1])
    back = eng.state_from_flat(flat, e)
    np.testing.assert_allclose(n_(back.x), n_(st.x), rtol=1e-6)


def test_wbell_checkpointed_default_maxiter(rng):
    """An internal-layout b (WBELL's (nt, 8, 128)): the default maxiter
    counts elements, not the tile count."""
    import scipy.sparse as sp

    from cgx_torch.sparse.wbell import wbell_from_csr

    a_sp = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(300, 300),
                    format="csr", dtype=np.float64)
    wb = wbell_from_csr(a_sp, device=CPU)
    assert wb.nt < 50
    b = _rhs(rng, 300)
    res = make_checkpointed_solver(wb, tol=1e-5, chunk=50)(
        wb.to_internal(b))
    assert bool(res.converged)
    assert int(res.iterations) > wb.nt


def test_wbell_checkpointed_precond_specs(rng):
    """("poly", steps) and WBellBlockJacobiPrecond through the chunked
    solver follow wbell_cg_solve's trajectory."""
    import scipy.sparse as sp

    from cgx_torch.solve.wbell import (WBellBlockJacobiPrecond,
                                       wbell_cg_solve)
    from cgx_torch.sparse.wbell import wbell_from_csr

    a = sp.random(600, 600, density=0.02, random_state=3, format="csr")
    a = sp.csr_matrix((a + a.T) + sp.eye(600) * 14.0)
    wb = wbell_from_csr(a, device=CPU)
    b = _rhs(rng, 600)
    for spec, pre in ((("poly", 3), "poly"),
                      (None, WBellBlockJacobiPrecond.from_wbell(wb))):
        ref = wbell_cg_solve(wb, b, tol=1e-6, maxiter=500, precond=pre)
        res = make_checkpointed_solver(
            wb, tol=1e-6, maxiter=500, chunk=20,
            preconditioner=spec if spec else pre)(wb.to_internal(b))
        assert bool(res.converged)
        assert int(res.iterations) == int(ref.iterations)
        assert torch.equal(wb.from_internal(res.x), ref.x)


# -- snapshots across the packages -----------------------------------------

def test_cgx_snapshot_resumed_by_port(tmp_path, rng):
    """cgx writes the snapshot (fp64, Jacobi, chunk 25); the port resumes
    it and lands on the uninterrupted solve: cgx's count, x within 1e-12."""
    from cgx.io.poisson import poisson2d as j_poisson2d
    from cgx.solve.precond import JacobiPrecond as JJacobi
    from cgx.utils.checkpoint import cg_solve_checkpointed as j_ckpt

    bn = rng.standard_normal(196)
    aj = j_poisson2d(14, 14)
    kwj = dict(tol=1e-10, maxiter=400, chunk=25,
               preconditioner=JJacobi.from_matrix(aj))
    ref_j = j_ckpt(aj, jnp.asarray(bn), **kwj)
    ckpt = str(tmp_path / "from_cgx.npz")
    with pytest.raises(Preempt):
        j_ckpt(aj, jnp.asarray(bn), checkpoint_path=ckpt,
               on_chunk=_killer(2), **kwj)
    a = poisson2d(14, 14, device=CPU)
    st = load_state(ckpt, device=CPU)
    assert int(st.k) == 50 and st.x.dtype == torch.float64
    res = cg_solve_checkpointed(a, t(bn), tol=1e-10, maxiter=400, chunk=25,
                                preconditioner=JacobiPrecond.from_matrix(a),
                                checkpoint_path=ckpt)
    assert int(res.iterations) == int(ref_j.iterations)
    np.testing.assert_allclose(n_(res.x), np.asarray(ref_j.x), rtol=1e-12,
                               atol=1e-14)


def test_port_snapshot_resumed_by_cgx(tmp_path, rng):
    """The port writes the snapshot (K4's plain version, DIA Jacobi, fp32);
    cgx resumes it under "xla" and lands within 1e-4 of its cg_solve."""
    import cgx.solve.cg as jcg
    from cgx.io.poisson import poisson3d_dia as j_poisson3d_dia
    from cgx.solve.precond import JacobiPrecond as JJacobi
    from cgx.utils.checkpoint import cg_solve_checkpointed as j_ckpt
    from cgx.utils.checkpoint import load_state as j_load

    a, m = _operator("dia_jacobi")
    bn = rng.standard_normal(N3).astype(np.float32)
    ckpt = str(tmp_path / "from_port.npz")
    _preempt(a, torch.from_numpy(bn), ckpt, 1, tol=1e-6, maxiter=400,
             preconditioner=m, chunk=20, backend="sr")
    st = j_load(ckpt)
    assert int(st.k) == 20 and st.x.dtype == jnp.float32
    aj = j_poisson3d_dia(8, 7, 6, dtype=np.float32)
    mj = JJacobi.from_matrix(aj)
    res = j_ckpt(aj, jnp.asarray(bn), tol=1e-6, maxiter=400,
                 preconditioner=mj, chunk=20, checkpoint_path=ckpt)
    ref = jcg.cg_solve(aj, jnp.asarray(bn), tol=1e-6, maxiter=400,
                       preconditioner=mj)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-4, atol=1e-5)


def test_bf16_snapshot_fields_cross(tmp_path, rng):
    """cgx writes bf16 fields through ml_dtypes (raw |V2 in the file): the
    port reads their bits exactly.  The port writes bf16 as fp32: cgx
    reads it back to the same values."""
    from cgx.solve.cg import CGState as JState
    from cgx.utils.checkpoint import load_state as j_load
    from cgx.utils.checkpoint import save_state as j_save
    from cgx_torch.solve.cg import CGState

    vec = rng.standard_normal(64).astype(np.float32)
    bf = jnp.asarray(vec, jnp.bfloat16)
    js = JState(x=bf, r=bf * 2, z=bf, p=bf * 3, rz=bf[0], rr=bf[1],
                k=jnp.int32(5), history=jnp.zeros((0,), jnp.bfloat16))
    p1 = str(tmp_path / "cgx_bf16.npz")
    j_save(p1, js)
    with np.load(p1) as z:
        assert z["x"].dtype.kind == "V"
    st = load_state(p1, device=CPU)
    assert st.x.dtype == torch.bfloat16
    np.testing.assert_array_equal(n_(st.p.float()),
                                  np.asarray(js.p, np.float32))
    assert int(st.k) == 5

    p2 = str(tmp_path / "port_bf16.npz")
    save_state(p2, CGState(**{f: getattr(st, f) for f in
                              ("x", "r", "z", "p", "rz", "rr", "k",
                               "history")}))
    back = j_load(p2)
    assert back.x.dtype == jnp.float32
    np.testing.assert_array_equal(
        np.asarray(back.x).astype(np.float32),
        np.asarray(js.x, np.float32))
    assert torch.equal(torch.from_numpy(np.array(back.r)).to(
        torch.bfloat16), st.r)


def test_state_from_cgx_resumes(rng):
    """A cgx CGState carried by interop continues through the port's
    cg_chunk to the port's monolithic solve (fp64, bit for bit from the
    carried state's own trajectory)."""
    import cgx.solve.cg as jcg
    from cgx.io.poisson import poisson2d as j_poisson2d
    from cgx_torch.interop import state_from_cgx

    bn = rng.standard_normal(100)
    aj = j_poisson2d(10, 10)
    sj = jcg.cg_chunk(aj, jcg.cg_init(aj, jnp.asarray(bn)), 6)
    st = state_from_cgx(sj, device=CPU)
    assert int(st.k) == 6
    a = poisson2d(10, 10, device=CPU)
    done = cg_chunk(a, st, 1000, b=t(bn), tol=1e-10)
    ref = jcg.cg_chunk(aj, sj, 1000, b=jnp.asarray(bn), tol=1e-10)
    assert int(done.k) == int(ref.k)
    np.testing.assert_allclose(n_(done.x), np.asarray(ref.x), rtol=1e-12,
                               atol=1e-14)

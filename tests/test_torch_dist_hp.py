"""The port's distributed df64 refinement against cgx.dist.hp.

``run_spmd`` spawns P = 2 and P = 4 gloo ranks once for the module and
each rank runs every case of :func:`_worker`; the tests hold what the
ranks return against ``cgx.dist.hp`` on a P-device mesh of the test
process's virtual CPU devices, both fed the same numpy inputs (the fp32
inners through K7's and K8's plain versions on the CPU).  Workers are
unpickled by name in the spawned children, so this module imports
``cgx`` (and JAX) only inside test functions and fixtures; each worker
checks that no JAX is loaded.

Tolerances: the sharded df64 true residual's slabs (hi and lo words)
equal cgx's bit for bit, its global ‖r‖² too at P = 2 (a sum of two
partials is the same either way) and within 4 ulp at P = 4 (the ranks'
partials are added in another order); the refinements reach a TRUE
relres ≤ tol computed in fp64 on the host, with cgx's outer cycle count
within 1.  The chunked multi-RHS refinement, which cgx cannot run (its
``inner_chunk`` passes an ``x0`` its inner does not take), is held
against the port's unchunked one.
"""
import sys

import numpy as np
import pytest

N = 2200
K = 3
SEED = 5


def _matrix(n=N):
    """cgx's κ ≥ 1e7 test system: its distributed WBELL test matrix, scaled
    D·A·D with D = logspace(0, 3.5)."""
    import scipy.sparse as sp
    a = sp.random(n, n, density=0.004, random_state=3, format="csr")
    a = sp.csr_matrix((a + a.T) + sp.eye(n) * (2.0 + 0.004 * n))
    d = sp.diags(np.logspace(0, 3.5, n))
    a = sp.csr_matrix(d @ a @ d)
    a.sort_indices()
    return a


def _inputs():
    rng = np.random.default_rng(SEED)
    return {"b": rng.standard_normal(N), "b2": rng.standard_normal(N),
            "B": rng.standard_normal((N, K)),
            "x": rng.standard_normal(N) * 1e-3,
            "X": rng.standard_normal((N, K)) * 1e-3}


def _words(v):
    hi = v.astype(np.float32)
    return hi, (v - hi.astype(np.float64)).astype(np.float32)


def _worker(mesh, inputs):
    """Every case of the module on one rank; returns plain numpy data."""
    assert "jax" not in sys.modules
    import torch

    from cgx_torch.dist import halo
    from cgx_torch.dist import hp as dhp
    from cgx_torch.dist import wbell as dw
    from cgx_torch.ops.df64 import DF64, df_to_f64

    rank = mesh.rank
    out = {}
    a = _matrix()

    def counted(fn):
        halo.reset_counters()
        res = fn()
        return res, halo.counters()

    solver = dhp.make_dist_ir_df64_solver(a, mesh, tol=1e-6, inner_tol=1e-2,
                                          inner_maxiter=3000)
    part, opd = solver.partition, solver.df64_operator
    out["geometry"] = (opd.rows_per_shard, opd.halo_lo, opd.halo_hi,
                       opd.width)
    out["opd"] = {f: getattr(opd, f) for f in ("vhi", "vlo", "cols")}

    # The sharded true residual, one column and k.
    loc = opd.local(rank, "cpu")
    slab = {}
    for key in ("b", "x"):
        slab[key] = dhp._split(part, inputs[key], mesh)
    (rh, rl, rr), c = counted(lambda: dhp._local_true_residual(
        loc, *slab["b"], *slab["x"], mesh))
    out["residual"] = (rh.numpy(), rl.numpy(), rr.numpy(), c)
    bk = dhp._split(part, inputs["B"], mesh)
    xk = dhp._split(part, inputs["X"], mesh)
    rh, rl, rr = dhp._local_true_residual_multi(loc, *bk, *xk, mesh)
    out["residual_multi"] = (rh.numpy(), rl.numpy(), rr.numpy())

    # The fp32 distributed solve alone: its recurrence converges, its TRUE
    # residual does not reach tol (why the df64 outer exists).
    b = inputs["b"]
    r32 = dw.dist_wbell_cg_solve(part, b.astype(np.float32), mesh, tol=1e-6,
                                 maxiter=4000, preconditioner="jacobi")
    out["fp32"] = (r32.x.numpy(), bool(r32.converged))

    def refine(key, solve, *args, **kw):
        (res, info), c = counted(lambda: solve(*args, **kw))
        out[key] = {"x": df_to_f64(res.x), "info": info, "counts": c,
                    "conv": res.converged.numpy(), "hi": res.x.hi.numpy(),
                    "lo": res.x.lo.numpy()}

    refine("ir", solver, b)
    refine("ir_b2", solver, inputs["b2"])
    refine("per_shard", dhp.make_dist_ir_df64_solver(
        a, mesh, tol=1e-6, inner_tol=1e-2, inner_maxiter=3000,
        per_shard=True), b)
    refine("chunk", dhp.dist_ir_df64_solve, a, b, mesh, tol=1e-6,
           inner_tol=1e-2, inner_maxiter=3000, inner_chunk=7)

    # Preempted and resumed, at tol 1e-8.
    tight = dhp.make_dist_ir_df64_solver(a, mesh, tol=1e-8, inner_tol=1e-2,
                                         inner_maxiter=3000)
    refine("full", tight, b)
    half = dhp.make_dist_ir_df64_solver(
        a, mesh, tol=1e-8, inner_tol=1e-2, inner_maxiter=3000,
        max_outer=max(1, out["full"]["info"]["outer"] // 2))(b)[0]
    x0 = DF64(torch.from_numpy(half.x.hi.numpy()),
              torch.from_numpy(half.x.lo.numpy()))
    refine("resumed", tight, b, x0=x0)

    # The multi-RHS refinement, unchunked and chunked.
    B = inputs["B"]
    refine("multi", dhp.dist_ir_df64_solve_multi, a, B, mesh, tol=1e-6,
           inner_tol=1e-2, inner_maxiter=3000)
    refine("multi_chunk", dhp.dist_ir_df64_solve_multi, a, B, mesh,
           tol=1e-6, inner_tol=1e-2, inner_maxiter=3000, inner_chunk=7)
    out["jax_loaded"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def ranks():
    """``{P: [rank 0's results, ...]}`` for P = 2 and 4 (one spawn each)."""
    from cgx_torch.dist import run_spmd

    inputs = _inputs()
    return {P: run_spmd(_worker, P, inputs) for P in (2, 4)}


@pytest.fixture(scope="module")
def cgx_side():
    """cgx's ``make_row_mesh(P)`` sub-meshes, partitions and df64 ELLs."""
    from cgx.dist.hp import partition_df64_ell
    from cgx.dist.solve import make_row_mesh
    from cgx.dist.wbell import partition_wbell

    a = _matrix()
    parts = {P: partition_wbell(a, P) for P in (2, 4)}
    return {"a": a, "mesh": {P: make_row_mesh(P) for P in (2, 4)},
            "part": parts,
            "opd": {P: partition_df64_ell(a, parts[P]) for P in (2, 4)}}


def _relres(a, x, b):
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


@pytest.mark.parametrize("P", [2, 4])
def test_partition_df64_ell_equals_cgx(ranks, cgx_side, P):
    """The sharded df64 ELL (words, local columns, halos in entries) is
    cgx's array for array."""
    theirs = cgx_side["opd"][P]
    out = ranks[P][0]
    assert out["geometry"] == (theirs.rows_per_shard, theirs.halo_lo,
                               theirs.halo_hi, theirs.width)
    for f, v in out["opd"].items():
        np.testing.assert_array_equal(v, np.asarray(getattr(theirs, f)),
                                      err_msg=f)


def _cgx_residual(cgx_side, P, multi):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as Pspec

    from cgx.dist.hp import _cached_residual, _cached_residual_multi

    mesh, part, opd = (cgx_side["mesh"][P], cgx_side["part"][P],
                       cgx_side["opd"][P])
    inp = _inputs()
    specs = jax.tree.map(lambda _: Pspec("rows"), opd)
    opd_dev = jax.device_put(opd, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda v: isinstance(v, Pspec)))
    if multi:
        vec = NamedSharding(mesh, Pspec(None, "rows"))
        f = _cached_residual_multi(mesh, specs)

        def put(m):
            return jax.device_put(jnp.stack([part.to_internal(
                jnp.asarray(m[:, j])) for j in range(m.shape[1])]), vec)
        words = _words(inp["B"]) + _words(inp["X"])
    else:
        vec = NamedSharding(mesh, Pspec("rows"))
        f = _cached_residual(mesh, specs)

        def put(v):
            return jax.device_put(part.to_internal(jnp.asarray(v)), vec)
        words = _words(inp["b"]) + _words(inp["x"])
    rh, rl, rr = f(opd_dev, *(put(w) for w in words))
    return np.asarray(rh), np.asarray(rl), np.asarray(rr), part.gs


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("multi", [False, True])
def test_true_residual_equals_cgx(ranks, cgx_side, P, multi):
    """Each rank's df64 residual slab (hi and lo) equals cgx's
    ``_local_true_residual`` (or ``_multi``) bit for bit; the global ‖r‖²
    too at P = 2, within 4 ulp at P = 4.  The step moved x's words in one
    ring exchange, reduced once and gathered nothing."""
    rh, rl, rr, gs = _cgx_residual(cgx_side, P, multi)
    for r in range(P):
        out = ranks[P][r]["residual_multi" if multi else "residual"]
        sl = np.s_[:, r * gs:(r + 1) * gs] if multi else np.s_[
            r * gs:(r + 1) * gs]
        np.testing.assert_array_equal(out[0], rh[sl])
        np.testing.assert_array_equal(out[1], rl[sl])
        if P == 2:
            np.testing.assert_array_equal(out[2], rr)
        else:
            np.testing.assert_array_max_ulp(out[2], rr.astype(np.float32),
                                            maxulp=4)
        if not multi:
            c = out[3]
            assert c["all_reduces"] == 1 and c["all_gathers"] == 0
            assert c["sends"] == c["recvs"] > 0


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ir_df64_reaches_true_tol(ranks, cgx_side, P):
    """The fp32 distributed solve's recurrence converges while its TRUE
    residual misses 1e-6; the df64 refinement over it reaches TRUE relres
    ≤ 1.5e-6 for two right-hand sides, with cgx's outer cycle count within
    1 (cgx on 4 shards)."""
    from cgx.dist.hp import dist_ir_df64_solve

    a = cgx_side["a"]
    inp = _inputs()
    out = ranks[P][0]
    x32, conv32 = out["fp32"]
    assert conv32 and _relres(a, x32, inp["b"]) > 1e-6
    if "ir" not in cgx_side:
        cgx_side["ir"] = dist_ir_df64_solve(
            a, inp["b"], cgx_side["mesh"][4], tol=1e-6, inner_tol=1e-2,
            inner_maxiter=3000)[1]
    info_ref = cgx_side["ir"]
    for key, b in (("ir", inp["b"]), ("ir_b2", inp["b2"])):
        res = out[key]
        assert res["conv"]
        assert _relres(a, res["x"], b) <= 1.5e-6, res["info"]
        assert res["info"]["n_shards"] == P and res["info"]["n"] == N
    assert abs(out["ir"]["info"]["outer"] - info_ref["outer"]) <= 1
    for r in range(P):
        np.testing.assert_array_equal(ranks[P][r]["ir"]["hi"],
                                      out["ir"]["hi"])


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ir_df64_collectives(ranks, P):
    """A refinement gathers once (both words of the answer, at the end);
    each cycle's residual and inner loop reduce but never gather."""
    for r in range(P):
        c = ranks[P][r]["ir"]["counts"]
        assert c["all_gathers"] == 1
        assert c["all_reduces"] > 0 and c["sends"] > 0


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ir_df64_per_shard_build(ranks, cgx_side, P):
    """Over the per-shard WBELL build the refinement reaches the same bar
    with the global build's outer count within 1."""
    out = ranks[P][0]
    assert abs(out["per_shard"]["info"]["outer"]
               - out["ir"]["info"]["outer"]) <= 1
    assert _relres(cgx_side["a"], out["per_shard"]["x"],
                   _inputs()["b"]) <= 1.5e-6


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ir_df64_inner_chunk_restart(ranks, cgx_side, P):
    """Inner calls of at most 7 iterations, each restarted from its
    iterate, still bring the TRUE residual to 1.5e-6."""
    res = ranks[P][0]["chunk"]
    assert _relres(cgx_side["a"], res["x"], _inputs()["b"]) <= 1.5e-6


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ir_df64_resume_from_iterate(ranks, cgx_side, P):
    """A refinement stopped at half its cycles and resumed from its df64
    iterate finishes in fewer cycles, to TRUE relres ≤ 1.5e-8."""
    out = ranks[P][0]
    full, res = out["full"], out["resumed"]
    assert full["conv"] and res["conv"]
    assert res["info"]["outer"] < full["info"]["outer"] \
        or full["info"]["outer"] <= 1
    assert _relres(cgx_side["a"], res["x"], _inputs()["b"]) <= 1.5e-8


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ir_df64_multi_reaches_true_tol(ranks, cgx_side, P):
    """The block of 3 right-hand sides: every column to TRUE relres ≤
    1.5e-6, with cgx's outer count within 1 (cgx on 4 shards)."""
    from cgx.dist.hp import dist_ir_df64_solve_multi

    a, B = cgx_side["a"], _inputs()["B"]
    if "multi" not in cgx_side:
        cgx_side["multi"] = dist_ir_df64_solve_multi(
            a, B, cgx_side["mesh"][4], tol=1e-6, inner_tol=1e-2,
            inner_maxiter=3000)[1]
    info_ref = cgx_side["multi"]
    res = ranks[P][0]["multi"]
    assert res["conv"].all(), res["info"]
    for j in range(K):
        assert _relres(a, res["x"][:, j], B[:, j]) <= 1.5e-6
    assert res["info"]["n_shards"] == P
    assert abs(res["info"]["outer"] - info_ref["outer"]) <= 1


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ir_df64_multi_chunked_against_unchunked(ranks, cgx_side, P):
    """The chunked multi-RHS refinement (warm-restarted inners of 7
    iterations) reaches the unchunked one's bar on every column, and the
    two answers agree to what that bar allows through κ."""
    a, B = cgx_side["a"], _inputs()["B"]
    out = ranks[P][0]
    whole, chunked = out["multi"], out["multi_chunk"]
    assert chunked["conv"].all(), chunked["info"]
    for j in range(K):
        assert _relres(a, chunked["x"][:, j], B[:, j]) <= 1.5e-6
        xs = whole["x"][:, j]
        assert np.linalg.norm(chunked["x"][:, j] - xs) \
            / np.linalg.norm(xs) < 1e-2


def test_workers_loaded_no_jax(ranks):
    for P, outs in ranks.items():
        assert not any(o["jax_loaded"] for o in outs), P

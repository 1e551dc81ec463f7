"""The port's row-partitioned WBELL solves against cgx.dist.wbell: the
four shard-local preconditioners, the four methods, the collectives in
the loop and the restart from a snapshot.

``run_spmd`` spawns P = 2 and P = 4 gloo ranks once for the module and
each rank runs every solve of :func:`_worker` (K7 takes its plain version
on the CPU, over each shard's row layout); the tests hold them against
``cgx.dist.wbell``'s solves on a 4-device mesh of the test process's
virtual CPU devices (its kernels in interpret mode), both fed the same
numpy inputs (:mod:`torch_dist_wbell_cases`).  The partition, the shard
products and the multi-RHS solves are in ``tests/test_torch_dist_wbell.py``.

Tolerances: cgx's iteration counts within 2, x within 1e-4 relative in
fp32, each solution's true residual at cgx's test bar.  Collective counts
replace cgx's checks of the compiled HLO.
"""
import sys

import numpy as np
import pytest

from torch_dist_wbell_cases import (METHODS, N_METHODS, PRECONDS, cached,
                                    counted, inputs, matrix, rel, relres,
                                    spawn)


def _worker(mesh, data):
    """Every solve of the module on one rank; returns plain numpy data."""
    assert "jax" not in sys.modules
    import torch

    from cgx_torch.dist import wbell as dw
    from cgx_torch.sparse import wbell as sw

    out = {}
    a = matrix()
    part = dw.partition_wbell(a, mesh.size)
    out["geometry"] = {f: getattr(part, f) for f in (
        "gs", "halo_lo", "halo_hi")}
    sw.row_layout_builds = 0
    b = data["b"]

    def solve(key, **kw):
        res, c = counted(lambda: dw.dist_wbell_cg_solve(
            part, b, mesh, tol=1e-6, maxiter=600, **kw))
        out[key] = {"x": res.x.numpy(), "it": int(res.iterations),
                    "conv": bool(res.converged), "counts": c}

    for pre in PRECONDS:
        solve(f"pcg_{pre}", preconditioner=pre)
    out["builds_after_solves"] = sw.row_layout_builds

    # Inside the loop: no gather, two all-reduces an iteration.
    bi = part.to_internal(torch.from_numpy(b))
    res, c = counted(lambda: dw.dist_wbell_cg_solve_internal(
        part, bi, mesh, tol=1e-6, maxiter=600, preconditioner="jacobi"))
    out["internal"] = {"it": int(res.iterations), "counts": c}

    # The preemption story: stop early, resume from the iterate.
    full = out["pcg_jacobi"]
    half = dw.dist_wbell_cg_solve(part, b, mesh, tol=1e-6,
                                  maxiter=max(2, full["it"] // 2),
                                  preconditioner="jacobi")
    res = dw.dist_wbell_cg_solve(part, b, mesh, x0=half.x.numpy(), tol=1e-6,
                                 maxiter=600, preconditioner="jacobi")
    out["resumed"] = {"x": res.x.numpy(), "it": int(res.iterations),
                      "conv": bool(res.converged)}

    # The methods, on cgx's methods matrix.
    pm = dw.partition_wbell(matrix(N_METHODS), mesh.size)
    for method in METHODS:
        res, c = counted(lambda: dw.dist_wbell_cg_solve(
            pm, data["bm"], mesh, tol=1e-5, maxiter=800,
            preconditioner="jacobi", method=method))
        out[method] = {"x": res.x.numpy(), "it": int(res.iterations),
                       "conv": bool(res.converged), "counts": c}
    out["builds_at_end"] = sw.row_layout_builds
    out["jax_loaded"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def ranks():
    """``{P: [rank 0's results, ...]}`` for P = 2 and 4 (one spawn each)."""
    return spawn(_worker)


@pytest.fixture(scope="module")
def cgx_side():
    """cgx's 4-device mesh and partition, and a cache of its solves (each
    computed once for the module)."""
    from cgx.dist.wbell import partition_wbell

    from torch_dist_wbell_cases import cgx_mesh

    a = matrix()
    return {"mesh": {4: cgx_mesh(4)}, "part": {4: partition_wbell(a, 4)},
            "a": a, "cache": {}}


@pytest.mark.parametrize("P", [2, 4])
def test_solves_build_one_row_layout(ranks, P):
    """Four solves and the restart on one partition build its shard's row
    layout once, in the first solve; the methods' partition once more."""
    for r in range(P):
        out = ranks[P][r]
        assert out["builds_after_solves"] == 1
        assert out["builds_at_end"] == 2


def _cgx_pcg(cgx_side, pre):
    """cgx's 4-shard solve (the preconditioners do not depend on the
    partition; the ranks' dots round differently, hence the tolerance)."""
    import jax.numpy as jnp

    from cgx.dist.wbell import dist_wbell_cg_solve

    def run():
        res = dist_wbell_cg_solve(cgx_side["part"][4],
                                  jnp.asarray(inputs()["b"]),
                                  cgx_side["mesh"][4], tol=1e-6, maxiter=600,
                                  preconditioner=pre)
        return np.asarray(res.x), int(res.iterations), bool(res.converged)
    return cached(cgx_side["cache"], ("pcg", pre), run)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("pre", PRECONDS)
def test_dist_wbell_cg_matches_cgx(ranks, cgx_side, P, pre):
    """Each shard-local preconditioner: the iterations within 2 of cgx's,
    x within 1e-4, the true residual at cgx's bar (2e-6)."""
    x, it, conv = _cgx_pcg(cgx_side, pre)
    assert conv
    b = inputs()["b"]
    for r in range(P):
        out = ranks[P][r][f"pcg_{pre}"]
        assert out["conv"]
        assert abs(out["it"] - it) <= 2
        assert rel(out["x"], x) <= 1e-4
        assert relres(cgx_side["a"], out["x"], b) <= 2e-6
        np.testing.assert_array_equal(out["x"], ranks[P][0][f"pcg_{pre}"]["x"])


@pytest.mark.parametrize("P", [2, 4])
def test_dist_wbell_collectives(ranks, P):
    """The counts that replace cgx's HLO check: inside the loop one ring
    exchange a product and two all-reduces an iteration, never an
    all-gather; the standard-order solve gathers once, at its boundary."""
    from cgx_torch.dist.halo import _halo_messages

    for r in range(P):
        out = ranks[P][r]
        geo = out["geometry"]
        per_product = sum((r + shift) % P != r for _, shift, _, _ in
                          _halo_messages(geo["gs"], geo["halo_lo"],
                                         geo["halo_hi"]))
        inner = out["internal"]
        it = inner["it"]
        assert inner["counts"] == {"sends": per_product * it,
                                   "recvs": per_product * it,
                                   "all_reduces": 2 + 2 * it,
                                   "all_gathers": 0}
        assert per_product > 0
        c = out["pcg_jacobi"]["counts"]
        assert c["all_gathers"] == 1
        assert c["all_reduces"] == 2 + 2 * out["pcg_jacobi"]["it"]
        for method in METHODS:
            assert out[method]["counts"]["all_gathers"] == 1
        sr = out["single_reduction"]
        assert sr["counts"]["all_reduces"] == 2 + sr["it"]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("method", METHODS)
def test_dist_wbell_methods(ranks, cgx_side, P, method):
    """The single-reduction and pipelined loops against cgx's (iterations
    within 2, x within 1e-4); every method reaches cgx's test bar on the
    true residual (5e-5).  Chebyshev's start vector is the port's own draw
    (a generator seeded 0 over the global internal vector), so it is held
    to that bar alone, as cgx's test holds its own."""
    import jax.numpy as jnp

    from cgx.dist.wbell import dist_wbell_cg_solve, partition_wbell

    a = matrix(N_METHODS)
    b = inputs()["bm"]
    out = ranks[P][0][method]
    assert out["conv"]
    assert relres(a, out["x"], b) <= 5e-5
    if method == "chebyshev":
        return

    def run():
        res = dist_wbell_cg_solve(partition_wbell(a, 4), jnp.asarray(b),
                                  cgx_side["mesh"][4], tol=1e-5, maxiter=800,
                                  preconditioner="jacobi", method=method)
        return np.asarray(res.x), int(res.iterations)
    x, it = cached(cgx_side["cache"], ("method", method), run)
    assert abs(out["it"] - it) <= 2
    assert rel(out["x"], x) <= 1e-4


@pytest.mark.parametrize("P", [2, 4])
def test_dist_wbell_elastic_restart_from_snapshot(ranks, cgx_side, P):
    """A solve stopped at half its iterations and resumed from that iterate
    (``x0``) finishes in fewer iterations than from scratch, at the same
    bar."""
    out = ranks[P][0]
    res = out["resumed"]
    assert res["conv"]
    assert res["it"] < out["pcg_jacobi"]["it"]
    assert relres(cgx_side["a"], res["x"], inputs()["b"]) <= 2e-6


def test_workers_loaded_no_jax(ranks):
    for P, outs in ranks.items():
        assert not any(o["jax_loaded"] for o in outs), P

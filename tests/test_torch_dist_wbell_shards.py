"""The port's row-partitioned WBELL solve on uneven and degenerate shards
against cgx.dist.wbell.

``run_spmd`` spawns P = 2 and P = 4 gloo ranks once for the module; each
rank solves both matrices (K7's plain version on the CPU, over each
shard's row layout), and the tests hold the solutions against
``cgx.dist.wbell``'s on a 4-device mesh of the test process's virtual CPU
devices (its kernels in interpret mode), both fed the same numpy inputs
(:mod:`torch_dist_wbell_cases`).  9 groups put 5 and 4 groups on 2 shards
and 3, 3, 3 and 0 on 4 (uneven); 4 groups put one on each of 4 shards
(degenerate: the halos take several ring steps).

Tolerances: cgx's iteration counts within 2, x within 1e-4 relative in
fp32, the true residual at cgx's test bar.
"""
import sys

import numpy as np
import pytest

from torch_dist_wbell_cases import (SIZES, cached, inputs, matrix, rel,
                                    relres, spawn)


def _worker(mesh, data):
    """Both solves on one rank; returns plain numpy data."""
    assert "jax" not in sys.modules
    from cgx_torch.dist import wbell as dw

    out = {}
    for name, (n, dens, seed) in SIZES.items():
        pu = dw.partition_wbell(matrix(n, dens, seed), mesh.size)
        res = dw.dist_wbell_cg_solve(pu, data[name], mesh, tol=1e-6,
                                     maxiter=800, preconditioner="jacobi")
        out[name] = {"x": res.x.numpy(), "it": int(res.iterations),
                     "conv": bool(res.converged), "gs": pu.gs,
                     "halo": (pu.halo_lo, pu.halo_hi)}
    out["jax_loaded"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def ranks():
    """``{P: [rank 0's results, ...]}`` for P = 2 and 4 (one spawn each)."""
    return spawn(_worker)


@pytest.fixture(scope="module")
def cgx_side():
    """cgx's 4-device mesh and a cache of its solves."""
    from torch_dist_wbell_cases import cgx_mesh

    return {"mesh": {4: cgx_mesh(4)}, "cache": {}}


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_dist_wbell_uneven_and_degenerate_shards(ranks, cgx_side, P, name):
    """9 groups on 2 and 4 shards (uneven) and 4 groups on 4 shards of one
    group each (degenerate: halos of several ring steps) against cgx's
    4-shard solve: iterations within 2, x within 1e-4, the true residual
    at 2e-6."""
    import jax.numpy as jnp

    from cgx.dist.wbell import dist_wbell_cg_solve, partition_wbell

    n, dens, seed = SIZES[name]
    a = matrix(n, dens, seed)
    b = inputs()[name]

    def run():
        res = dist_wbell_cg_solve(partition_wbell(a, 4), jnp.asarray(b),
                                  cgx_side["mesh"][4], tol=1e-6, maxiter=800,
                                  preconditioner="jacobi")
        return np.asarray(res.x), int(res.iterations)
    x, it = cached(cgx_side["cache"], ("size", name), run)
    out = ranks[P][0][name]
    assert out["conv"]
    assert abs(out["it"] - it) <= 2
    assert rel(out["x"], x) <= 1e-4
    assert relres(a, out["x"], b) <= 2e-6
    if name == "degenerate" and P == 4:
        assert out["gs"] == 1 and max(out["halo"]) > 1


def test_workers_loaded_no_jax(ranks):
    for P, outs in ranks.items():
        assert not any(o["jax_loaded"] for o in outs), P

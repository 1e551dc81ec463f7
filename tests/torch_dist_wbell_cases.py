"""Shared inputs of the row-partitioned WBELL tests (not collected itself).

``tests/test_torch_dist_wbell.py`` (the partition, the shard products and
the multi-RHS solves), ``tests/test_torch_dist_wbell_solve.py`` (the
single-RHS solves: the preconditioners, the methods, the restart) and
``tests/test_torch_dist_wbell_shards.py`` (uneven and degenerate shards)
each spawn their own ranks, so ``--dist loadfile`` spreads them over the
workers.  The spawned children import this module by name, so it imports
numpy alone at module level: no JAX, no ``cgx``.
"""
import numpy as np

SEED = 42
N = 3000          # 3 groups: gs 2 at P = 2, 1 at P = 4 (one shard empty)
N_METHODS = 2200
SIZES = {"uneven": (9000, 0.002, 9000), "degenerate": (3500, 0.002, 3500)}
K = 3
PRECONDS = ("none", "jacobi", "block_jacobi", "poly")
METHODS = ("single_reduction", "pipelined", "chebyshev")


def matrix(n=N, density=0.004, seed=3):
    """cgx's distributed WBELL test matrix: a random symmetric pattern,
    diagonally dominant (scipy, fp64)."""
    import scipy.sparse as sp
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    a = sp.csr_matrix((a + a.T) + sp.eye(n) * (2.0 + density * n))
    a.sort_indices()
    return a


def inputs():
    rng = np.random.default_rng(SEED)
    f32 = np.float32
    return {
        "x": rng.standard_normal(N).astype(f32),
        "xk": rng.standard_normal((N, 4)).astype(f32),
        "b": rng.standard_normal(N).astype(f32),
        "bm": rng.standard_normal(N_METHODS).astype(f32),
        "bk": rng.standard_normal((N, K)).astype(f32),
        **{name: rng.standard_normal(n).astype(f32)
           for name, (n, _, _) in SIZES.items()},
    }


def counted(fn):
    """``(fn(), the collectives it made)``."""
    from cgx_torch.dist import halo

    halo.reset_counters()
    res = fn()
    return res, halo.counters()


def spawn(worker):
    """``{P: [rank 0's results, ...]}`` for P = 2 and 4 (one spawn each)."""
    from cgx_torch.dist import run_spmd

    data = inputs()
    return {P: run_spmd(worker, P, data) for P in (2, 4)}


def cgx_mesh(P):
    from cgx.dist.solve import make_row_mesh
    return make_row_mesh(P)


def cached(cache, key, fn):
    """cgx's solves are computed once for a module."""
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def relres(a, x, b):
    return np.linalg.norm(a @ np.asarray(x, np.float64) - b) \
        / np.linalg.norm(b)

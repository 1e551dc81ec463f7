"""The port's row-distributed solvers against cgx.dist.

The port runs in real processes: ``run_spmd`` spawns P = 2 and P = 4 gloo
ranks once for the module (a module-scoped fixture) and each rank runs
every case of :func:`_worker`; the tests compare what the ranks return
with ``cgx.dist`` on a sub-mesh of the test process's virtual CPU devices,
both fed the same numpy inputs, in fp64.  Workers are unpickled by name
in the spawned children, so this module imports ``cgx`` (and JAX) only
inside its test functions, and each worker checks that no JAX is loaded.

Tolerances are cgx's own for its distributed solves against one device:
x to ``rtol=1e-9, atol=1e-11`` in fp64 (reduction order only), iteration
counts within 2; the single-reduction and pipelined forms to ``rtol=1e-7``
(their recurrences round differently from CG's); the collective counts
exactly.
"""
import sys

import numpy as np
import pytest

N2D = (16, 16)          # the CG cases' 2-D Poisson grid (n = 256)
SEED = 42


def _inputs():
    rng = np.random.default_rng(SEED)
    return {
        "b": rng.standard_normal(N2D[0] * N2D[1]),
        "x260": rng.standard_normal(260),
        "x100": rng.standard_normal(100),
        "x384": rng.standard_normal(384),
    }


def _random_spd(n, density, seed):
    """A = B Bᵀ + n·I (scipy, host), as the suite's random_spd_csr."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    b = sp.random(n, n, density=density, random_state=np.random.RandomState(
        rng.integers(2**31)), dtype=np.float64)
    a = (b @ b.T).tocsr() + sp.identity(n, format="csr") * n
    a.sort_indices()
    return a


def _worker(mesh, inputs):
    """Every case of the module on one rank; returns plain numpy data."""
    assert "jax" not in sys.modules
    import torch

    from cgx_torch.dist import (dist_cg_solve, gather_rows, halo,
                                halo_exchange, local_matvec, partition_csr,
                                partition_dia)
    from cgx_torch.dist.schwarz import ic0_sweep_blocks, sweep_apply
    from cgx_torch.dist.solve import local_rows
    from cgx_torch.io.poisson import poisson2d, poisson2d_dia
    from cgx_torch.solve import cg as cg_mod
    from cgx_torch.sparse.types import csr_from_scipy

    P, rank = mesh.size, mesh.rank
    out = {}

    def counted(fn):
        halo.reset_counters()
        res = fn()
        return res, halo.counters()

    # The ring exchange: wrapped values, one step and several.
    xl = torch.arange(4.0 * P, dtype=torch.float64)[4 * rank:4 * rank + 4]
    out["halo"] = halo_exchange(xl, 2, 3, mesh).numpy()
    out["halo_wide"] = halo_exchange(xl, 7, 9, mesh).numpy()

    # Partitioned products.
    a = poisson2d(20, 13, device="cpu")
    for mode in ("halo", "allgather"):
        part = partition_csr(a, P, mode=mode)
        x = local_rows(inputs["x260"], mesh, part.rows_local)
        a_loc = part.local(rank, "cpu")
        y, c = counted(lambda: local_matvec(a_loc, x, mesh))
        y_flat = local_matvec(a_loc, x, mesh, overlap=False)
        out[f"ell_{mode}"] = gather_rows(y, mesh).numpy()
        out[f"ell_{mode}_counts"] = c
        out[f"ell_{mode}_overlap_same"] = bool(torch.equal(y, y_flat))
    gen = csr_from_scipy(_random_spd(100, 0.15, 7), device="cpu")
    part = partition_csr(gen, P, mode="auto")
    out["general_mode"] = part.mode
    y = local_matvec(part.local(rank, "cpu"),
                     local_rows(inputs["x100"], mesh, part.rows_local), mesh)
    out["general"] = gather_rows(y, mesh).numpy()
    d = poisson2d_dia(24, 16, device="cpu")
    part = partition_dia(d, P)
    y = local_matvec(part.local(rank, "cpu"),
                     local_rows(inputs["x384"], mesh, part.rows_local), mesh)
    out["dia"] = gather_rows(y, mesh).numpy()

    # dist_cg_solve: preconditioners and methods.
    b = inputs["b"]
    a_dia = poisson2d_dia(*N2D, device="cpu")
    p_dia = partition_dia(a_dia, P)
    p_csr = partition_csr(poisson2d(*N2D, device="cpu"), P)
    out["csr_mode"] = p_csr.mode

    def solve(key, part, **kw):
        rep0 = cg_mod.replacements
        res, c = counted(lambda: dist_cg_solve(part, b, mesh, **kw))
        out[key] = {"x": gather_rows(res.x, mesh).numpy(),
                    "it": int(res.iterations),
                    "conv": bool(res.converged),
                    "history": res.history.numpy(), "counts": c,
                    "replacements": cg_mod.replacements - rep0}

    for pre in ("none", "jacobi", "block_jacobi", "poly"):
        solve(f"pcg_{pre}", p_dia, tol=1e-10, maxiter=600,
              preconditioner=pre, blocksize=8, poly_steps=3)
    solve("pcg_csr_jacobi", p_csr, tol=1e-10, maxiter=600, jacobi=True)
    solve("ic0_sweep", p_dia, tol=1e-10, maxiter=400,
          preconditioner="ic0_sweep", nsweeps=1)
    solve("single_reduction", p_dia, tol=1e-10, maxiter=600,
          method="single_reduction")
    solve("pipelined", p_dia, tol=1e-10, maxiter=600, method="pipelined")
    solve("pipelined_adaptive", p_dia, tol=1e-10, maxiter=600,
          method="pipelined", adaptive_replace=True)
    solve("chebyshev", p_dia, tol=1e-8, maxiter=3000, method="chebyshev",
          lam_min=0.07, lam_max=8.0)
    solve("chebyshev_est", p_dia, tol=1e-8, maxiter=5000,
          method="chebyshev", preconditioner="jacobi")
    solve("history", p_dia, tol=0.0, maxiter=30, track_history=True)

    # The Schwarz apply makes no traffic.
    blocks = ic0_sweep_blocks(p_dia, shards=[rank]).local(rank, "cpu")
    r = local_rows(b, mesh, p_dia.rows_local)
    z, c = counted(lambda: sweep_apply(blocks, 2, r))
    out["sweep_counts"] = c
    out["sweep"] = gather_rows(z, mesh).numpy()

    # The 2 x 2 grid (four ranks only).
    if P == 4:
        from cgx_torch.dist.grid2d import (dist_cg_solve_2d, make_grid_mesh,
                                           matvec_2d, partition_csr_2d)
        grid = make_grid_mesh(2, device="cpu")
        a2 = poisson2d(14, 13, device="cpu")
        part2 = partition_csr_2d(a2, 2)
        rl2 = part2.rows_local
        xg = np.pad(inputs["x260"][:182], (0, part2.n_padded - 182))
        xb = torch.from_numpy(xg[grid.a * rl2:(grid.a + 1) * rl2].copy())
        out["grid_y"] = (grid.a, grid.b,
                         matvec_2d(part2.local(grid.a, grid.b, "cpu"), xb,
                                   grid).numpy())
        part_cg = partition_csr_2d(poisson2d(*N2D, device="cpu"), 2)
        for jac in (False, True):
            res = dist_cg_solve_2d(part_cg, b, grid, tol=1e-10, maxiter=600,
                                   jacobi=jac)
            out[f"grid_cg_{jac}"] = (grid.a, grid.b, res.x.numpy(),
                                     int(res.iterations),
                                     part_cg.rows_local)
    out["jax_loaded"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def ranks():
    """``{P: [rank 0's results, ...]}`` for P = 2 and 4 (one spawn each)."""
    from cgx_torch.dist import run_spmd

    inputs = _inputs()
    return {P: run_spmd(_worker, P, inputs) for P in (2, 4)}


@pytest.fixture(scope="module")
def cgx_ref():
    """cgx's side: ``make_row_mesh(P)`` sub-meshes."""
    from cgx.dist.solve import make_row_mesh

    return {P: make_row_mesh(P) for P in (2, 4)}


def _cgx_solve(P, meshes, part_fn, b, **kw):
    from cgx.dist.solve import dist_cg_solve
    import jax.numpy as jnp

    res = dist_cg_solve(part_fn(P), jnp.asarray(b), meshes[P], **kw)
    return np.asarray(res.x), int(res.iterations), np.asarray(res.history)


def _cgx_dia(P):
    from cgx.dist.partition import partition_dia
    from cgx.io.poisson import poisson2d_dia
    return partition_dia(poisson2d_dia(*N2D), P)


# -- the exchange and the products ------------------------------------------


def _ring_expected(P, rank, n_local, hl, hr):
    n = P * n_local
    lo = (rank * n_local - hl) % n
    left = [(lo + i) % n for i in range(hl)]
    mid = list(range(rank * n_local, (rank + 1) * n_local))
    right = [((rank + 1) * n_local + i) % n for i in range(hr)]
    return np.array(left + mid + right, dtype=float)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("key,hl,hr", [("halo", 2, 3), ("halo_wide", 7, 9)])
def test_halo_exchange_ring(ranks, cgx_ref, P, key, hl, hr):
    """Each rank sees its neighbours' entries at the right slots, wrapped
    as a ring (rank 0's left halo from the last rank), one ring step and
    several; cgx's exchange gives the same on its P-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec

    from cgx.dist.halo import halo_exchange

    f = jax.shard_map(lambda xl: halo_exchange(xl, hl, hr, "rows"),
                      mesh=cgx_ref[P], in_specs=Pspec("rows"),
                      out_specs=Pspec("rows"))
    theirs = np.asarray(f(jnp.arange(4.0 * P))).reshape(P, -1)
    for r in range(P):
        mine = ranks[P][r][key]
        np.testing.assert_array_equal(mine, _ring_expected(P, r, 4, hl, hr))
        np.testing.assert_array_equal(mine, theirs[r])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("mode", ["halo", "allgather"])
def test_partitioned_ell_matvec(ranks, P, mode):
    """Partitioned ELL products (halo and all-gather plans) equal cgx's
    global product; the overlapped halo product equals the plain one bit
    for bit; halo mode gathers nothing."""
    import jax.numpy as jnp

    from cgx.io.poisson import poisson2d
    from cgx.ops.spmv import spmv

    x = _inputs()["x260"]
    ref = np.asarray(spmv(poisson2d(20, 13), jnp.asarray(x)))
    for r in range(P):
        out = ranks[P][r]
        np.testing.assert_allclose(out[f"ell_{mode}"][:260], ref, rtol=1e-12,
                                   atol=1e-12)
        assert out[f"ell_{mode}_overlap_same"]
        counts = out[f"ell_{mode}_counts"]
        if mode == "halo":
            assert counts["all_gathers"] == 0
            assert counts["sends"] == counts["recvs"] == 2
        else:
            assert counts["all_gathers"] == 1 and counts["sends"] == 0


@pytest.mark.parametrize("P", [2, 4])
def test_partitioned_general_and_dia(ranks, P):
    """A dense-ish pattern picks all-gather; DIA partitions halo; both
    products equal the global ones (cgx's plan on the same matrix)."""
    import jax.numpy as jnp

    from cgx.dist.partition import partition_csr
    from cgx.io.poisson import poisson2d_dia
    from cgx.ops.spmv import spmv
    from cgx.sparse.types import csr_from_scipy

    s = _random_spd(100, 0.15, 7)
    inp = _inputs()
    assert partition_csr(csr_from_scipy(s), P).mode == "allgather"
    ref_dia = np.asarray(spmv(poisson2d_dia(24, 16),
                              jnp.asarray(inp["x384"])))
    for r in range(P):
        out = ranks[P][r]
        assert out["general_mode"] == "allgather"
        np.testing.assert_allclose(out["general"][:100], s @ inp["x100"],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out["dia"][:384], ref_dia, rtol=1e-12,
                                   atol=1e-12)


def test_partition_from_cgx_matches():
    """interop.partition_from_cgx carries cgx's stacked arrays and static
    fields; the port's own partitioner builds the same."""
    from cgx.dist.partition import partition_csr, partition_dia
    from cgx.io.poisson import poisson2d, poisson2d_dia
    from cgx_torch.dist import partition_csr as pcsr, partition_dia as pdia
    from cgx_torch.interop import partition_from_cgx
    from cgx_torch.io.poisson import poisson2d as tp2, poisson2d_dia as tpd

    for theirs, mine in ((partition_csr(poisson2d(20, 13), 4),
                          pcsr(tp2(20, 13, device="cpu"), 4)),
                         (partition_dia(poisson2d_dia(24, 16), 4),
                          pdia(tpd(24, 16, device="cpu"), 4))):
        carried = partition_from_cgx(theirs)
        for got in (carried, mine):
            for f in ("kind", "mode", "n", "n_shards", "rows_local",
                      "halo_lo", "halo_hi", "dia_offsets"):
                assert getattr(got, f) == getattr(theirs, f), f
            for f in ("ell_values", "ell_cols", "dia_data"):
                a, b = getattr(got, f), getattr(theirs, f)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, np.asarray(b))


# -- dist_cg_solve ------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("pre", ["none", "jacobi", "block_jacobi", "poly"])
def test_dist_cg_preconditioners(ranks, cgx_ref, P, pre):
    """Each shard-built preconditioner over P gloo ranks against cgx's on a
    4-device mesh (these four do not depend on the partition)."""
    b = _inputs()["b"]
    x, it, _ = _cgx_solve(4, cgx_ref, _cgx_dia, b, tol=1e-10, maxiter=600,
                          preconditioner=pre, blocksize=8, poly_steps=3)
    out = ranks[P][0][f"pcg_{pre}"]
    assert out["conv"]
    assert abs(out["it"] - it) <= 2
    np.testing.assert_allclose(out["x"][:256], x[:256], rtol=1e-9,
                               atol=1e-11)


@pytest.mark.parametrize("P", [2, 4])
def test_dist_cg_csr_halo_jacobi(ranks, cgx_ref, P):
    """The ELL (CSR) layout in halo mode, Jacobi, against cgx's."""
    from cgx.dist.partition import partition_csr
    from cgx.io.poisson import poisson2d

    b = _inputs()["b"]
    x, it, _ = _cgx_solve(4, cgx_ref,
                          lambda q: partition_csr(poisson2d(*N2D), q), b,
                          tol=1e-10, maxiter=600, jacobi=True)
    out = ranks[P][0]
    assert out["csr_mode"] == "halo"
    assert abs(out["pcg_csr_jacobi"]["it"] - it) <= 2
    np.testing.assert_allclose(out["pcg_csr_jacobi"]["x"][:256], x[:256],
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("P", [2, 4])
def test_dist_ic0_sweep(ranks, cgx_ref, P):
    """The Schwarz IC(0) blocks depend on the partition: P ranks against
    cgx on a P-device mesh, the same blocks factored by each package."""
    b = _inputs()["b"]
    x, it, _ = _cgx_solve(P, cgx_ref, _cgx_dia, b, tol=1e-10, maxiter=400,
                          preconditioner="ic0_sweep", nsweeps=1)
    out = ranks[P][0]["ic0_sweep"]
    assert out["conv"]
    assert abs(out["it"] - it) <= 2
    np.testing.assert_allclose(out["x"][:256], x[:256], rtol=1e-9,
                               atol=1e-11)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("method,kw,rtol", [
    ("single_reduction", {}, 1e-7),
    ("pipelined", {}, 1e-7),
    ("pipelined_adaptive", {"adaptive_replace": True}, 1e-7),
    ("chebyshev", {"lam_min": 0.07, "lam_max": 8.0, "tol": 1e-8,
                   "maxiter": 3000}, 1e-8),
])
def test_dist_methods(ranks, cgx_ref, P, method, kw, rtol):
    """The single-reduction, pipelined (periodic and adaptive) and
    Chebyshev methods against cgx's on a 4-device mesh."""
    b = _inputs()["b"]
    args = dict(tol=1e-10, maxiter=600)
    args.update(kw)
    x, it, _ = _cgx_solve(4, cgx_ref, _cgx_dia, b,
                          method=method.split("_adaptive")[0], **args)
    out = ranks[P][0][method]
    assert out["conv"]
    assert abs(out["it"] - it) <= 2
    np.testing.assert_allclose(out["x"][:256], x[:256], rtol=rtol,
                               atol=rtol * 1e-2)


@pytest.mark.parametrize("P", [2, 4])
def test_dist_chebyshev_estimated_bounds(ranks, P):
    """Chebyshev with bounds from the distributed power iteration (the
    same start vector on every rank) reaches the tolerance on the true
    residual, as cgx's test asks."""
    import scipy.sparse as sp

    b = _inputs()["b"]
    out = ranks[P][0]["chebyshev_est"]
    assert out["conv"]
    nx, ny = N2D
    lap = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    lap_y = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    a = sp.kron(lap, sp.identity(ny)) + sp.kron(sp.identity(nx), lap_y)
    r = b - a @ out["x"][:256]
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b)


@pytest.mark.parametrize("P", [2, 4])
def test_dist_cg_history(ranks, cgx_ref, P):
    """The fixed-count history (tol=0, 30 iterations) against cgx's."""
    b = _inputs()["b"]
    _, _, hist = _cgx_solve(4, cgx_ref, _cgx_dia, b, tol=0.0, maxiter=30,
                            track_history=True)
    out = ranks[P][0]["history"]
    assert out["history"].shape == (31,)
    np.testing.assert_allclose(out["history"], hist, rtol=1e-8)


# -- what each rank sends ------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_collective_counts(ranks, P):
    """No all-gather in halo mode; two all-reduces an iteration for CG,
    one for the single-reduction and pipelined forms (one more at each
    residual replacement), none between Chebyshev's checks, none in the
    Schwarz apply; two messages each way a product."""
    for r in range(P):
        out = ranks[P][r]
        for key in ("pcg_none", "pcg_jacobi", "pcg_block_jacobi",
                    "pcg_poly", "ic0_sweep", "single_reduction",
                    "pipelined", "chebyshev", "history"):
            assert out[key]["counts"]["all_gathers"] == 0, key
        it = out["pcg_none"]["it"]
        # threshold and r₀'s dots, then two an iteration
        assert out["pcg_none"]["counts"]["all_reduces"] == 2 + 2 * it
        assert out["pcg_jacobi"]["counts"]["all_reduces"] == \
            2 + 2 * out["pcg_jacobi"]["it"]
        # a product a CG iteration plus r₀ = b (no x0): one exchange each
        assert out["pcg_none"]["counts"]["sends"] == 2 * it
        sr = out["single_reduction"]
        assert sr["counts"]["all_reduces"] == 2 + sr["it"]
        pl = out["pipelined"]
        assert pl["counts"]["all_reduces"] == \
            2 + pl["it"] + pl["replacements"]
        ch = out["chebyshev"]
        assert ch["counts"]["all_reduces"] == 3 + ch["it"] // 16
        assert out["sweep_counts"] == {"sends": 0, "recvs": 0,
                                       "all_reduces": 0, "all_gathers": 0}
        assert not out["jax_loaded"]


# -- the 2 x 2 grid -------------------------------------------------------------


def test_grid2d_matvec(ranks):
    """Every rank of the 2 x 2 grid holds its row block of A·x."""
    import jax.numpy as jnp

    from cgx.io.poisson import poisson2d
    from cgx.ops.spmv import spmv

    x = _inputs()["x260"][:182]
    ref = np.asarray(spmv(poisson2d(14, 13), jnp.asarray(x)))
    ref = np.pad(ref, (0, 2 * 91 - 182))
    for out in ranks[4]:
        a, _, y = out["grid_y"]
        np.testing.assert_allclose(y, ref[a * 91:(a + 1) * 91], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("jacobi", [False, True])
def test_grid2d_cg(ranks, jacobi):
    """Row- and column-sharded CG on the 2 x 2 grid against cgx's
    dist_cg_solve_2d on a 2 x 2 device mesh."""
    import jax.numpy as jnp

    from cgx.dist.grid2d import (dist_cg_solve_2d, make_grid_mesh,
                                 partition_csr_2d)
    from cgx.io.poisson import poisson2d

    b = _inputs()["b"]
    res = dist_cg_solve_2d(partition_csr_2d(poisson2d(*N2D), 2),
                           jnp.asarray(b), make_grid_mesh(2), tol=1e-10,
                           maxiter=600, jacobi=jacobi)
    ref = np.asarray(res.x)
    for out in ranks[4]:
        a, _, x, it, rl = out[f"grid_cg_{jacobi}"]
        assert abs(it - int(res.iterations)) <= 2
        np.testing.assert_allclose(x, ref[a * rl:(a + 1) * rl], rtol=1e-9,
                                   atol=1e-11)


# -- launch ----------------------------------------------------------------------


def test_initialize_single_process_noop(monkeypatch):
    """A single process that names no coordinator forms no group."""
    import torch.distributed as dist

    from cgx_torch.dist import initialize, is_multihost

    for var in ("CGX_COORDINATOR", "CGX_NUM_PROCS", "MASTER_ADDR",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    initialize()
    assert not dist.is_initialized()
    assert not is_multihost()


def test_mesh_needs_a_group():
    """No silent single-process mesh: without a group the mesh raises."""
    import torch.distributed as dist

    from cgx_torch.dist import global_row_mesh, make_row_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_row_mesh(2)
    with pytest.raises(RuntimeError, match="no process group"):
        global_row_mesh()


def test_initialize_cuda_without_card_raises():
    """device='cuda' without a card raises instead of falling back."""
    import torch

    from cgx_torch.dist import initialize

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        initialize("localhost:1", 2, 0, device="cuda")

"""The port's row-partitioned WBELL engine against cgx.dist.wbell: the
partition, the shard products and the multi-RHS solves.

``run_spmd`` spawns P = 2 and P = 4 gloo ranks once for the module and
each rank runs every case of :func:`_worker` (K7 and K8 take their plain
versions on the CPU, over each shard's row layout); the tests hold what
the ranks return against ``cgx.dist.wbell`` on a P-device mesh of the
test process's virtual CPU devices (its kernels in interpret mode), both
fed the same numpy inputs (:mod:`torch_dist_wbell_cases`).  Workers are
unpickled by name in the spawned children, so this module imports ``cgx``
(and JAX) only inside test functions and fixtures; each worker checks
that no JAX is loaded.  The single-RHS solves are in
``tests/test_torch_dist_wbell_solve.py`` and the uneven and degenerate
shards in ``tests/test_torch_dist_wbell_shards.py``: three files, so
that ``--dist loadfile`` spreads them over the workers.

Tolerances: the shard products equal cgx's bit for bit (the same sums in
the same order); the multi-RHS solves keep cgx's iteration counts within
2 and x within 1e-4 relative in fp32, with each solution's true residual
at cgx's test bar; tiered and untiered multi-RHS solves equal each other
bit for bit (both read the shard's K7 layout).  Collective counts replace
cgx's checks of the compiled HLO.  The matrix's 3 groups put 2 and 1 on
the shards at P = 2 and 1 on each at P = 4, one shard empty, so the
halos take several ring steps.
"""
import sys

import numpy as np
import pytest

from torch_dist_wbell_cases import (K, cached, counted, inputs, matrix,
                                    rel, relres, spawn)


def _worker(mesh, data):
    """Every case of the module on one rank; returns plain numpy data."""
    assert "jax" not in sys.modules
    import torch

    from cgx_torch.dist import halo
    from cgx_torch.dist import wbell as dw
    from cgx_torch.kernels.wbell import tiered_rows
    from cgx_torch.sparse import wbell as sw

    rank = mesh.rank
    out = {}

    a = matrix()
    sw.row_layout_builds = 0
    part = dw.partition_wbell(a, mesh.size)
    ps = dw.partition_wbell(a, mesh.size, per_shard=True)
    out["geometry"] = {f: getattr(part, f) for f in (
        "gs", "ng_real", "halo_lo", "halo_hi", "nt_local", "span", "nnz")}
    out["per_shard_geometry"] = {f: getattr(ps, f) for f in out["geometry"]}
    out["arrays"] = {f: getattr(part, f) for f in (
        "values", "lc", "p_og", "p_ga", "diag_internal", "perm")}
    out["per_shard_arrays"] = {f: getattr(ps, f) for f in (
        "values", "lc", "p_og", "p_ga", "diag_internal", "perm")}

    # The shard products: K7 (one column) and K7/K8 over k = 4 columns.
    loc = part.local(rank, "cpu")
    xi = part.slab(part.to_internal(torch.from_numpy(data["x"])), rank)
    y, c = counted(lambda: dw.local_wbell_matvec(loc, xi, mesh))
    out["matvec"], out["matvec_counts"] = y.numpy(), c
    out["matvec_per_shard"] = dw.local_wbell_matvec(
        ps.local(rank, "cpu"), xi, mesh).numpy()
    xk = torch.from_numpy(data["xk"])
    xki = part.slab(torch.stack([part.to_internal(xk[:, j])
                                 for j in range(4)]), rank)
    plan = dw._local_tiers(part, loc)
    y7, c = counted(lambda: dw.local_wbell_matvec_multi(loc, xki, mesh))
    y8 = dw.local_wbell_matvec_multi(loc, xki, mesh, tiers=plan)
    out["multi_k7"], out["multi_k8"] = y7.numpy(), y8.numpy()
    out["multi_counts"] = c
    out["multi_cut"] = dw.local_wbell_product(
        loc, halo.cut_halo_rows(part.to_internal(xk[:, 0]), rank, mesh.size,
                                part.halo_lo, part.halo_hi)[None])[0].numpy()
    # One row layout a shard: built by local() for each of the two
    # partitions, then never again, whatever is solved.
    out["builds_after_products"] = sw.row_layout_builds
    # K8's layout is the shard's K7 layout: the plan's own planes in their
    # walk give the same arrays.
    own = tiered_rows(plan.packed, plan.lc, plan.values, plan.walk,
                      plan.nt)
    out["tier_rows_same"] = plan.rows is loc.rows and all(
        torch.equal(getattr(own, f), getattr(loc.rows, f))
        for f in ("values", "cols", "sbase", "rowmap", "sptr", "x0", "xlen"))
    out["tier_steps"] = plan.steps
    sw.row_layout_builds = 0

    # Multi-RHS: tiered (K8) and untiered (K7), a warm start.
    bk = data["bk"]
    for tiered in (True, False):
        res, c = counted(lambda: dw.dist_wbell_cg_solve_multi(
            part, bk, mesh, tol=1e-6, maxiter=600, jacobi=True,
            tiered=tiered))
        out[f"multi_{tiered}"] = {
            "x": res.x.numpy(), "it": res.iterations.numpy(),
            "conv": res.converged.numpy(), "rr": res.residual_norm_sq.numpy(),
            "counts": c}
    its = out["multi_True"]["it"]
    half = dw.dist_wbell_cg_solve_multi(part, bk, mesh, tol=1e-6,
                                        maxiter=int(its.max()) // 2,
                                        jacobi=True)
    res = dw.dist_wbell_cg_solve_multi(part, bk, mesh, x0=half.x, tol=1e-6,
                                       maxiter=600, jacobi=True)
    out["multi_resumed"] = {"x": res.x.numpy(), "it": res.iterations.numpy(),
                            "conv": res.converged.numpy()}
    out["builds_after_solves"] = sw.row_layout_builds
    out["jax_loaded"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def ranks():
    """``{P: [rank 0's results, ...]}`` for P = 2 and 4 (one spawn each)."""
    return spawn(_worker)


@pytest.fixture(scope="module")
def cgx_side():
    """cgx's partitions and ``make_row_mesh(P)`` sub-meshes, and a cache of
    its solves (each computed once for the module)."""
    from cgx.dist.wbell import partition_wbell

    from torch_dist_wbell_cases import cgx_mesh

    a = matrix()
    return {"mesh": {P: cgx_mesh(P) for P in (2, 4)},
            "part": {P: partition_wbell(a, P) for P in (2, 4)},
            "a": a, "cache": {}}


def _shard_map(mesh, fn, in_specs, out_specs, *args):
    import jax
    from jax.sharding import NamedSharding

    f = jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)
    placed = [jax.device_put(v, jax.tree.map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda s: type(s).__name__ == "PartitionSpec"))
        for v, spec in zip(args, in_specs)]
    return np.asarray(f(*placed))


# -- the partition ---------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("per_shard", [False, True])
def test_partition_equals_cgx(ranks, P, per_shard):
    """Both builds' stacked planes, geometry, diagonal and permutation are
    cgx's, array for array."""
    from cgx.dist.wbell import partition_wbell

    theirs = partition_wbell(matrix(), P, per_shard=per_shard)
    out = ranks[P][0]
    geo = out["per_shard_geometry" if per_shard else "geometry"]
    arrays = out["per_shard_arrays" if per_shard else "arrays"]
    for f, v in geo.items():
        assert v == getattr(theirs, f), f
    for f, v in arrays.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(theirs, f)),
                                      err_msg=f)


@pytest.mark.parametrize("P", [2, 4])
def test_per_shard_build_gives_the_global_planes(ranks, P):
    """``per_shard=True`` packs each slab alone: its non-zero planes are
    the global build's, in the same order, at the same local coordinates,
    and its products equal the global partition's bit for bit."""
    out = ranks[P][0]
    g, s = out["arrays"], out["per_shard_arrays"]
    for d in range(P):
        keep_g = np.abs(g["values"][d]).reshape(len(g["values"][d]),
                                                -1).sum(1) > 0
        keep_s = np.abs(s["values"][d]).reshape(len(s["values"][d]),
                                                -1).sum(1) > 0
        for f in ("values", "lc", "p_og", "p_ga"):
            np.testing.assert_array_equal(g[f][d][keep_g], s[f][d][keep_s],
                                          err_msg=f)
    for r in range(P):
        np.testing.assert_array_equal(ranks[P][r]["matvec"],
                                      ranks[P][r]["matvec_per_shard"])


# -- the shard products --------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_local_matvec_equals_cgx(ranks, cgx_side, P):
    """Each rank's K7 product (plain version, over its row layout) equals
    cgx's ``local_wbell_matvec`` in interpret mode on a P-device mesh bit
    for bit, slab for slab; the ring moved group slabs and gathered
    nothing."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec

    from cgx.dist.wbell import _operator_specs, local_wbell_matvec

    part = cgx_side["part"][P]
    ref = _shard_map(
        cgx_side["mesh"][P],
        lambda p, xl: local_wbell_matvec(p, xl, axis_name="rows",
                                         interpret=True),
        (_operator_specs(part), Pspec("rows")), Pspec("rows"), part,
        part.to_internal(jnp.asarray(inputs()["x"])))
    gs = part.gs
    for r in range(P):
        out = ranks[P][r]
        np.testing.assert_array_equal(out["matvec"], ref[r * gs:(r + 1) * gs])
        c = out["matvec_counts"]
        assert c["all_gathers"] == 0 and c["all_reduces"] == 0
        assert c["sends"] == c["recvs"] > 0


@pytest.mark.parametrize("P,tiered", [(2, False), (4, True)])
def test_local_matvec_multi_equals_cgx(ranks, cgx_side, P, tiered):
    """The multi-RHS shard products, K7 (untiered) and K8 (over the shard's
    tier plan), equal cgx's ``local_wbell_matvec_multi`` in interpret mode
    bit for bit (untiered at P = 2, tiered at P = 4: at each P the port's
    two products are equal bit for bit, so each case covers both); one
    exchange carried the k columns."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec

    from cgx.dist.wbell import (_operator_specs, local_wbell_matvec_multi,
                                partition_tier_plans)

    part = cgx_side["part"][P]
    xk = inputs()["xk"]
    xi = jnp.stack([part.to_internal(jnp.asarray(xk[:, j]))
                    for j in range(4)])
    specs = [_operator_specs(part), Pspec(None, "rows")]
    args = [part, xi]
    if tiered:
        tiers = partition_tier_plans(part)
        specs.append(jax.tree.map(lambda _: Pspec("rows"), tiers))
        args.append(tiers)
        assert ranks[P][0]["tier_steps"] == tiers.steps

    def fn(p, xl, *rest):
        return local_wbell_matvec_multi(p, xl, axis_name="rows",
                                        interpret=True,
                                        tiers=rest[0] if rest else None)

    ref = _shard_map(cgx_side["mesh"][P], fn, tuple(specs),
                     Pspec(None, "rows"), *args)
    gs = part.gs
    for r in range(P):
        out = ranks[P][r]
        mine = out["multi_k8" if tiered else "multi_k7"]
        np.testing.assert_array_equal(mine, ref[:, r * gs:(r + 1) * gs])
        np.testing.assert_array_equal(out["multi_k7"], out["multi_k8"])
        # one exchange for the 4 columns: as many messages as one column's
        assert out["multi_counts"] == out["matvec_counts"]


@pytest.mark.parametrize("P", [2, 4])
def test_cut_halos_give_the_exchanged_product(ranks, P):
    """A shard's product from halos cut out of the whole vector (no
    traffic, as the smoke's DW1 checks each shard) equals the exchanged
    one bit for bit."""
    for r in range(P):
        out = ranks[P][r]
        np.testing.assert_array_equal(out["multi_cut"], out["multi_k7"][0])


@pytest.mark.parametrize("P", [2, 4])
def test_tier_plan_holds_the_shard_layout(ranks, P):
    """Each shard's tier plan holds the shard's K7 row layout, and its own
    planes in their walk build the same arrays."""
    for r in range(P):
        assert ranks[P][r]["tier_rows_same"]


@pytest.mark.parametrize("P", [2, 4])
def test_one_row_layout_per_shard(ranks, P):
    """``local()`` builds a shard's row layout once (two partitions: two
    layouts); the multi-RHS solves after it, tiered or not, build none
    (the single-RHS solves' count is in ``test_torch_dist_wbell_solve``)."""
    for r in range(P):
        out = ranks[P][r]
        assert out["builds_after_products"] == 2
        assert out["builds_after_solves"] == 0


# -- the multi-RHS solves ----------------------------------------------------------


def _cgx_multi(cgx_side, P, tiered):
    import jax.numpy as jnp

    from cgx.dist.wbell import dist_wbell_cg_solve_multi

    def run():
        res = dist_wbell_cg_solve_multi(
            cgx_side["part"][P], jnp.asarray(inputs()["bk"]),
            cgx_side["mesh"][P], tol=1e-6, maxiter=600, jacobi=True,
            tiered=tiered)
        return np.asarray(res.x), np.asarray(res.iterations)
    return cached(cgx_side["cache"], ("multi", P, tiered), run)


@pytest.mark.parametrize("P", [2, 4])
def test_dist_wbell_multi_rhs_matches_cgx(ranks, cgx_side, P):
    """The batched solve against cgx's on the same P shards: per-column
    iterations within 2, each column within 1e-4 and at the 2e-6 bar; two
    all-reduces an iteration and one gather at the boundary."""
    x, its = _cgx_multi(cgx_side, P, None)
    bk = inputs()["bk"]
    out = ranks[P][0]["multi_True"]
    assert out["conv"].all()
    assert (np.abs(out["it"] - its) <= 2).all(), (out["it"], its)
    for j in range(K):
        assert rel(out["x"][:, j], x[:, j]) <= 1e-4
        assert relres(cgx_side["a"], out["x"][:, j], bk[:, j]) <= 2e-6
    c = out["counts"]
    assert c["all_gathers"] == 1
    assert c["all_reduces"] == 1 + 2 * int(out["it"].max())


@pytest.mark.parametrize("P", [2, 4])
def test_dist_wbell_multi_tiered_equals_untiered(ranks, P):
    """K8 over the shard's tier plan and K7 read the same layout: the two
    solves agree bit for bit (cgx's own test asks for iterations within
    1)."""
    for r in range(P):
        t, u = ranks[P][r]["multi_True"], ranks[P][r]["multi_False"]
        for f in ("x", "it", "rr", "conv"):
            np.testing.assert_array_equal(t[f], u[f], err_msg=f)


@pytest.mark.parametrize("P", [2, 4])
def test_dist_wbell_multi_warm_start(ranks, cgx_side, P):
    """``x0`` resumes the batched solve (the warm start cgx.dist.hp's chunked
    multi-RHS refinement needs): fewer iterations, every column at the
    bar."""
    out = ranks[P][0]
    res = out["multi_resumed"]
    bk = inputs()["bk"]
    assert res["conv"].all()
    assert res["it"].max() < out["multi_True"]["it"].max()
    for j in range(K):
        assert relres(cgx_side["a"], res["x"][:, j], bk[:, j]) <= 2e-6


def test_workers_loaded_no_jax(ranks):
    for P, outs in ranks.items():
        assert not any(o["jax_loaded"] for o in outs), P

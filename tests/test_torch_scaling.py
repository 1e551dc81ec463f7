"""The port's scaling harness against cgx.bench.scaling.

``comm_report`` is the same arithmetic over the port's ``Partition``: held
against cgx's key for key on ``tests/test_scaling.py``'s partitions, with
cgx's link figures passed explicitly (bytes exact, times to 1e-12
relative).  The port's defaults are the card's, not the v5e's.
``measure_scaling`` spawns one gloo group of each count on the CPU; its
iterations equal cgx's on the virtual mesh.
"""
import dataclasses

import numpy as np
import pytest

V5E = dict(hbm_gbps=819.0, ici_gbps=186.0, ici_latency_us=1.0,
           psum_latency_us=4.0)


def _partitions(kind):
    """``(cgx's partition, the port's)`` of the same operator."""
    from cgx.dist.partition import partition_csr as cgx_csr
    from cgx.dist.partition import partition_dia as cgx_dia
    from cgx.io.poisson import poisson2d as cgx_p2
    from cgx.io.poisson import poisson3d_dia as cgx_p3

    from cgx_torch.dist.partition import partition_csr, partition_dia
    from cgx_torch.io.poisson import poisson2d, poisson3d_dia

    if kind.startswith("dia"):
        k = int(kind[3:])
        return (cgx_dia(cgx_p3(k, k, k), 8),
                partition_dia(poisson3d_dia(k, k, k, device="cpu"), 8))
    mode = kind.split("_")[1]
    return (cgx_csr(cgx_p2(64, 64), 8, mode=mode),
            partition_csr(poisson2d(64, 64, device="cpu"), 8, mode=mode))


@pytest.mark.parametrize("sync_points", [1, 2])
@pytest.mark.parametrize("kind", ["dia16", "dia12", "csr_halo",
                                  "csr_allgather"])
def test_comm_report_matches_cgx(kind, sync_points):
    """Key for key with cgx's figures passed: bytes exact, times and the
    efficiency to 1e-12 relative."""
    from cgx.bench.scaling import LinkModel as CgxLink
    from cgx.bench.scaling import comm_report as cgx_report

    from cgx_torch.bench.scaling import LinkModel, comm_report

    theirs_part, mine_part = _partitions(kind)
    theirs = cgx_report(theirs_part, link=CgxLink(**V5E),
                        sync_points=sync_points)
    mine = comm_report(mine_part, link=LinkModel(**V5E),
                       sync_points=sync_points)
    assert list(mine) == list(theirs)
    for key, want in theirs.items():
        if isinstance(want, float):
            assert mine[key] == pytest.approx(want, rel=1e-12), key
        else:
            assert mine[key] == want, key
    if kind == "dia16":
        assert mine["mode"] == "halo"
        assert mine["comm_bytes_per_iter_per_chip"] == 2 * 256 * 4


def test_link_model_defaults_are_the_cards():
    """The defaults are the H100's (HBM3 3.35 TB/s, NVLink 4 450 GB/s a
    direction), and none of the v5e's figures survives; the halo plan
    still moves less than the all-gather and one sync point costs less
    than two."""
    from cgx_torch.bench.scaling import LinkModel, comm_report

    link = dataclasses.asdict(LinkModel())
    assert link["hbm_gbps"] == 3350.0 and link["ici_gbps"] == 450.0
    assert all(link[k] != v for k, v in V5E.items()), link
    halo = comm_report(_partitions("csr_halo")[1])
    ag = comm_report(_partitions("csr_allgather")[1])
    assert (ag["comm_bytes_per_iter_per_chip"]
            > halo["comm_bytes_per_iter_per_chip"])
    part = _partitions("dia12")[1]
    assert (comm_report(part, sync_points=1)["predicted_iter_us"]
            < comm_report(part, sync_points=2)["predicted_iter_us"])
    for rep in (halo, ag):
        assert 0 < rep["predicted_efficiency"] <= 1.0


def test_measure_scaling_matches_cgx():
    """Counts [1, 2]: one gloo group of each, the iterations cgx's on the
    virtual mesh, the first efficiency 1.0."""
    import jax.numpy as jnp

    from cgx.bench.scaling import measure_scaling as cgx_measure
    from cgx.io.poisson import poisson3d_dia as cgx_p3

    from cgx_torch.bench.scaling import measure_scaling
    from cgx_torch.io.poisson import poisson3d_dia

    b = np.random.default_rng(42).standard_normal(12 ** 3)
    theirs = cgx_measure(cgx_p3(12, 12, 12), jnp.asarray(b), [1, 2],
                         tol=1e-6, maxiter=150, reps=2)
    mine = measure_scaling(poisson3d_dia(12, 12, 12, device="cpu"), b,
                           [1, 2], tol=1e-6, maxiter=150, reps=2,
                           device="cpu")
    assert [r["devices"] for r in mine] == [1, 2]
    assert [r["iterations"] for r in mine] == \
        [r["iterations"] for r in theirs]
    assert mine[0]["efficiency"] == 1.0
    assert all(r["seconds"] > 0 for r in mine)
    assert set(mine[0]) == set(theirs[0])


def test_measure_scaling_on_cuda_needs_a_group():
    """Without a process group a count on the card raises (one card holds
    one NCCL rank); nothing runs on the CPU instead."""
    from cgx_torch.bench.scaling import measure_scaling
    from cgx_torch.io.poisson import poisson3d_dia

    a = poisson3d_dia(6, 6, 6, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        measure_scaling(a, np.ones(216), [2])

"""Scaling harness (PyTorch): the analytic communication model and the
measured scaling runs.

Counterpart of :mod:`cgx.bench.scaling`, with its names, arguments and
keys:

* :func:`comm_report` — an analytic per-iteration model from the actual
  partition: the bytes a rank moves to its neighbours per CG iteration
  (the halo rows, or the all-gathered vector), the bytes it streams from
  device memory, and the predicted scaling efficiency under a
  :class:`LinkModel`.  It reads the halo widths and shard sizes off the
  port's :class:`~cgx_torch.dist.partition.Partition` (the JAX package's
  field names) and does the JAX package's arithmetic.
* :func:`measure_scaling` — the time of the same row-sharded Jacobi-PCG
  solve (:func:`~cgx_torch.dist.solve.dist_cg_solve`) at each rank count.
  On the CPU each count is one spawned gloo group
  (:func:`~cgx_torch.dist.launch.run_spmd`): it checks the machinery, and
  its times say nothing of a card.  On cards it runs in the NCCL group the
  caller formed (``torchrun``, or
  :func:`~cgx_torch.dist.launch.initialize`), at that group's size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = ["LinkModel", "comm_report", "measure_scaling"]


@dataclass(frozen=True)
class LinkModel:
    """Bandwidths and latencies for the efficiency prediction, the field
    names the JAX package's (``ici`` is the card-to-card link).  The
    defaults are one NVIDIA H100 SXM's:

    * ``hbm_gbps``: HBM3, 3.35 TB/s (NVIDIA's H100 SXM data sheet, at its
      700 W limit);
    * ``ici_gbps``: NVLink 4, 900 GB/s in both directions together (the
      same data sheet), so 450 GB/s a direction;
    * ``ici_latency_us`` and ``psum_latency_us``: the time per call of one
      NCCL all-gather of a 4 KiB slab and of one all-reduce of an fp64
      word, by CUDA events around 100 calls, measured at ONE rank on an
      NVIDIA H100 80GB HBM3 at 700.00 W (``chip_smoke.py`` phase SC).  One
      card holds one NCCL rank, so no two-card figure exists: these are
      one rank's costs (mostly the host's launch of the collective), not
      an NVLink hop's.
    """

    hbm_gbps: float = 3350.0
    ici_gbps: float = 450.0
    ici_latency_us: float = 43.52
    psum_latency_us: float = 118.28


def comm_report(part, dtype_bytes: int = 4,
                link: LinkModel = LinkModel(),
                sync_points: int = 2) -> dict:
    """Per-iteration traffic and predicted scaling efficiency for a
    partition.

    ``sync_points``: global scalar reductions per iteration (2 for
    standard CG, 1 for
    :func:`cgx_torch.solve.cg.cg_solve_single_reduction`).
    """
    rl = part.rows_local
    s = part.n_shards
    if part.kind == "dia":
        nnz_local = int(np.count_nonzero(np.asarray(part.dia_data))) // s
    else:
        nnz_local = int(np.count_nonzero(np.asarray(part.ell_values))) // s
    vec_passes = 11  # q=Ap & pq; x,r updates; z; rz; p update (fused)
    hbm_bytes = (nnz_local * 2 + vec_passes * rl) * dtype_bytes

    if part.mode == "halo":
        comm_bytes = (part.halo_lo + part.halo_hi) * dtype_bytes
        hops = 1
    else:
        comm_bytes = (part.n_padded - rl) * dtype_bytes
        hops = max(s - 1, 1)

    t_compute = hbm_bytes / (link.hbm_gbps * 1e9)
    t_comm = (comm_bytes / (link.ici_gbps * 1e9)
              + hops * link.ici_latency_us * 1e-6)
    t_sync = sync_points * link.psum_latency_us * 1e-6
    # The halo exchange overlaps with interior compute; count only its
    # excess.
    t_iter = max(t_compute, t_comm) + t_sync
    t_iter_1dev = (hbm_bytes * s) / (link.hbm_gbps * 1e9)
    eff = t_iter_1dev / (s * t_iter)
    return {
        "n_shards": s,
        "rows_local": rl,
        "mode": part.mode,
        "hbm_bytes_per_iter_per_chip": hbm_bytes,
        "comm_bytes_per_iter_per_chip": comm_bytes,
        "sync_points": sync_points,
        "predicted_iter_us": t_iter * 1e6,
        "predicted_efficiency": min(eff, 1.0),
    }


def _scaling_worker(mesh, part, b, tol, maxiter, reps):
    """One rank of one count: a warm solve, then the best of ``reps``
    timed solves of fresh right-hand sides (CUDA events on a card, the
    host clock on the CPU), the slowest rank's best reported by all."""
    import torch
    import torch.distributed as dist

    from cgx_torch.cli import _timer
    from cgx_torch.dist.solve import dist_cg_solve

    dev = mesh.device
    bs = [torch.from_numpy(b * (1 + 0.001 * i)).to(dev)
          for i in range(reps)]
    res = dist_cg_solve(part, bs[0], mesh, tol=tol, maxiter=maxiter,
                        jacobi=True)
    timed = _timer(dev)
    best = min(timed(lambda: dist_cg_solve(part, bi, mesh, tol=tol,
                                           maxiter=maxiter, jacobi=True))
               for bi in bs)
    worst = torch.tensor([best], dtype=torch.float64, device=dev)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(worst), int(res.iterations)


def measure_scaling(a_dia, b, device_counts: Sequence[int],
                    *, tol: float = 1e-6, maxiter: Optional[int] = None,
                    reps: int = 3, device="cuda") -> list:
    """Measured solve time across rank counts (the same global problem).

    ``a_dia`` is the port's :class:`~cgx_torch.DIAMatrix`, ``b`` the global
    right-hand side (numpy or torch).  Inside a process group (NCCL on the
    cards, under ``torchrun``) every rank calls this, each count must be
    the group's size, and the solves run on ``device``.  Without a group,
    ``device="cpu"`` spawns one gloo group of each count; ``device="cuda"``
    raises, since one card holds one NCCL rank.  A count that cannot run
    raises: none is skipped.  Each result: ``devices``, ``seconds`` (the
    best solve of the slowest rank), ``iterations`` and ``efficiency``
    against the first count.
    """
    import torch
    import torch.distributed as dist

    from cgx_torch.dist.launch import make_row_mesh, run_spmd
    from cgx_torch.dist.partition import partition_dia

    b = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
         else np.asarray(b))
    results = []
    for nd in device_counts:
        part = partition_dia(a_dia, nd)
        args = (part, b, tol, maxiter, reps)
        if dist.is_initialized():
            if dist.get_world_size() != nd:
                raise ValueError(
                    f"measure_scaling: {nd} ranks asked for, but the "
                    f"process group has {dist.get_world_size()}")
            seconds, its = _scaling_worker(make_row_mesh(nd, device=device),
                                           *args)
        elif torch.device(device).type == "cpu":
            seconds, its = run_spmd(_scaling_worker, nd, *args)[0]
        else:
            raise ValueError(
                f"measure_scaling: {nd} ranks on {device} need a process "
                f"group of {nd} (torchrun --nproc-per-node {nd}, one card "
                f"a rank)")
        results.append({"devices": nd, "seconds": seconds,
                        "iterations": its})
    base = results[0]
    for r in results:
        r["efficiency"] = (base["seconds"] * base["devices"]
                           / (r["seconds"] * r["devices"]))
    return results

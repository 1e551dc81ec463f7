"""Entry points: a one-card check and a multi-rank dry run (PyTorch).

Counterpart of the JAX package's ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, args)``: one Jacobi-PCG solve of the 3-D
  Poisson DIA operator at 16³ (tol 1e-5, at most 200 iterations), with
  the operator and right-hand side on the card (the kernels built first)
  or, when asked, on the CPU.
* :func:`dryrun_multichip` runs every stage of the JAX package's dry run
  on ``n`` ranks, at its shapes and with its checks: the halo and
  all-gather partitions, the Schwarz IC(0) sweep, pipelined CG, the fused
  engines across ranks (stencil, DIA, uneven ``nx``, multi-RHS), the
  row-partitioned WBELL engine (single and multi-RHS), the df64
  refinement across ranks (single and multi-RHS), and the 2-D grid when
  ⌊√n⌋² ≥ 4.  On the CPU it spawns ``n`` gloo ranks
  (:func:`~cgx_torch.dist.launch.run_spmd`).  NCCL takes one card a rank,
  so ``n > 1`` ranks on cards come from ``torchrun --nproc-per-node n``,
  each rank calling this inside the group it formed
  (:func:`~cgx_torch.dist.launch.initialize`).

    python -m cgx_torch.graft_entry [entry] [--device cpu]
    python -m cgx_torch.graft_entry dryrun [N]
"""
from __future__ import annotations

import sys

import numpy as np

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(a, b)`` is one Jacobi-PCG solve of the
    3-D Poisson DIA operator at 16³ and returns ``(x, iterations,
    residual_norm_sq)``.  On the card the CUDA kernels are built first;
    without a card ``device="cuda"`` raises."""
    import torch

    import cgx_torch
    from cgx_torch.io.poisson import poisson3d_dia
    from cgx_torch.sparse.types import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from cgx_torch.kernels import _build
        _build.library()
    a = poisson3d_dia(16, 16, 16, dtype=np.float32, device=dev)
    b = torch.ones((a.shape[0],), dtype=torch.float32, device=dev)

    def fn(a, b):
        m = cgx_torch.JacobiPrecond(inv_diag=1.0 / a.diagonal())
        res = cgx_torch.cg_solve(a, b, tol=1e-5, maxiter=200,
                                 preconditioner=m)
        return res.x, res.iterations, res.residual_norm_sq

    return fn, (a, b)


def _check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun: {msg}")


def _norm(v) -> float:
    return float(np.linalg.norm(np.asarray(v, np.float64)))


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy()


def _dryrun(mesh) -> bool:
    """Every stage of the dry run on this rank of ``mesh`` (every rank
    runs it)."""
    import scipy.sparse as sp
    import torch

    from cgx_torch.dist import (dist_cg_solve, dist_fused_cg,
                                dist_fused_cg_multi, gather_rows,
                                partition_csr, partition_dia, unpad_vector)
    from cgx_torch.dist.hp import (dist_ir_df64_solve,
                                   dist_ir_df64_solve_multi)
    from cgx_torch.dist.wbell import (dist_wbell_cg_solve,
                                      dist_wbell_cg_solve_multi,
                                      partition_wbell)
    from cgx_torch.io.poisson import poisson2d, poisson3d_dia
    from cgx_torch.ops.df64 import df_to_f64
    from cgx_torch.ops.spmv import spmv
    from cgx_torch.sparse.stencil import poisson3d_stencil

    nd, dev = mesh.size, mesh.device

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def whole(res, n):
        return unpad_vector(gather_rows(res.x, mesh), n)

    # Halo-mode partition of a DIA operator (ring exchange).
    a = poisson3d_dia(8, 6, 7, dtype=np.float32, device=dev)
    n = a.shape[0]
    b = ones(n)
    part = partition_dia(a, nd)
    res = dist_cg_solve(part, b, mesh, tol=1e-4, maxiter=300, jacobi=True)
    x = whole(res, n)
    _check(bool(res.converged), "halo-mode CG did not converge")
    _check(_norm(_host(b - spmv(a, x))) <= 1e-3 * _norm(_host(b)),
           "halo-mode residual")

    # All-gather partition of a CSR matrix.
    a2 = poisson2d(12, 11, dtype=np.float32, device=dev)
    n2 = a2.shape[0]
    part2 = partition_csr(a2, nd, mode="allgather")
    b2 = ones(n2)
    res2 = dist_cg_solve(part2, b2, mesh, tol=1e-4, maxiter=300)
    _check(bool(res2.converged), "allgather-mode CG did not converge")

    # The Schwarz block-IC(0) sweep preconditioner.
    res_ic = dist_cg_solve(part, b, mesh, tol=1e-4, maxiter=300,
                           preconditioner="ic0_sweep", nsweeps=1)
    _check(bool(res_ic.converged), "ic0_sweep PCG did not converge")

    # Pipelined CG: one overlapped reduction an iteration.
    res_pl = dist_cg_solve(part, b, mesh, tol=1e-4, maxiter=300,
                           preconditioner="jacobi", method="pipelined")
    _check(bool(res_pl.converged), "pipelined CG did not converge")

    # The fused engine across ranks (K3 with ghost x-planes).
    s = poisson3d_stencil(2 * nd, 6, 7)
    ns = s.shape[0]
    bs = ones(ns)
    res_f = dist_fused_cg(s, bs, mesh, tol=1e-4, maxiter=300)
    _check(bool(res_f.converged), "dist fused CG did not converge")
    rf = bs - spmv(s, whole(res_f, ns))
    _check(_norm(_host(rf)) <= 1e-3 * _norm(_host(bs)),
           "dist fused CG residual")

    # Fused DIA Jacobi-PCG (the scaled planes).
    a_f = poisson3d_dia(2 * nd, 6, 7, dtype=np.float32, device=dev)
    res_fd = dist_fused_cg(a_f, ones(a_f.shape[0]), mesh, jacobi=True,
                           tol=1e-4, maxiter=300)
    _check(bool(res_fd.converged), "dist fused DIA PCG did not converge")

    # An uneven nx: padded with decoupled planes.
    s_u = poisson3d_stencil(2 * nd + 1, 6, 7)
    nu = s_u.shape[0]
    bu = ones(nu)
    res_u = dist_fused_cg(s_u, bu, mesh, tol=1e-4, maxiter=300)
    _check(bool(res_u.converged), "uneven-nx fused CG did not converge")
    xu = whole(res_u, nu)
    _check(tuple(xu.shape) == (nu,), f"uneven-nx x of shape {xu.shape}")
    _check(_norm(_host(bu - spmv(s_u, xu))) <= 1e-3 * _norm(_host(bu)),
           "uneven-nx residual")

    # The fused multi-RHS engine across ranks (K5).
    bmk = torch.stack([bs, 0.5 * bs + 0.1], dim=1)
    res_m = dist_fused_cg_multi(s, bmk, mesh, tol=1e-4, maxiter=300)
    _check(bool(res_m.converged.all()),
           "dist fused multi-RHS CG did not converge")

    # The row-partitioned WBELL engine (K7 on each shard).
    aw = sp.random(40 * nd * 32, 40 * nd * 32, density=0.01,
                   random_state=5, format="csr")
    aw = sp.csr_matrix((aw + aw.T) + sp.eye(aw.shape[0]) * 30.0)
    part_w = partition_wbell(aw, nd)
    bw = ones(aw.shape[0])
    res_w = dist_wbell_cg_solve(part_w, bw, mesh, tol=1e-4, maxiter=300,
                                preconditioner="jacobi")
    _check(bool(res_w.converged), "dist WBELL PCG did not converge")
    rw = _host(bw) - aw @ _host(res_w.x).astype(np.float64)
    _check(_norm(rw) <= 1e-3 * _norm(_host(bw)), "dist WBELL residual")

    # WBELL multi-RHS (K8 over each shard's tier plan).
    bwm = torch.stack([bw, 0.5 * bw + 0.1], dim=1)
    res_wm = dist_wbell_cg_solve_multi(part_w, bwm, mesh, tol=1e-4,
                                       maxiter=300, jacobi=True)
    _check(bool(res_wm.converged.all()),
           "dist WBELL multi-RHS did not converge")

    # The df64 refinement across ranks over WBELL inners, on a sparser
    # ill-conditioned matrix (~4 nonzeros a row).
    n_hp = 1024 * nd
    a_hp = sp.random(n_hp, n_hp, density=3.0 / n_hp, random_state=7,
                     format="csr")
    a_hp = sp.csr_matrix((a_hp + a_hp.T) + sp.eye(n_hp) * 4.0)
    d_sc = sp.diags(np.logspace(0, 3.0, n_hp))
    aw_ill = sp.csr_matrix(d_sc @ a_hp @ d_sc)
    aw_ill.sort_indices()
    bw64 = np.ones(n_hp, np.float64)
    res_hp, _ = dist_ir_df64_solve(aw_ill, bw64, mesh, tol=1e-6,
                                   inner_tol=1e-2, inner_maxiter=2000)
    _check(bool(res_hp.converged), "dist df64 IR did not converge")
    true_hp = _norm(bw64 - aw_ill @ df_to_f64(res_hp.x)) / _norm(bw64)
    _check(true_hp <= 1.5e-6, f"dist df64 TRUE relres {true_hp}")

    # The multi-RHS df64 refinement across ranks.
    bw2 = np.stack([bw64, 0.5 * bw64 + 0.1], axis=1)
    res_hm, _ = dist_ir_df64_solve_multi(aw_ill, bw2, mesh, tol=1e-6,
                                         inner_tol=1e-2, inner_maxiter=2000)
    _check(bool(np.asarray(res_hm.converged).all()),
           "dist multi df64 did not converge")
    xm = df_to_f64(res_hm.x)
    for j in range(2):
        tr = _norm(bw2[:, j] - aw_ill @ xm[:, j]) / _norm(bw2[:, j])
        _check(tr <= 1.5e-6, f"dist multi df64 col {j}: {tr}")

    # The 2-D (rows × cols) grid on the first r² ranks.
    r = int(nd ** 0.5)
    if r * r >= 4:
        from cgx_torch.dist.grid2d import (dist_cg_solve_2d, make_grid_mesh,
                                           partition_csr_2d)
        grid = make_grid_mesh(r, device=dev)
        if grid is not None:
            res3 = dist_cg_solve_2d(partition_csr_2d(a2, r), b2, grid,
                                    tol=1e-4, maxiter=300, jacobi=True)
            _check(bool(res3.converged), "2-D CG did not converge")
    return True


def dryrun_multichip(n_devices: int, device="cpu") -> None:
    """The dry run on ``n_devices`` ranks.  Inside a process group (under
    ``torchrun``: NCCL on cards, one card a rank) every rank calls this and
    ``n_devices`` must be the group's size.  Without a group,
    ``device="cpu"`` spawns ``n_devices`` gloo ranks; ``device="cuda"``
    raises, since NCCL refuses two ranks on one card.  A failed stage
    raises."""
    import torch.distributed as dist

    from cgx_torch.dist.launch import make_row_mesh, run_spmd

    if dist.is_initialized():
        _dryrun(make_row_mesh(n_devices, device=device))
    elif device == "cpu":
        run_spmd(_dryrun, int(n_devices))
    else:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on {device} needs a process "
            f"group of {n_devices} ranks, one card each: run it under "
            f"`torchrun --nproc-per-node {n_devices}`, or pass "
            f"device='cpu' to spawn gloo ranks")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m cgx_torch.graft_entry")
    ap.add_argument("which", nargs="?", default="entry",
                    choices=["entry", "dryrun"])
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks of the dry run")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="entry: cuda (default; without a card it exits "
                         "non-zero); dryrun: cpu (default, spawned gloo "
                         "ranks) or cuda under torchrun")
    args = ap.parse_args(argv)
    if args.which == "entry":
        fn, fargs = entry(args.device or "cuda")
        x, its, rr = fn(*fargs)
        print(f"entry ok: x {tuple(x.shape)}, {int(its)} iterations, "
              f"|r|^2 {float(rr):.3e}")
    else:
        import os

        if "WORLD_SIZE" in os.environ:          # under torchrun
            from cgx_torch.dist.launch import initialize
            initialize(device=args.device or "cuda")
        dryrun_multichip(args.n, args.device or "cpu")
        print(f"dryrun_multichip({args.n}) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

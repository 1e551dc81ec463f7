"""Distributed df64 iterative refinement: TRUE relres ≤ tol across ranks.

Counterpart of :mod:`cgx.dist.hp`: the df64 refinement of
:mod:`cgx_torch.solve.hp` over the row-partitioned WBELL engine of
:mod:`cgx_torch.dist.wbell`.

* **The sharded df64 true residual.**  The fp64 operator is split hi + lo
  into a row-partitioned ELL (:class:`DistDF64ELL`) over the WBELL
  partition's RCM ordering and group slabs, so a rank's df64 rows are
  exactly its WBELL slab and the outer and inner loops share vectors.  The
  columns a shard reads lie in a band around its slab: one ring exchange
  of ``halo_lo``/``halo_hi`` boundary ENTRIES (several ring steps where a
  halo is wider than a shard) carries both words of x, for every column.
* **The df64 words** are eager torch ops in the JAX package's order
  (:mod:`cgx_torch.ops.df64`): error-free products, a pairwise fold along
  the ELL width, the residual and its ‖r‖² on the shard.  Across ranks
  the two words of ‖r‖² travel in one all-reduce and are then added, the
  JAX package's ``psum(hi) + psum(lo)``.
* **The inners** are fp32 solves through K7
  (:func:`~cgx_torch.dist.wbell.dist_wbell_cg_solve_internal`) or K8
  (the multi-RHS form) on the unit residual, already in the rank's slab.

The outer loop (strikes, ``max_outer``, resume from ``x0``) is the JAX
package's line for line; it reads the device once a cycle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.dist.halo import all_reduce, halo_exchange
from cgx_torch.dist.launch import RowMesh
from cgx_torch.dist.solve import gather_rows
from cgx_torch.dist.wbell import (WBellPartition, _multi_solve_internal,
                                  dist_wbell_cg_solve_internal,
                                  partition_wbell)
from cgx_torch.ops.df64 import (DF64, _fold_axis, df_add, df_dot, df_mul,
                                df_mul_f32, df_sub, quick_two_sum, two_prod)
from cgx_torch.solve.hp import HPCGResult, _scipy_f64
from cgx_torch.sparse.types import resolve_device

__all__ = ["DistDF64ELL", "LocalDF64ELL", "partition_df64_ell",
           "make_dist_ir_df64_solver", "dist_ir_df64_solve",
           "make_dist_ir_df64_solver_multi", "dist_ir_df64_solve_multi"]


@dataclass(frozen=True, eq=False)
class LocalDF64ELL:
    """One shard of a :class:`DistDF64ELL` on its device."""

    vhi: torch.Tensor           # (R, w) fp32
    vlo: torch.Tensor           # (R, w) fp32
    cols: torch.Tensor          # (R, w) int64, halo-extended local index
    halo_lo: int
    halo_hi: int


@dataclass(frozen=True, eq=False)
class DistDF64ELL:
    """Row-partitioned df64 ELL operator in the WBELL partition's RCM
    ordering: host arrays stacked on a leading shard axis.  ``halo_lo``/
    ``halo_hi`` are the boundary ENTRIES (permuted order) a shard needs
    from the ranks before and after it."""

    vhi: np.ndarray             # (nd, R, w) fp32, R = gs·1024 rows a shard
    vlo: np.ndarray             # (nd, R, w) fp32
    cols: np.ndarray            # (nd, R, w) int32, LOCAL extended indices
    shape: Tuple[int, int]
    n_shards: int
    rows_per_shard: int
    halo_lo: int
    halo_hi: int

    @property
    def width(self) -> int:
        return self.vhi.shape[2]

    def local(self, rank: int, device="cuda") -> LocalDF64ELL:
        """Shard ``rank``'s arrays on ``device`` (columns int64)."""
        dev = resolve_device(device)

        def take(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a[rank])).to(dev)
            return t if dtype is None else t.to(dtype)

        return LocalDF64ELL(vhi=take(self.vhi), vlo=take(self.vlo),
                            cols=take(self.cols, torch.int64),
                            halo_lo=self.halo_lo, halo_hi=self.halo_hi)


def partition_df64_ell(a, part: WBellPartition) -> DistDF64ELL:
    """Split the host fp64 CSR into the sharded df64 ELL aligned with
    ``part`` (its permutation, its ``gs``-group row slabs).  hi is the fp32
    rounding of each fp64 value and lo the exact remainder, so the outer
    residual targets the true system.  Only one slab is densified at a
    time."""
    a = _scipy_f64(a)
    n = a.shape[0]
    ap = a[part.perm][:, part.perm].tocsr()
    ap.sort_indices()
    nd = part.n_shards
    R = part.gs * 1024
    counts = np.diff(ap.indptr)
    w = max(1, -(-int(counts.max()) // 8) * 8)

    def slab_ell(d):
        """Shard d's ELL slab (global columns; -1 marks an empty slot)."""
        r0, r1 = d * R, min((d + 1) * R, n)
        vals64 = np.zeros((R, w), np.float64)
        gcols = np.full((R, w), -1, np.int64)
        if r0 < n:
            sub = ap[r0:r1]
            c = np.diff(sub.indptr)
            rows = np.repeat(np.arange(r1 - r0), c)
            offs = (np.concatenate([np.arange(k) for k in c])
                    if sub.nnz else np.zeros(0, np.int64))
            vals64[rows, offs] = sub.data
            gcols[rows, offs] = sub.indices
        return vals64, gcols

    # The halos in ENTRIES, from the columns each slab reads (RCM keeps
    # them a band).  Each side is at most (nd-1)·R, so a referenced entry
    # is at most nd-1 ring steps away; the slots a cyclic wrap fills are
    # read by no real column.
    halo_lo = halo_hi = 0
    for d in range(nd):
        r0, r1 = d * R, min((d + 1) * R, n)
        if r0 >= n or ap.indptr[r0] == ap.indptr[r1]:
            continue
        cs = ap.indices[ap.indptr[r0]:ap.indptr[r1]]
        halo_lo = max(halo_lo, d * R - int(cs.min()))
        halo_hi = max(halo_hi, int(cs.max()) + 1 - (d + 1) * R)
    halo_lo, halo_hi = max(halo_lo, 0), max(halo_hi, 0)

    # Local extended indices; an empty slot reads the shard's first entry
    # (its coefficient is zero).
    lcols = np.empty((nd, R, w), np.int32)
    svhi = np.empty((nd, R, w), np.float32)
    svlo = np.empty((nd, R, w), np.float32)
    for d in range(nd):
        v, g = slab_ell(d)
        lcols[d] = np.where(g >= 0, g - d * R + halo_lo, halo_lo)
        hi = v.astype(np.float32)
        svhi[d] = hi
        svlo[d] = (v - hi.astype(np.float64)).astype(np.float32)
    return DistDF64ELL(vhi=svhi, vlo=svlo, cols=lcols,
                       shape=(int(a.shape[0]), int(a.shape[1])),
                       n_shards=nd, rows_per_shard=R, halo_lo=int(halo_lo),
                       halo_hi=int(halo_hi))


def _flat(v: torch.Tensor) -> torch.Tensor:
    """(gs, 8, 128) internal slab → (gs·1024,) permuted-order slab (a local
    reshape: the two layouts share the group slabs)."""
    return v.transpose(1, 2).reshape(-1)


def _unflat(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 128, 8).transpose(1, 2)


def _df64_rows(opd: LocalDF64ELL, x_ext: torch.Tensor) -> DF64:
    """The df64 product of the shard's rows: ``x_ext`` ``(halo_lo + R +
    halo_hi, 2, ...)`` holds x's hi and lo words (and any columns behind
    them); the products are error-free and each row a pairwise fold along
    the width, the JAX package's expressions in its order."""
    g = x_ext[opd.cols]                       # (R, w, 2, ...)
    gh, gl = g[:, :, 0], g[:, :, 1]
    extra = (None,) * (gh.dim() - 2)
    vhi = opd.vhi[(...,) + extra]
    vlo = opd.vlo[(...,) + extra]
    p, e = two_prod(vhi, gh)
    e = e + (vhi * gl + vlo * gh + vlo * gl)
    p, e = quick_two_sum(p, e)
    return _fold_axis(DF64(p, e), axis=1)


def _cross_rank(rr_loc: DF64, mesh: RowMesh) -> torch.Tensor:
    """Σ over the ranks of the hi words plus Σ of the lo words, from one
    all-reduce of the two stacked (the JAX package's ``psum(hi) +
    psum(lo)``): a convergence-control scalar, never the iterate."""
    s = all_reduce(torch.stack([rr_loc.hi, rr_loc.lo]), mesh.group)
    return s[0] + s[1]


def _local_true_residual(opd: LocalDF64ELL, bh, bl, xh, xl, mesh: RowMesh):
    """One shard's df64 ``r = b − A·x`` (internal slabs ``(gs, 8, 128)``)
    and the global ‖r‖²: one ring exchange of x's two words, one
    all-reduce."""
    x_ext = halo_exchange(torch.stack([_flat(xh), _flat(xl)], 1),
                          opd.halo_lo, opd.halo_hi, mesh)
    y = _df64_rows(opd, x_ext)                # (R,) df64
    r = df_sub(DF64(_flat(bh), _flat(bl)), y)
    rr = _cross_rank(df_dot(r, r), mesh)
    return _unflat(r.hi), _unflat(r.lo), rr


def _flatk(v: torch.Tensor) -> torch.Tensor:
    """(k, gs, 8, 128) → (gs·1024, k)."""
    return torch.stack([_flat(v[j]) for j in range(v.shape[0])], dim=1)


def _unflatk(v: torch.Tensor) -> torch.Tensor:
    """(gs·1024, k) → (k, gs, 8, 128)."""
    return torch.stack([_unflat(v[:, j]) for j in range(v.shape[1])])


def _local_true_residual_multi(opd: LocalDF64ELL, bh, bl, xh, xl,
                               mesh: RowMesh):
    """One shard's batched df64 ``R = B − A·X`` (slabs ``(k, gs, 8,
    128)``) and the per-column global ‖r‖² ``(k,)``: one ring exchange
    carries both words of every column, one all-reduce."""
    x_ext = halo_exchange(torch.stack([_flatk(xh), _flatk(xl)], 1),
                          opd.halo_lo, opd.halo_hi, mesh)
    y = _df64_rows(opd, x_ext)                # (R, k) df64
    r = df_sub(DF64(_flatk(bh), _flatk(bl)), y)
    rr = _cross_rank(_fold_axis(df_mul(r, r), axis=0), mesh)
    return _unflatk(r.hi), _unflatk(r.lo), rr


def _split(part: WBellPartition, b64: np.ndarray, mesh: RowMesh):
    """The rank's internal slabs of a host fp64 vector's (or (n, k)
    block's) hi and lo words."""
    hi = b64.astype(np.float32)
    lo = (b64 - hi.astype(np.float64)).astype(np.float32)
    return tuple(_slab_of(part, w, mesh) for w in (hi, lo))


def _slab_of(part: WBellPartition, v, mesh: RowMesh) -> torch.Tensor:
    """The rank's slab of a standard-order vector, or of each column of an
    (n, k) block (then ``(k, gs, 8, 128)``), on the mesh's device."""
    t = torch.as_tensor(v).to(mesh.device)
    if t.dim() == 1:
        return part.slab(part.to_internal(t), mesh.rank)
    return part.slab(torch.stack([part.to_internal(t[:, j])
                                  for j in range(t.shape[1])]), mesh.rank)


def _gather_words(part: WBellPartition, xh, xl, mesh: RowMesh) -> DF64:
    """The whole standard-order df64 iterate on every rank from the ranks'
    slabs (one all-gather of both words; (k, gs, 8, 128) slabs give (n,
    k))."""
    if xh.dim() == 3:
        g = gather_rows(torch.stack([xh, xl], 1), mesh)   # (nd·gs, 2, 8, 128)
        return DF64(part.from_internal(g[:, 0]), part.from_internal(g[:, 1]))
    g = gather_rows(torch.stack([xh, xl]).movedim(2, 0), mesh)
    words = [torch.stack([part.from_internal(g[:, w, j])
                          for j in range(g.shape[2])], dim=1)
             for w in (0, 1)]
    return DF64(*words)


def _setup(a, mesh: RowMesh, span: int, per_shard: bool):
    part = partition_wbell(a, mesh.size, span=span, per_shard=per_shard)
    opd = partition_df64_ell(a, part)
    return part, opd, opd.local(mesh.rank, mesh.device)


def make_dist_ir_df64_solver(
    a,
    mesh: RowMesh,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 2000,
    max_outer: int = 40,
    inner_precond: str = "jacobi",
    method: str = "cg",
    poly_steps: int = 3,
    inner_chunk: Optional[int] = None,
    span: int = 16,
    per_shard: bool = False,
    verbose: bool = False,
):
    """Factory; every rank calls it: fp32 WBELL inners across the ranks
    (K7) inside a df64 true-residual outer, to TRUE relres ≤ tol.  Returns
    ``solve(b, x0=None) -> (HPCGResult, info)``.

    The host builds (the WBELL partition,
    :func:`~cgx_torch.dist.wbell.partition_wbell`, and the aligned df64
    ELL, :func:`partition_df64_ell`) are paid here once; every ``solve``
    reuses them and the shard's row layout.

    Args:
      a: host fp64 CSR (a CSR container or scipy).
      inner_precond: ``"none" | "jacobi" | "block_jacobi" | "poly"``.
      method: the inner loop (``cg``, ``single_reduction``, ``pipelined``,
        ``chebyshev``).
      inner_chunk: each inner call runs at most this many iterations and
        restarts from its iterate (a restart of the Krylov space; the
        outer only needs the inner's residual reduction).

    ``b`` is a host fp64 ``(n,)`` vector and ``x0`` a standard-order
    :class:`~cgx_torch.ops.df64.DF64` iterate (a preempted solve's
    ``res.x``): the first residual is recomputed from it, so the outer
    resumes where it stopped.  ``info["relres"]`` is the final TRUE df64
    relative residual; ``iterations`` counts the inner iterations; the
    result's ``x`` is the whole df64 solution on every rank."""
    part, opd, loc = _setup(a, mesh, span, per_shard)
    n = part.n

    def inner(r_unit):
        if inner_chunk is None:
            res = dist_wbell_cg_solve_internal(
                part, r_unit, mesh, tol=inner_tol, maxiter=inner_maxiter,
                preconditioner=inner_precond, poly_steps=poly_steps,
                method=method)
            return res.x, int(res.iterations)
        total = 0
        x0i = None
        while True:
            # maxiter stays inner_chunk on the last chunk too (the JAX
            # package's choice: a shorter cap would recompile there).
            res = dist_wbell_cg_solve_internal(
                part, r_unit, mesh, x0i=x0i, tol=inner_tol,
                maxiter=int(inner_chunk), preconditioner=inner_precond,
                poly_steps=poly_steps, method=method)
            total += int(res.iterations)
            if bool(res.converged) or total >= inner_maxiter:
                return res.x, total
            x0i = res.x

    def solve(b, x0: Optional[DF64] = None):
        b64 = np.asarray(torch.as_tensor(b).cpu().numpy(), np.float64)
        bb = float(np.dot(b64, b64))
        tol_sq = max(tol * tol * bb, atol * atol)
        bh, bl = _split(part, b64, mesh)
        if x0 is None:
            xh, xl = torch.zeros_like(bh), torch.zeros_like(bl)
        else:
            xh, xl = _slab_of(part, x0.hi, mesh), _slab_of(part, x0.lo, mesh)

        rr = bb
        total = outer = strikes = 0
        while outer < max_outer and strikes < 2:
            rh, rl, rr_dev = _local_true_residual(loc, bh, bl, xh, xl, mesh)
            rr_new = float(rr_dev)
            if outer:
                strikes = 0 if rr_new < rr else strikes + 1
            rr = rr_new
            if verbose and mesh.rank == 0:
                print(f"[dist_ir_df64] cycle {outer}: true relres "
                      f"{np.sqrt(max(rr, 0.0) / bb):.3e}")
            if rr <= tol_sq or strikes >= 2:
                break
            s = float(np.sqrt(rr))
            inv_s = torch.tensor(np.float32(1.0 / s), device=mesh.device)
            d, k_in = inner(rh * inv_s + rl * inv_s)
            x = df_add(DF64(xh, xl), df_mul_f32(DF64(d, torch.zeros_like(d)),
                                                torch.tensor(np.float32(s),
                                                             device=d.device)))
            xh, xl = x.hi, x.lo
            total += k_in
            outer += 1

        res = HPCGResult(x=_gather_words(part, xh, xl, mesh),
                         iterations=torch.tensor(total, dtype=torch.int32),
                         residual_norm_sq=torch.tensor(rr,
                                                       dtype=torch.float32),
                         converged=torch.tensor(rr <= tol_sq))
        info = dict(outer=outer, relres=float(np.sqrt(max(rr, 0.0) / bb)),
                    inner_iterations=total, n_shards=mesh.size, n=n)
        return res, info

    solve.partition = part
    solve.df64_operator = opd
    return solve


def dist_ir_df64_solve(a, b, mesh: RowMesh, **kw):
    """One-shot form of :func:`make_dist_ir_df64_solver` (see there)."""
    return make_dist_ir_df64_solver(a, mesh, **kw)(b)


def make_dist_ir_df64_solver_multi(
    a,
    mesh: RowMesh,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 2000,
    max_outer: int = 40,
    inner_jacobi: bool = True,
    inner_chunk: Optional[int] = None,
    span: int = 16,
    per_shard: bool = False,
    verbose: bool = False,
):
    """df64 accuracy × row-sharded ranks × a block of right-hand sides;
    every rank calls it.  Batched inners across the ranks (K8 over each
    shard's tier plan, one ring exchange an iteration for every column)
    inside a batched df64 true-residual outer (one exchange of both words
    of every column a cycle, per-column ‖r‖²).

    Returns ``solve(B) -> (HPCGResult, info)`` with ``B`` host fp64 ``(n,
    k)``; the scalar fields carry a ``(k,)`` axis.  The inner runs in the
    rank's internal slabs, not in standard order as the JAX package's
    does (its round trip through the permutation is exact).
    ``inner_chunk`` warm-restarts the batched inner from its iterate (the
    JAX package's form passes an ``x0`` its inner solver does not take)."""
    part, opd, loc = _setup(a, mesh, span, per_shard)
    n = part.n

    def inner(r_unit):
        kw = dict(tol=float(inner_tol), atol=0.0, jacobi=bool(inner_jacobi),
                  tiered=None)
        if inner_chunk is None:
            res = _multi_solve_internal(part, r_unit, mesh,
                                        maxiter=int(inner_maxiter), **kw)
            return res.x, int(res.iterations.max())
        total = 0
        x0i = None
        while True:
            res = _multi_solve_internal(part, r_unit, mesh, x0i=x0i,
                                        maxiter=int(inner_chunk), **kw)
            total += int(res.iterations.max())
            if bool(res.converged.all()) or total >= inner_maxiter:
                return res.x, total
            x0i = res.x

    def solve(B):
        B = np.asarray(torch.as_tensor(B).cpu().numpy(), np.float64)
        if B.ndim != 2:
            raise ValueError(f"expected an (n, k) block, got {B.shape}")
        bb = np.einsum("nk,nk->k", B, B)
        tol_sq = np.maximum(tol * tol * bb, atol * atol)
        bh, bl = _split(part, B, mesh)
        xh, xl = torch.zeros_like(bh), torch.zeros_like(bl)

        rr = bb.copy()
        total = outer = strikes = 0
        while outer < max_outer and strikes < 2:
            rh, rl, rr_dev = _local_true_residual_multi(loc, bh, bl, xh, xl,
                                                        mesh)
            rr_new = rr_dev.cpu().numpy().astype(np.float64)
            active = rr_new > tol_sq
            if outer:
                prev_active = rr > tol_sq
                worse = ((rr_new >= rr)[prev_active].all()
                         if prev_active.any() else True)
                strikes = strikes + 1 if worse else 0
            rr = rr_new
            if verbose and mesh.rank == 0:
                print(f"[dist_ir_df64_multi] cycle {outer}: true relres "
                      f"{np.sqrt(np.maximum(rr, 0) / bb)}")
            if not active.any() or strikes >= 2:
                break
            s = np.sqrt(np.where(active, rr, 1.0))
            inv_s = torch.from_numpy(np.where(active, 1.0 / s, 0.0).astype(
                np.float32)).to(mesh.device)[:, None, None, None]
            d, k_in = inner(rh * inv_s + rl * inv_s)
            s32 = torch.from_numpy(s.astype(np.float32)).to(
                mesh.device)[:, None, None, None]
            x = df_add(DF64(xh, xl), df_mul_f32(DF64(d, torch.zeros_like(d)),
                                                s32))
            xh, xl = x.hi, x.lo
            total += k_in
            outer += 1

        conv = rr <= tol_sq
        res = HPCGResult(x=_gather_words(part, xh, xl, mesh),
                         iterations=torch.tensor(total, dtype=torch.int32),
                         residual_norm_sq=torch.from_numpy(
                             rr.astype(np.float32)),
                         converged=torch.from_numpy(conv))
        info = dict(outer=outer,
                    relres=np.sqrt(np.maximum(rr, 0.0) / bb).tolist(),
                    inner_iterations=total, n_shards=mesh.size, n=n)
        return res, info

    solve.partition = part
    solve.df64_operator = opd
    return solve


def dist_ir_df64_solve_multi(a, B, mesh: RowMesh, **kw):
    """One-shot form of :func:`make_dist_ir_df64_solver_multi`."""
    return make_dist_ir_df64_solver_multi(a, mesh, **kw)(B)

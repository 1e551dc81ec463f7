"""Row-distributed CG: one rank's rows of every vector, its local operator.

Counterpart of :mod:`cgx.dist.solve`.  Every rank calls
:func:`dist_cg_solve` with the same arguments (SPMD); the rank's shard of
the :class:`~cgx_torch.dist.partition.Partition` moves to its device, and
the port's own loops run on its rows with ``group=``: per iteration the
only traffic is the halo exchange (or all-gather) inside the local product
and the loop's all-reduces of stacked dots (two for ``"cg"``, one for
``"single_reduction"`` and ``"pipelined"``, none between the checks of
``"chebyshev"``).  Each rank gets back its own rows of the padded
solution; :func:`gather_rows` assembles the global vector (one all-gather
a solve).

The JAX package's ``operator_specs`` (the ``PartitionSpec`` tree of a
``Partition`` for ``shard_map``) has no counterpart: the port moves a
shard's arrays itself (:meth:`Partition.local`).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from cgx_torch.dist.halo import all_gather, local_matvec
from cgx_torch.dist.launch import RowMesh, make_row_mesh
from cgx_torch.dist.partition import LocalPartition, Partition
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult, cg_solve

__all__ = ["AXIS", "dist_cg_solve", "make_row_mesh", "gather_rows",
           "local_rows"]

# The JAX package's mesh axis name, kept for callers of both packages.
AXIS = "rows"


def local_rows(v, mesh: RowMesh, rows_local: int, dtype=None):
    """This rank's rows ``[rank·rows_local, (rank+1)·rows_local)`` of a
    global vector (numpy or torch, 1-D or ``(n, k)``), zero-padded past its
    end, on the mesh's device."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v))
    lo = mesh.rank * rows_local
    part = v[lo:lo + rows_local]
    if part.shape[0] < rows_local:
        pad = torch.zeros((rows_local - part.shape[0],) + tuple(v.shape[1:]),
                          dtype=v.dtype, device=v.device)
        part = torch.cat([part, pad])
    part = part.to(mesh.device)
    return part if dtype is None else part.to(dtype)


def gather_rows(x_local: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The global padded vector from every rank's rows (one all-gather,
    counted; every rank gets it)."""
    return all_gather(x_local, mesh.group)


def _local_diag(a_loc: LocalPartition) -> torch.Tensor:
    """Diagonal of this shard's rows, from the local operator layout."""
    if a_loc.kind == "dia":
        return a_loc.dia_data[:, a_loc.dia_offsets.index(0)]
    vals, cols = a_loc.ell_values, a_loc.ell_cols
    rl = vals.shape[0]
    own = torch.arange(rl, device=cols.device)[:, None]
    own = own + (a_loc.halo_lo if a_loc.mode == "halo" else a_loc.first_row)
    return torch.sum(torch.where(cols == own, vals, torch.zeros_like(vals)),
                     dim=1)


def _local_block_inverses(a_loc: LocalPartition, bs: int) -> torch.Tensor:
    """Dense inverses of the ``(bs, bs)`` diagonal blocks of this shard's
    rows, from the local layout only (``rows_local % bs == 0``, so no block
    straddles two shards).  Zero diagonal slots (padding or empty rows) get
    1, as :class:`~cgx_torch.solve.precond.BlockJacobiPrecond` does, so the
    sharded PCG follows the single-device one."""
    rl = a_loc.rows_local
    if rl % bs:
        raise ValueError(f"blocksize {bs} must divide rows_local {rl}")
    nb = rl // bs
    dev = (a_loc.dia_data if a_loc.kind == "dia" else a_loc.ell_values).device
    i_loc = torch.arange(rl, device=dev)
    if a_loc.kind == "dia":
        data = a_loc.dia_data
        blocks = torch.zeros((nb, bs, bs), dtype=data.dtype, device=dev)
        ir = i_loc % bs
        for k, off in enumerate(a_loc.dia_offsets):
            ic = ir + off
            ok = (ic >= 0) & (ic < bs)
            blocks.index_put_((i_loc // bs, ir, ic.clamp(0, bs - 1)),
                              torch.where(ok, data[:, k],
                                          torch.zeros_like(data[:, k])),
                              accumulate=True)
    else:
        vals, cols = a_loc.ell_values, a_loc.ell_cols
        first = a_loc.first_row
        col_g = cols + first - a_loc.halo_lo if a_loc.mode == "halo" \
            else cols
        row_g = (first + i_loc)[:, None]
        ic = col_g - (row_g // bs) * bs
        ok = (col_g // bs) == (row_g // bs)
        ir = (i_loc % bs)[:, None].expand_as(cols)
        blk = (i_loc // bs)[:, None].expand_as(cols)
        blocks = torch.zeros((nb, bs, bs), dtype=vals.dtype, device=dev)
        blocks.index_put_((blk, ir, ic.clamp(0, bs - 1)),
                          torch.where(ok, vals, torch.zeros_like(vals)),
                          accumulate=True)
    di = torch.arange(bs, device=dev)
    d = blocks[:, di, di]
    blocks[:, di, di] = torch.where(d == 0, torch.ones_like(d), d)
    return torch.linalg.inv(blocks)


def _make_local_precond(a_loc: LocalPartition, kind: str, mv, *,
                        blocksize: int, poly_steps: int, ic0_blocks=None,
                        nsweeps: int = 1):
    """This shard's preconditioner, built from its own rows with no
    traffic (``ic0_sweep`` takes host-factored blocks)."""
    if kind == "none":
        return None
    if kind == "ic0_sweep":
        from cgx_torch.dist.schwarz import sweep_apply
        return partial(sweep_apply, ic0_blocks, nsweeps)
    if kind == "jacobi":
        inv = safe_recip(_local_diag(a_loc))
        return lambda r: inv * r
    if kind == "block_jacobi":
        inv_blocks = _local_block_inverses(a_loc, blocksize)
        bs = blocksize

        def apply_bj(r):
            zb = torch.einsum("bij,bj->bi", inv_blocks.to(r.dtype),
                              r.reshape(-1, bs))
            return zb.reshape(-1)

        return apply_bj
    if kind == "poly":
        from cgx_torch.solve.precond import PolynomialPrecond
        inv = safe_recip(_local_diag(a_loc))
        return PolynomialPrecond(mv, inv, steps=poly_steps).apply
    raise ValueError(f"unknown preconditioner {kind!r} (distributed path "
                     "supports none/jacobi/block_jacobi/poly/ic0_sweep)")


def dist_cg_solve(
    part: Partition,
    b,
    mesh: RowMesh,
    *,
    x0=None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    jacobi: bool = False,
    preconditioner: Optional[str] = None,
    blocksize: int = 8,
    poly_steps: int = 3,
    nsweeps: int = 1,
    track_history: bool = False,
    method: str = "cg",
    adaptive_replace: bool = False,
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
    blocks=None,
) -> CGResult:
    """Solve ``A x = b`` with row-sharded (P)CG; every rank calls it.

    ``b`` (and ``x0``) are the global vectors, true length or padded, on
    any device; each rank takes its rows.  The result's ``x`` is this
    rank's rows of the padded solution (:func:`gather_rows`, then
    :func:`~cgx_torch.dist.partition.unpad_vector`).

    ``preconditioner``: ``"none"`` | ``"jacobi"`` | ``"block_jacobi"`` |
    ``"poly"`` | ``"ic0_sweep"``, the first four built inside the shard
    from its rows (padding rows stay exactly zero), ``"ic0_sweep"`` the
    one-level additive Schwarz of :mod:`cgx_torch.dist.schwarz` (factored
    on the host; pass ``blocks`` to reuse a factorisation) with no traffic
    in its apply.  ``jacobi=True`` spells ``preconditioner="jacobi"``.

    ``method``: ``"cg"`` (two all-reduces an iteration),
    ``"single_reduction"`` and ``"pipelined"`` (one; ``adaptive_replace``
    as :func:`~cgx_torch.solve.cg.cg_solve_pipelined`'s), ``"chebyshev"``
    (none between checks; bounds ``lam_min``/``lam_max`` of ``M⁻¹A``, by
    distributed power iteration when omitted).
    """
    if maxiter is None:
        maxiter = part.n
    if preconditioner is None:
        preconditioner = "jacobi" if jacobi else "none"
    a_loc = part.local(mesh.rank, mesh.device)
    rl = part.rows_local
    b_loc = local_rows(b, mesh, rl)
    x0_loc = None if x0 is None else local_rows(x0, mesh, rl)
    if preconditioner == "ic0_sweep":
        from cgx_torch.dist.schwarz import ic0_sweep_blocks
        if blocks is None:                 # this shard's factor alone
            blocks = ic0_sweep_blocks(part, shards=[mesh.rank])
        blocks = blocks.local(mesh.rank, mesh.device)
    group = mesh.group
    mv = partial(local_matvec, a_loc, mesh=mesh)
    precond = _make_local_precond(a_loc, preconditioner, mv,
                                  blocksize=blocksize, poly_steps=poly_steps,
                                  ic0_blocks=blocks, nsweeps=nsweeps)
    kw = dict(tol=tol, maxiter=int(maxiter), preconditioner=precond,
              group=group)
    if method == "single_reduction":
        from cgx_torch.solve.cg import cg_solve_single_reduction
        return cg_solve_single_reduction(mv, b_loc, x0_loc, atol=atol, **kw)
    if method == "pipelined":
        from cgx_torch.solve.cg import cg_solve_pipelined
        return cg_solve_pipelined(mv, b_loc, x0_loc, atol=atol,
                                  adaptive_replace=adaptive_replace, **kw)
    if method == "chebyshev":
        from cgx_torch.solve.chebyshev import chebyshev_solve, estimate_bounds
        if lam_min is None or lam_max is None:
            op = mv if precond is None else (lambda v: precond(mv(v)))
            lo, hi = estimate_bounds(op, b_loc.shape[0], dtype=b_loc.dtype,
                                     device=mesh.device, group=group)
        else:
            lo, hi = lam_min, lam_max
        return chebyshev_solve(mv, b_loc, lo, hi, x0_loc, **kw)
    if method != "cg":
        raise ValueError(f"unknown method {method!r}")
    return cg_solve(mv, b_loc, x0_loc, atol=atol,
                    track_history=track_history, **kw)

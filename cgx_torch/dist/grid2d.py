"""2-D (rows × cols) operator partition on an r × r process grid.

Counterpart of :mod:`cgx.dist.grid2d`.  Block ``A[a, b]`` lives on rank
``a·r + b``; ``x`` is cut into r row blocks, block ``a`` on every rank of
grid row ``a`` (replicated over the columns, so the loop's dots need only
the ranks of one grid column).  One product:

* the transpose exchange: rank ``(a, b)`` receives block ``x_b`` from rank
  ``(b, a)`` (one message each way, the JAX package's ``_transpose_perm``);
* the local block product ``A[a, b] @ x_b`` (padded ELL, block-local
  columns);
* an all-reduce of the partials over grid row ``a`` (its "col" subgroup):
  ``y`` lands in ``x``'s layout, and CG runs unchanged with its dots summed
  over grid column ``b``.

Every rank creates every row and column subgroup, in the same order
(``torch.distributed.new_group`` requires it).  Square grids only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cgx_torch.dist.halo import all_reduce, p2p
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult, cg_solve

__all__ = ["Partition2D", "GridMesh", "partition_csr_2d", "make_grid_mesh",
           "matvec_2d", "dist_cg_solve_2d"]

ROWS, COLS = "rx", "cx"


@dataclass(frozen=True)
class Partition2D:
    """Stacked 2-D block operators (host numpy): block ``(i, j)`` is a
    padded ELL over rows ``[i·rl, (i+1)·rl)`` with columns local to block
    ``j``; padding entries have value 0 and column 0."""

    ell_values: np.ndarray    # (R, C, rl, w)
    ell_cols: np.ndarray      # (R, C, rl, w) int32, block-local columns
    n: int
    r: int
    rows_local: int

    @property
    def n_padded(self) -> int:
        return self.r * self.rows_local

    def local(self, a: int, b: int, device="cuda"):
        """Block ``(a, b)``'s ``(values, int64 columns)`` on ``device``."""
        from cgx_torch.sparse.types import resolve_device

        dev = resolve_device(device)
        return (torch.from_numpy(self.ell_values[a, b].copy()).to(dev),
                torch.from_numpy(self.ell_cols[a, b].astype(np.int64))
                .to(dev))


@dataclass(frozen=True)
class GridMesh:
    """This rank's place ``(a, b)`` in the r × r grid (rank ``a·r + b``),
    the subgroup of its grid row (``col_group``: the ranks ``(a, ·)``, over
    which the partials are summed) and of its grid column (``row_group``:
    ``(·, b)``, the CG dots), and its device."""

    r: int
    a: int
    b: int
    col_group: object
    row_group: object
    device: torch.device


def make_grid_mesh(r: int, c: Optional[int] = None,
                   device=None) -> Optional[GridMesh]:
    """The r × r grid over the first r² ranks of the default group, as
    the JAX package's grid takes the first r² devices.  Every rank of the
    group calls it (it creates every grid row's and column's subgroup, on
    every rank in the same order); a rank past the grid gets ``None``."""
    c = c or r
    if c != r:
        raise ValueError("make_grid_mesh: square grids only")
    if not dist.is_initialized():
        raise RuntimeError("make_grid_mesh: no process group")
    size, rank = dist.get_world_size(), dist.get_rank()
    if size < r * r:
        raise ValueError(f"make_grid_mesh: a {r} x {r} grid on {size} "
                         f"processes")
    rows = [dist.new_group([a * r + b for b in range(r)]) for a in range(r)]
    cols = [dist.new_group([a * r + b for a in range(r)]) for b in range(r)]
    if rank >= r * r:
        return None
    a, b = divmod(rank, r)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return GridMesh(r=r, a=a, b=b, col_group=rows[a], row_group=cols[b],
                    device=torch.device(device))


def partition_csr_2d(a, r: int) -> Partition2D:
    """Partition a CSR matrix onto an r × r grid of padded-ELL blocks."""
    def host(v):
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    vals = host(a.values)
    cols = host(a.col_indices).astype(np.int64)
    indptr = host(a.indptr)
    n = int(a.shape[0])
    counts = np.diff(indptr).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    rl = -(-n // r)
    bi, bj = rows // rl, cols // rl
    pair = rows * r + bj
    order = np.argsort(pair, kind="stable")
    pair_s = pair[order]
    slot = np.arange(len(pair_s)) - np.searchsorted(pair_s, pair_s)
    w = int(slot.max()) + 1 if len(vals) else 1
    ev = np.zeros((r, r, rl, w), dtype=vals.dtype)
    ec = np.zeros((r, r, rl, w), dtype=np.int32)
    ev[bi[order], bj[order], (rows % rl)[order], slot] = vals[order]
    ec[bi[order], bj[order], (rows % rl)[order], slot] = \
        (cols % rl)[order].astype(np.int32)
    return Partition2D(ell_values=ev, ell_cols=ec, n=n, r=r, rows_local=rl)


def _transpose_perm(r: int):
    """Flat-rank permutation of the grid transpose (a, b) → (b, a)."""
    return [(a * r + b, b * r + a) for a in range(r) for b in range(r)]


def matvec_2d(block, x_local: torch.Tensor, grid: GridMesh) -> torch.Tensor:
    """``y_a = Σ_b A[a, b] x_b`` on rank ``(a, b)``: ``block`` its
    ``(values, columns)``, ``x_local`` block ``a`` of x; returns block
    ``a`` of y (on every rank of grid row ``a``)."""
    vals, cols = block
    me = grid.a * grid.r + grid.b
    peer = dict(_transpose_perm(grid.r))[me]
    if peer == me:
        x_remote = x_local
    else:
        x_remote = torch.empty_like(x_local)
        p2p([(True, x_local.contiguous(), peer), (False, x_remote, peer)],
            dist.group.WORLD)
    partial = torch.sum(vals * x_remote[cols], dim=1)
    return all_reduce(partial, grid.col_group)


def dist_cg_solve_2d(part: Partition2D, b, grid: GridMesh, *,
                     tol: float = 1e-6, maxiter: Optional[int] = None,
                     jacobi: bool = False) -> CGResult:
    """Row- and column-sharded CG on the r × r grid; every rank calls it
    with the global ``b``.  The result's ``x`` is block ``a`` of the padded
    solution (the same on every rank of grid row ``a``)."""
    if maxiter is None:
        maxiter = part.n
    rl = part.rows_local
    if not isinstance(b, torch.Tensor):
        b = torch.from_numpy(np.asarray(b))
    b = torch.nn.functional.pad(b, (0, part.n_padded - b.shape[0]))
    b_loc = b[grid.a * rl:(grid.a + 1) * rl].to(grid.device)
    block = part.local(grid.a, grid.b, grid.device)

    def mv(v):
        return matvec_2d(block, v, grid)

    precond = None
    if jacobi:
        # The diagonal lives in the diagonal blocks; summed over the grid
        # row (off-diagonal ranks add zeros).
        vals, cols = block
        own = torch.arange(rl, device=cols.device)[:, None]
        on_diag = (cols == own) & (grid.a == grid.b)
        d = all_reduce(torch.sum(torch.where(on_diag, vals,
                                             torch.zeros_like(vals)), dim=1),
                       grid.col_group)
        inv = safe_recip(d)

        def precond(v):
            return inv * v

    return cg_solve(mv, b_loc, tol=tol, maxiter=int(maxiter),
                    preconditioner=precond, group=grid.row_group)

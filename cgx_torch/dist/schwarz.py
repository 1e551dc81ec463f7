"""Shard-local IC(0): one-level additive Schwarz with a gather-free apply.

Counterpart of :mod:`cgx.dist.schwarz`.  Each shard factors only its own
diagonal block ``A_s = A[rows_s, rows_s]`` (the Schwarz truncation: every
entry whose column leaves the block is dropped), so the preconditioner
``M⁻¹ = diag(L₁L₁ᵀ, …, L_SL_Sᵀ)⁻¹`` needs no traffic in its apply; the
distributed CG's dots are unchanged.  The triangular solves are the
Neumann sweeps of :class:`cgx_torch.solve.ic0.IC0SweepPrecond`, the strict
triangles held as banded DIA.

The factorisation runs on the host, through the port's own
:func:`~cgx_torch.solve.ic0.ic0_factor_shifted` (the native library) from
the :class:`~cgx_torch.dist.partition.Partition`'s own arrays; the strict
triangles are laid out on the union of the factored shards' offsets and
stacked along a leading shard axis like the partition.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cgx_torch.dist.partition import Partition

__all__ = ["IC0SweepBlocks", "ic0_sweep_blocks", "sweep_apply"]


@dataclass(frozen=True)
class IC0SweepBlocks:
    """Stacked per-shard IC(0) factors in banded (DIA) form: a leading
    shard axis (of ``shards``, global shard numbers), the offsets the union
    over them."""

    lower_data: torch.Tensor    # (S, n_low, rl): strict lower of L, DIA
    upper_data: torch.Tensor    # (S, n_up, rl): its transpose, DIA
    inv_diag: torch.Tensor      # (S, rl): 1 / diag(L); 1 on padding rows
    lower_offsets: Tuple[int, ...]
    upper_offsets: Tuple[int, ...]
    shards: Tuple[int, ...]

    def local(self, rank: int, device="cuda") -> "IC0SweepBlocks":
        """Shard ``rank``'s factor alone (a leading axis of 1) on
        ``device``."""
        from cgx_torch.sparse.types import resolve_device

        i = self.shards.index(rank)
        dev = resolve_device(device)
        return replace(self, lower_data=self.lower_data[i:i + 1].to(dev),
                       upper_data=self.upper_data[i:i + 1].to(dev),
                       inv_diag=self.inv_diag[i:i + 1].to(dev),
                       shards=(rank,))


def _local_block_coo(part: Partition, s: int):
    """Shard ``s``'s diagonal block as host COO (rows, cols, vals),
    rl × rl; padding and empty rows come back empty."""
    rl = part.rows_local
    if part.kind == "dia":
        data = part.dia_data[s]                       # (rl, nd)
        rows, cols, vals = [], [], []
        for k, off in enumerate(part.dia_offsets):
            i = np.arange(rl, dtype=np.int64)
            j = i + off
            ok = (j >= 0) & (j < rl) & (data[:, k] != 0)
            rows.append(i[ok])
            cols.append(j[ok])
            vals.append(data[ok, k])
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))
    vals = part.ell_values[s]
    cols = part.ell_cols[s].astype(np.int64)
    loc = cols - (part.halo_lo if part.mode == "halo" else s * rl)
    i = np.broadcast_to(np.arange(rl, dtype=np.int64)[:, None], cols.shape)
    ok = (loc >= 0) & (loc < rl) & (vals != 0)
    return i[ok], loc[ok], vals[ok]


def _dia_rows(rows, cols, vals, offsets, rl, dtype):
    """COO → row-aligned DIA data ``(len(offsets), rl)`` on the given
    offsets."""
    data = np.zeros((max(len(offsets), 1), rl), dtype=dtype)
    if len(rows):
        k = np.searchsorted(np.asarray(offsets, dtype=np.int64), cols - rows)
        data[k, rows] = vals
    return data


def ic0_sweep_blocks(part: Partition,
                     shards: Optional[Sequence[int]] = None
                     ) -> IC0SweepBlocks:
    """Factor the diagonal blocks of ``shards`` (default: every shard) with
    IC(0) on the host.  Raises ``numpy.linalg.LinAlgError`` on breakdown
    through every shift, ``ValueError`` when a factor is not banded (more
    than 64 populated diagonals)."""
    import scipy.sparse as sp

    from cgx_torch.solve.ic0 import ic0_factor_shifted

    shards = tuple(range(part.n_shards)) if shards is None \
        else tuple(int(s) for s in shards)
    rl = part.rows_local
    dtype = part.dtype
    factors, low_offsets = [], set()
    for s in shards:
        rows, cols, vals = _local_block_coo(part, s)
        a_s = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)),
                            shape=(rl, rl))
        fix = np.where(a_s.diagonal() == 0)[0]     # padding → identity
        if len(fix):
            a_s = a_s + sp.csr_matrix((np.ones(len(fix)), (fix, fix)),
                                      shape=(rl, rl))
        a_s.sort_indices()
        lv, lc, lp, _shift = ic0_factor_shifted(SimpleNamespace(
            values=a_s.data, col_indices=a_s.indices, indptr=a_s.indptr,
            shape=(rl, rl)))
        ell = sp.csr_matrix((lv, lc, lp), shape=(rl, rl))
        ls = sp.tril(ell, k=-1).tocoo()
        if ls.nnz:
            low_offsets.update(
                np.unique(ls.col.astype(np.int64) - ls.row).tolist())
        factors.append((ell.diagonal(), ls))

    lo = tuple(sorted(low_offsets)) if low_offsets else (-1,)
    if len(lo) > 64:
        raise ValueError(
            f"local IC(0) factor has {len(lo)} populated diagonals; the "
            "sweep form needs banded blocks (<= 64)")
    up = tuple(-o for o in reversed(lo))
    lower = np.zeros((len(shards), len(lo), rl), dtype=dtype)
    upper = np.zeros((len(shards), len(up), rl), dtype=dtype)
    inv_d = np.ones((len(shards), rl), dtype=dtype)
    for i, (d, ls) in enumerate(factors):
        inv_d[i] = 1.0 / d
        r, c = ls.row.astype(np.int64), ls.col.astype(np.int64)
        lower[i] = _dia_rows(r, c, ls.data, lo, rl, dtype)
        upper[i] = _dia_rows(c, r, ls.data, up, rl, dtype)
    return IC0SweepBlocks(lower_data=torch.from_numpy(lower),
                          upper_data=torch.from_numpy(upper),
                          inv_diag=torch.from_numpy(inv_d),
                          lower_offsets=lo, upper_offsets=up, shards=shards)


def sweep_apply(blocks: IC0SweepBlocks, nsweeps: int, r: torch.Tensor,
                shard_index: int = 0) -> torch.Tensor:
    """Apply one shard's ``(L Lᵀ)⁻¹`` to ``r`` by Neumann sweeps: the
    ``shard_index``-th factor of ``blocks`` (0 for a shard's own
    :meth:`IC0SweepBlocks.local`).  No collective: the apply reads only
    this shard's rows."""
    from cgx_torch.ops.spmv import spmv
    from cgx_torch.sparse.types import DIAMatrix

    inv_d = blocks.inv_diag[shard_index].to(r.dtype)
    rl = inv_d.shape[0]
    lower = DIAMatrix(blocks.lower_data[shard_index].to(r.dtype),
                      blocks.lower_offsets, (rl, rl))
    upper = DIAMatrix(blocks.upper_data[shard_index].to(r.dtype),
                      blocks.upper_offsets, (rl, rl))
    y = inv_d * r
    for _ in range(nsweeps):
        y = inv_d * (r - spmv(lower, y))
    z = inv_d * y
    for _ in range(nsweeps):
        z = inv_d * (y - spmv(upper, z))
    return z

"""Row-partitioned WBELL: the unstructured-sparsity engine across ranks.

Counterpart of :mod:`cgx.dist.wbell`.  The partition unit is the output
group (128 block rows, 1,024 matrix rows in the RCM ordering): rank *d*
owns ``gs`` consecutive groups of every vector, in WBELL's internal layout
``(gs, 8, 128)``, and the slot planes that accumulate into them, their
output group and window start rebased to the shard's extended block
``[halo_lo groups | gs own groups | halo_hi groups]``.

* :class:`WBellPartition` holds every shard's planes on the host, stacked,
  with the JAX package's geometry; :meth:`WBellPartition.local` builds,
  once, on one shard's device the row layout K7 reads there
  (:class:`~cgx_torch.sparse.wbell.WBellRows`, as
  :attr:`WBELLMatrix.rows` holds the whole matrix's).  All-zero planes
  (padding, with ``og = halo_lo``) are left out of it, so each shard's rows
  keep the global plane order and its K7 product equals the rows of the
  whole matrix's K7 product bit for bit.
* :func:`local_wbell_matvec` moves the halo as whole group slabs by ring
  exchange (:func:`cgx_torch.dist.halo.halo_exchange`, several ring steps
  where a halo is wider than a shard) and runs K7
  (:func:`~cgx_torch.kernels.wbell.wbell_resident_raw`) over the shard's
  layout; the multi-RHS form moves ``k`` behind the group axis, so one
  exchange carries every column, and runs K7 or K8
  (:func:`~cgx_torch.kernels.wbell.wbell_tiered_raw`, over the shard's
  tier plan, which holds the shard's K7 layout rather than a copy).
* The loops are the port's own (``cg_solve``, ``cg_solve_single_reduction``,
  ``cg_solve_pipelined``, ``chebyshev_solve``) with ``group=``: every dot
  an all-reduce, nothing gathered inside the loop.  The preconditioners
  ``"none"``, ``"jacobi"``, ``"block_jacobi"`` and ``"poly"`` apply on the
  shard alone.  At the solve boundary :func:`dist_wbell_cg_solve` gathers
  the internal vector once and applies the inverse permutation.

Every rank runs the same program (``torchrun`` on cards,
:func:`~cgx_torch.dist.launch.run_spmd` on the CPU) with the same
partition.  :func:`dist_wbell_cg_solve_multi` takes ``x0``, a warm start,
which the JAX package's does not (its ``cgx.dist.hp`` passes one anyway).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.dist.halo import halo_exchange
from cgx_torch.dist.launch import RowMesh
from cgx_torch.dist.solve import gather_rows
from cgx_torch.kernels.wbell import (WBellTierPlan, _pad_tier_class,
                                     _tier_classes, wbell_resident_raw,
                                     wbell_tiered_raw)
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult, cg_solve
from cgx_torch.solve.wbell import batched_cg
from cgx_torch.sparse.types import resolve_device
from cgx_torch.sparse.wbell import WBellRows, group_walk, row_layout

__all__ = ["WBellPartition", "LocalWBell", "partition_wbell",
           "local_wbell_matvec", "local_wbell_product",
           "dist_wbell_cg_solve", "dist_wbell_cg_solve_internal",
           "dist_wbell_cg_solve_multi", "WBellPartTiers",
           "partition_tier_plans", "local_wbell_matvec_multi"]


@dataclass(frozen=True, eq=False)
class LocalWBell:
    """One shard of a :class:`WBellPartition` on its device: its diagonal
    slab and K7's row layout of its planes, built once.  The planes
    themselves (local coordinates) stay host views of the partition's
    arrays: the card reads only the layout."""

    values: torch.Tensor        # (Pmax, 8, 8, 128) fp32, host
    lc: torch.Tensor            # (Pmax, 1, 128) int32, host
    p_og: torch.Tensor          # (Pmax,) int32 local output group, host
    p_ga: torch.Tensor          # (Pmax,) int32 local window start, host
    diag: torch.Tensor          # (gs, 8, 128) fp32, on the device
    rows: WBellRows             # K7's layout over the extended block
    rank: int
    gs: int
    halo_lo: int
    halo_hi: int
    nt_local: int


@dataclass(frozen=True, eq=False)
class WBellPartition:
    """Row(-group)-partitioned WBELL operator: every shard's arrays stacked
    on a leading shard axis, on the host (numpy), with the JAX package's
    geometry.  ``diag_internal`` is the vector layout's ``(nd·gs, 8,
    128)``; ``perm``/``iperm`` the global RCM permutation."""

    values: np.ndarray          # (nd, Pmax, 8, 8, 128) fp32
    lc: np.ndarray              # (nd, Pmax, 1, 128) int32
    p_og: np.ndarray            # (nd, Pmax) int32, LOCAL output group
    p_ga: np.ndarray            # (nd, Pmax) int32, LOCAL window start
    diag_internal: np.ndarray   # (nd·gs, 8, 128) fp32
    perm: np.ndarray            # (n,) int64
    iperm: np.ndarray           # (n,) int64
    shape: Tuple[int, int]
    n_shards: int
    gs: int                     # groups a shard
    ng_real: int
    halo_lo: int                # groups
    halo_hi: int
    nt_local: int
    span: int
    nnz: int = 0
    # Shards moved to a device, tier plans and permutations on a device,
    # built once each (see local()).
    _cache: dict = field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.shape[0]

    def _index(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(getattr(self, name)).to(
                device)
        return self._cache[key]

    # -- solve-boundary layout transforms ------------------------------------

    def to_internal(self, v) -> torch.Tensor:
        """(n,) standard order (numpy or torch) → ``(nd·gs, 8, 128)``, on
        ``v``'s device (a numpy ``v``: the CPU)."""
        v = torch.as_tensor(v)
        vp = v[self._index("perm", v.device)]
        vp = torch.nn.functional.pad(vp, (0, self.ng_real * 1024 - self.n))
        vi = vp.reshape(self.ng_real, 128, 8).transpose(1, 2)
        return torch.nn.functional.pad(
            vi, (0, 0, 0, 0, 0, self.n_shards * self.gs - self.ng_real))

    def from_internal(self, vi: torch.Tensor) -> torch.Tensor:
        """``(nd·gs, 8, 128)`` → (n,) standard order."""
        v = vi[:self.ng_real].transpose(1, 2).reshape(-1)[:self.n]
        return v[self._index("iperm", vi.device)]

    def slab(self, vi: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s groups of an internal vector (``(nd·gs, 8,
        128)``, or ``(k, nd·gs, 8, 128)``)."""
        g = slice(rank * self.gs, (rank + 1) * self.gs)
        return (vi[g] if vi.dim() == 3 else vi[:, g]).contiguous()

    def local(self, rank: int, device="cuda") -> LocalWBell:
        """Shard ``rank`` on ``device`` with its row layout, built on the
        first call and kept: a partition solved again builds nothing.  The
        planes' device copies live only while the layout is built."""
        dev = resolve_device(device)
        key = ("local", int(rank), str(dev))
        if key not in self._cache:
            host = [torch.from_numpy(np.ascontiguousarray(a[rank]))
                    for a in (self.values, self.lc, self.p_og, self.p_ga)]
            values, lc, og, ga = (t.to(dev) for t in host)
            keep = values.reshape(values.shape[0], -1).ne(0).any(1)
            rows = row_layout(values, lc, group_walk(og, keep,
                                                     self.nt_local),
                              og, ga, self.nt_local)
            g = slice(rank * self.gs, (rank + 1) * self.gs)
            self._cache[key] = LocalWBell(
                *host,
                diag=torch.from_numpy(self.diag_internal[g].copy()).to(dev),
                rows=rows, rank=int(rank), gs=self.gs, halo_lo=self.halo_lo,
                halo_hi=self.halo_hi, nt_local=self.nt_local)
        return self._cache[key]


def _pack_slab_planes(row, col, val, tile_lo: int, tile_hi: int,
                      nbr: int, span: int):
    """Pack the slot planes for output tiles ``[tile_lo, tile_hi)`` from
    GLOBAL permuted entry coordinates: the per-shard half of the WBELL
    build (the same (tile, bucket)-major plane order and span-bucket
    window math), with only this slab's entries in memory.

    Returns ``(values (P,8,8,128), lc (P,1,128), p_og (P,) GLOBAL output
    group, p_ga (P,) GLOBAL window-start group)``; empty tiles contribute
    no planes."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    if len(row) == 0:
        return (np.zeros((0, 8, 8, 128), np.float32),
                np.zeros((0, 1, 128), np.int32),
                np.zeros(0, np.int64), np.zeros(0, np.int64))

    br, bc = row >> 3, col >> 3
    key = br * nbr + bc
    uid, inv = np.unique(key, return_inverse=True)
    ub_r, ub_c = uid // nbr, uid % nbr
    nblocks = len(uid)
    tile_of_block = ub_r >> 7
    if tile_of_block.min() < tile_lo or tile_of_block.max() >= tile_hi:
        raise ValueError("_pack_slab_planes: entries outside the slab")

    bucket = (ub_c >> 7) // span
    chg = np.empty(nblocks, bool)
    chg[0] = True
    chg[1:] = (ub_r[1:] != ub_r[:-1]) | (bucket[1:] != bucket[:-1])
    grp_start = np.flatnonzero(chg)
    grp_id = np.cumsum(chg) - 1
    rank_rb = np.arange(nblocks, dtype=np.int64) - grp_start[grp_id]

    nb = int(bucket.max()) + 1
    tb_key = tile_of_block * nb + bucket
    tb_uid, tb_inv = np.unique(tb_key, return_inverse=True)
    tb_tile = tb_uid // nb
    wbt_tb = np.zeros(len(tb_uid), np.int64)
    np.maximum.at(wbt_tb, tb_inv, rank_rb + 1)
    pstart_tb = np.concatenate([[0], np.cumsum(wbt_tb[:-1])])
    p_real = int(wbt_tb.sum())
    plane = pstart_tb[tb_inv] + rank_rb

    lane = ub_r & 127
    values = np.zeros((p_real, 8, 8, 128), np.float32)
    lcp = np.zeros((p_real, 1, 128), np.int32)
    np.add.at(values, (plane[inv], row & 7, col & 7, lane[inv]), val)
    lcp[plane, 0, lane] = ((ub_c & 127)
                           + 128 * ((ub_c >> 7)
                                    - bucket * span)).astype(np.int32)
    p_og = np.repeat(tb_tile, wbt_tb)
    p_ga = np.repeat((tb_uid % nb) * span, wbt_tb)
    return values, lcp, p_og, p_ga


def _stack_shards(shards, nd: int, gs: int, span: int, diag: np.ndarray,
                  perm: np.ndarray, iperm: np.ndarray, shape, ng_real: int,
                  nnz: int) -> WBellPartition:
    """The partition of per-shard plane lists ``[(values, lc, og, ga)]``
    (GLOBAL og/ga): the halos from the windows the shards' planes read,
    coordinates rebased, padded with zero planes to a multiple of 64."""
    halo_lo = halo_hi = 0
    for d, (_, _, og, ga) in enumerate(shards):
        if len(og) == 0:
            continue
        halo_lo = max(halo_lo, d * gs - int(ga.min()))
        halo_hi = max(halo_hi, int((ga + span).max()) - (d + 1) * gs)
    halo_lo, halo_hi = max(halo_lo, 0), max(halo_hi, 0)
    # A plane's local window must end inside the block even for tiny shards.
    nt_local = max(halo_lo + gs + halo_hi, span)

    pmax = max(max((s[0].shape[0] for s in shards), default=1), 1)
    pmax = -(-pmax // 64) * 64
    sv = np.zeros((nd, pmax, 8, 8, 128), np.float32)
    slc = np.zeros((nd, pmax, 1, 128), np.int32)
    sog = np.full((nd, pmax), halo_lo, np.int32)   # pad: own slab, zero add
    sga = np.zeros((nd, pmax), np.int32)
    for d, (vals, lc, og, ga) in enumerate(shards):
        k = vals.shape[0]
        sv[d, :k] = vals
        slc[d, :k] = lc
        sog[d, :k] = (og - d * gs + halo_lo).astype(np.int32)
        sga[d, :k] = (ga - d * gs + halo_lo).astype(np.int32)
    if sga.min() < 0 or sga.max() + span > nt_local \
            or sog.min() < halo_lo or sog.max() >= halo_lo + gs:
        raise AssertionError("partition_wbell: a plane left its shard")
    return WBellPartition(
        values=sv, lc=slc, p_og=sog, p_ga=sga,
        diag_internal=np.ascontiguousarray(diag, np.float32),
        perm=np.asarray(perm, np.int64), iperm=np.asarray(iperm, np.int64),
        shape=(int(shape[0]), int(shape[1])), n_shards=nd, gs=gs,
        ng_real=int(ng_real), halo_lo=int(halo_lo), halo_hi=int(halo_hi),
        nt_local=int(nt_local), span=int(span), nnz=int(nnz))


def partition_wbell(a, n_shards: int, *, span: int = 16,
                    order: str = "rcm",
                    per_shard: bool = False) -> WBellPartition:
    """Build the row(-group)-partitioned WBELL operator on the host.

    ``per_shard=False``: the global WBELL build
    (:func:`cgx_torch.sparse.wbell.wbell_from_csr` on the CPU, one global
    RCM so every shard shares the vector layout), its planes split by
    output group into ``n_shards`` slabs.  ``per_shard=True``: only the
    global ordering (RCM and the balance sort), then each shard's planes
    packed from its CSR row slab (:func:`_pack_slab_planes`), so the
    global plane array is never built; the planes are the global build's
    without its all-zero ones.  ``a``: a CSR container (the port's or the
    JAX package's) or a scipy matrix."""
    from cgx_torch.solve.hp import _scipy_f64

    s = _scipy_f64(a)
    if s.shape[0] != s.shape[1]:
        raise ValueError("partition_wbell needs a square matrix")
    nd = int(n_shards)
    if per_shard:
        return _partition_wbell_per_shard(s, nd, span=span, order=order)
    from cgx_torch.sparse.wbell import wbell_from_csr

    wb = wbell_from_csr(s, span=span, order=order, device="cpu")
    ngr = wb.ng_real
    gs = -(-ngr // nd)
    p_og = wb.p_og.numpy().astype(np.int64)
    p_ga = wb.p_ga.numpy().astype(np.int64)
    vals = wb.values.numpy()
    lc = wb.lc.numpy()
    # Every plane goes to the shard of its output group; the global
    # build's zero planes (og = 0) land on shard 0 and add nothing.
    owner = np.minimum(p_og // gs, nd - 1)
    shards = []
    for d in range(nd):
        sel = np.flatnonzero(owner == d)
        shards.append((vals[sel], lc[sel], p_og[sel], p_ga[sel]))
    diag = np.pad(wb.diag_internal.numpy()[:ngr],
                  ((0, nd * gs - ngr), (0, 0), (0, 0)))
    return _stack_shards(shards, nd, gs, wb.span, diag, wb.perm.numpy(),
                         wb.iperm.numpy(), wb.shape, ngr, wb.nnz)


def _partition_wbell_per_shard(s, nd: int, *, span: int,
                               order: str) -> WBellPartition:
    """The per-shard build (see :func:`partition_wbell`)."""
    from cgx_torch.sparse.wbell import _balance_blocks, _rcm

    n = s.shape[0]
    perm = _rcm(s) if order == "rcm" else np.arange(n, dtype=np.int64)
    perm = _balance_blocks(s, perm, 1024)
    ap = s[perm][:, perm].tocsr()
    ap.sort_indices()

    nbr = -(-n // 8)
    ng_real = -(-nbr // 128)
    gs = -(-ng_real // nd)
    shards = []
    for d in range(nd):
        r0, r1 = d * gs * 1024, min((d + 1) * gs * 1024, n)
        if r0 >= n:
            shards.append(_pack_slab_planes([], [], [], 0, 0, nbr, span))
            continue
        sub = ap[r0:r1].tocoo()            # one slab's entries in memory
        shards.append(_pack_slab_planes(
            sub.row.astype(np.int64) + r0, sub.col, sub.data,
            d * gs, min((d + 1) * gs, ng_real), nbr, span))

    # The diagonal in the vector layout: permuted row r = 8b + e, block
    # b = 128g + l, sits at internal index 1024g + 128e + l.
    diag = np.zeros(nd * gs * 1024, np.float32)
    r_all = np.arange(n, dtype=np.int64)
    b_all = r_all >> 3
    diag[((b_all >> 7) << 10) + ((r_all & 7) << 7) + (b_all & 127)] = \
        ap.diagonal().astype(np.float32)
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    return _stack_shards(shards, nd, gs, span, diag.reshape(nd * gs, 8, 128),
                         perm, iperm, s.shape, ng_real, s.nnz)


# -- the shard-local products -------------------------------------------------

def _padded(x_ext: torch.Tensor, nt_local: int) -> torch.Tensor:
    """``x_ext`` (groups on dim 1) zero-padded to ``nt_local`` groups,
    contiguous: the shape K7's and K8's launches check."""
    pad = nt_local - x_ext.shape[1]
    if pad:
        x_ext = torch.nn.functional.pad(x_ext, (0, 0, 0, 0, 0, pad))
    return x_ext.contiguous()


def local_wbell_product(loc: LocalWBell, x_ext: torch.Tensor,
                        tiers: Optional[WBellTierPlan] = None
                        ) -> torch.Tensor:
    """``Y = (A X)`` on shard ``loc``'s groups from its extended block
    ``x_ext`` ``(k, halo_lo + gs + halo_hi, 8, 128)`` (the exchanged or
    cut halos around its own groups): K7 over the shard's row layout, or K8
    over its tier plan ``tiers``.  Returns ``(k, gs, 8, 128)``."""
    xb = _padded(x_ext.to(torch.float32), loc.nt_local)
    if tiers is None:
        y = wbell_resident_raw(loc.p_og, loc.p_ga, loc.lc, loc.values, xb,
                               rows=loc.rows)
    else:
        y = wbell_tiered_raw(tiers.packed, tiers.lc, tiers.values, xb,
                             steps=tiers.steps, splane=tiers.splane,
                             rows=tiers.rows)
    return y[:, loc.halo_lo:loc.halo_lo + loc.gs]


def local_wbell_matvec(loc: LocalWBell, x_loc: torch.Tensor,
                       mesh: RowMesh) -> torch.Tensor:
    """``y_loc = (A x)_loc`` on one rank's group slab ``(gs, 8, 128)``:
    the ring exchange of ``halo_lo + halo_hi`` group slabs, then K7."""
    x_ext = halo_exchange(x_loc.contiguous(), loc.halo_lo, loc.halo_hi,
                          mesh)
    return local_wbell_product(loc, x_ext[None])[0]


def local_wbell_matvec_multi(loc: LocalWBell, x_loc: torch.Tensor,
                             mesh: RowMesh,
                             tiers: Optional[WBellTierPlan] = None
                             ) -> torch.Tensor:
    """``Y_loc = (A X)_loc`` for ``(k, gs, 8, 128)`` columns: one ring
    exchange carries all k (the group axis leads while it moves), then one
    K7 launch, or K8's over ``tiers``, for every column."""
    xg = x_loc.movedim(0, 1).contiguous()            # (gs, k, 8, 128)
    x_ext = halo_exchange(xg, loc.halo_lo, loc.halo_hi, mesh)
    return local_wbell_product(loc, x_ext.movedim(1, 0), tiers)


# -- the single-RHS solve -------------------------------------------------------

def _partition_block_jacobi(part: WBellPartition) -> np.ndarray:
    """Supervariable 8×8 block inverses in the vector layout ``(nd·gs, 8,
    8, 128)`` fp32: the distributed form of
    :class:`~cgx_torch.solve.wbell.WBellBlockJacobiPrecond` (host, once)."""
    nd = part.n_shards
    blocks = np.zeros((nd * part.gs * 128, 8, 8), np.float64)
    p_og = part.p_og.astype(np.int64)
    p_ga = part.p_ga.astype(np.int64)
    lc = part.lc[:, :, 0, :]                       # (nd, Pmax, 128)
    lanes = np.arange(128)
    for d in range(nd):
        base = d * part.gs - part.halo_lo
        abs_bc = (p_ga[d][:, None] + base) * 128 + lc[d]
        abs_br = (p_og[d][:, None] + base) * 128 + lanes[None, :]
        p_idx, l_idx = np.nonzero(abs_bc == abs_br)
        np.add.at(blocks, abs_br[p_idx, l_idx].astype(np.int64),
                  part.values[d][p_idx, :, :, l_idx].astype(np.float64))
    zero_rows = ~blocks.any(axis=(1, 2))
    blocks[zero_rows] = np.eye(8)
    d_ = np.einsum("bii->bi", blocks)
    d_[d_ == 0.0] = 1.0
    binv = np.linalg.inv(blocks)
    binv = binv.reshape(nd * part.gs, 128, 8, 8).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(binv, np.float32)


def _start_vector(part: WBellPartition, loc: LocalWBell,
                  dtype) -> torch.Tensor:
    """Chebyshev's power-iteration start: a generator seeded 0 draws the
    global internal vector's real groups (the draw does not depend on the
    number of ranks), the rank takes its slab, and the padding lanes
    (diagonal 0) are masked, as the JAX package masks its start."""
    dev = loc.diag.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    v = torch.randn((part.ng_real, 8, 128), generator=gen, device=dev,
                    dtype=dtype)
    v = torch.nn.functional.pad(
        v, (0, 0, 0, 0, 0, part.n_shards * part.gs - part.ng_real))
    return part.slab(v, loc.rank) * (loc.diag != 0)


def _local_precond(part: WBellPartition, loc: LocalWBell, kind: str, mv,
                   poly_steps: int):
    """The shard's preconditioner apply in the internal layout (no
    traffic but the products ``"poly"`` contains)."""
    if kind == "none":
        return None
    if kind == "jacobi":
        idi = safe_recip(loc.diag)
        return lambda r: r * idi
    if kind == "block_jacobi":
        key = ("block_jacobi", loc.rank, str(loc.diag.device))
        if key not in part._cache:
            g = slice(loc.rank * part.gs, (loc.rank + 1) * part.gs)
            part._cache[key] = torch.from_numpy(
                _partition_block_jacobi(part)[g]).to(loc.diag.device)
        binv = part._cache[key]
        return lambda r: torch.einsum("gijl,gjl->gil", binv.to(r.dtype), r)
    if kind == "poly":
        idi = safe_recip(loc.diag)
        om = 2.0 / 3.0

        def apply_poly(r):
            z = om * idi * r
            for _ in range(poly_steps - 1):
                z = z + om * idi * (r - mv(z))
            return z
        return apply_poly
    raise ValueError(f"unknown preconditioner {kind!r} (none/jacobi/"
                     "block_jacobi/poly)")


def _own(part: WBellPartition, v, rank: int, device) -> torch.Tensor:
    """A rank's slab of an internal vector given whole (``nd·gs`` groups)
    or as the slab itself (``gs`` groups), as fp32 on ``device``."""
    v = torch.as_tensor(v).to(device=device, dtype=torch.float32)
    groups = v.shape[-3]
    if groups == part.gs:
        return v.contiguous()
    if groups != part.n_shards * part.gs:
        raise ValueError(f"expected {part.gs} or {part.n_shards * part.gs} "
                         f"groups, got {tuple(v.shape)}")
    return part.slab(v, rank)


def dist_wbell_cg_solve_internal(
    part: WBellPartition,
    bi,
    mesh: RowMesh,
    *,
    x0i=None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner: str = "none",
    poly_steps: int = 3,
    method: str = "cg",
) -> CGResult:
    """Internal-layout entry; every rank calls it.  ``bi``/``x0i`` are
    internal vectors, whole ``(nd·gs, 8, 128)`` or this rank's slab
    ``(gs, 8, 128)``; the result's ``x`` is this rank's slab.  No
    standard-order transform and no gather: the form repeated solves use
    (:mod:`cgx_torch.dist.hp` calls it once a refinement cycle with the
    residual already in place).

    ``method``: ``"cg"`` (two all-reduces an iteration),
    ``"single_reduction"``, ``"pipelined"`` (one) or ``"chebyshev"``
    (bounds of ``M⁻¹A`` by distributed power iteration from
    :func:`_start_vector`)."""
    if maxiter is None:
        maxiter = part.n
    loc = part.local(mesh.rank, mesh.device)
    b_loc = _own(part, bi, mesh.rank, mesh.device)
    x0l = None if x0i is None else _own(part, x0i, mesh.rank, mesh.device)
    mv = partial(local_wbell_matvec, loc, mesh=mesh)
    precond = _local_precond(part, loc, preconditioner, mv, int(poly_steps))
    kw = dict(tol=float(tol), maxiter=int(maxiter), preconditioner=precond,
              group=mesh.group)
    if method == "single_reduction":
        from cgx_torch.solve.cg import cg_solve_single_reduction
        return cg_solve_single_reduction(mv, b_loc, x0l, atol=atol, **kw)
    if method == "pipelined":
        from cgx_torch.solve.cg import cg_solve_pipelined
        return cg_solve_pipelined(mv, b_loc, x0l, atol=atol, **kw)
    if method == "chebyshev":
        from cgx_torch.solve.chebyshev import chebyshev_solve, estimate_bounds
        op = mv if precond is None else (lambda v: precond(mv(v)))
        lo, hi = estimate_bounds(op, b_loc.shape, dtype=b_loc.dtype,
                                 v0=_start_vector(part, loc, b_loc.dtype),
                                 group=mesh.group)
        return chebyshev_solve(mv, b_loc, lo, hi, x0l, **kw)
    if method != "cg":
        raise ValueError(f"unknown method {method!r}")
    return cg_solve(mv, b_loc, x0l, atol=atol, **kw)


def dist_wbell_cg_solve(
    part: WBellPartition,
    b,
    mesh: RowMesh,
    *,
    x0=None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner: str = "none",
    poly_steps: int = 3,
    method: str = "cg",
) -> CGResult:
    """Row-partitioned (P)CG through K7; every rank calls it.

    ``b``/``x0`` are the standard-order ``(n,)`` vectors (numpy or torch,
    any device); the iterate lives in the rank's internal slab for the
    whole solve, and the returned ``x`` is the whole standard-order
    solution on every rank (one all-gather at the boundary).
    ``preconditioner``: ``"none" | "jacobi" | "block_jacobi" | "poly"``."""
    dev = mesh.device
    bi = part.to_internal(torch.as_tensor(b).to(dev))
    x0i = None if x0 is None else part.to_internal(
        torch.as_tensor(x0).to(dev))
    res = dist_wbell_cg_solve_internal(
        part, bi, mesh, x0i=x0i, tol=tol, atol=atol, maxiter=maxiter,
        preconditioner=preconditioner, poly_steps=poly_steps, method=method)
    x = part.from_internal(gather_rows(res.x, mesh))
    return dataclasses.replace(res, x=x)


# -- the multi-RHS solve --------------------------------------------------------

@dataclass(frozen=True, eq=False)
class WBellPartTiers:
    """Every shard's width-tier plan, class counts padded to the largest
    over the shards (the JAX package's shard-uniform grid): stacked host
    arrays.  :meth:`local` gives a shard's
    :class:`~cgx_torch.kernels.wbell.WBellTierPlan`, whose row layout is
    the shard's K7 layout (K8 on the card reads it in origin order); its
    class-major arrays stay on the host, where only their shape and
    ``steps``/``splane`` are read."""

    values: np.ndarray          # (nd, Ptot, 8, 8, 128) class-major
    lc: np.ndarray              # (nd, Ptot, 1, 128) int32
    packed: np.ndarray          # (nd, Ptot) int32, LOCAL og << 16 | ga
    origin: np.ndarray          # (nd, Ptot) int32, shard plane (-1: pad)
    steps: Tuple[int, ...]
    splane: int

    def local(self, loc: LocalWBell) -> WBellTierPlan:
        """Shard ``loc.rank``'s plan: host views of its arrays, holding
        ``loc.rows`` (on ``loc``'s device)."""
        def take(a):
            return torch.from_numpy(np.ascontiguousarray(a[loc.rank]))

        return WBellTierPlan(values=take(self.values), lc=take(self.lc),
                             packed=take(self.packed),
                             origin=take(self.origin), steps=self.steps,
                             splane=self.splane, nt=loc.nt_local,
                             rows=loc.rows)


def partition_tier_plans(part: WBellPartition,
                         splane: Optional[int] = None) -> WBellPartTiers:
    """Classify each shard's planes into width tiers (tight windows in
    LOCAL group coordinates), each class padded to the largest count over
    the shards, a multiple of ``splane`` (8, as the JAX package pads off
    the TPU).  Needs ``span <= 16`` and ``nt_local < 65536``."""
    if part.span > 16:
        raise ValueError("tier plans support span <= 16")
    if part.nt_local >= 1 << 16:
        raise ValueError(f"tier plans pack og/ga in 16 bits: nt_local="
                         f"{part.nt_local} must be < 65536")
    splane = 8 if splane is None else int(splane)
    nd = part.n_shards
    nz = np.abs(part.values).sum(axis=(2, 3)) > 0      # (nd, Pmax, 128)
    per_shard = [_tier_classes(nz[d], part.lc[d], part.p_og[d],
                               part.p_ga[d], part.nt_local)
                 for d in range(nd)]
    n_cls = len(per_shard[0])
    targets = [-(-max(len(per_shard[d][c][0]) for d in range(nd))
                 // splane) * splane for c in range(n_cls)]
    sv, sl, spg, sorg = [], [], [], []
    for d in range(nd):
        idx_all, l_all, pg_all = [], [], []
        for c in range(n_cls):
            idx, l, pg = _pad_tier_class(*per_shard[d][c], targets[c])
            idx_all.append(idx)
            l_all.append(l)
            pg_all.append(pg)
        idx = np.concatenate(idx_all)
        vals = np.zeros((len(idx), 8, 8, 128), np.float32)
        vals[idx >= 0] = part.values[d][idx[idx >= 0]]
        sv.append(vals)
        sl.append(np.concatenate(l_all))
        spg.append(np.concatenate(pg_all))
        sorg.append(idx.astype(np.int32))
    return WBellPartTiers(values=np.stack(sv), lc=np.stack(sl),
                          packed=np.stack(spg), origin=np.stack(sorg),
                          steps=tuple(t // splane for t in targets),
                          splane=splane)


def _local_tiers(part: WBellPartition, loc: LocalWBell) -> WBellTierPlan:
    """The shard's tier plan on its device, built once per partition."""
    key = ("tiers", loc.rank, str(loc.diag.device))
    if key not in part._cache:
        if ("tier_plans",) not in part._cache:
            part._cache[("tier_plans",)] = partition_tier_plans(part)
        part._cache[key] = part._cache[("tier_plans",)].local(loc)
    return part._cache[key]


def _multi_solve_internal(part: WBellPartition, bi, mesh: RowMesh, *,
                          x0i=None, tol: float, atol: float, maxiter: int,
                          jacobi: bool, tiered: Optional[bool]) -> CGResult:
    """Batched (Jacobi-)CG on this rank's slabs ``(k, gs, 8, 128)``
    (``bi``/``x0i`` whole or the slab; the result's ``x`` the slab): the
    single card's loop (:func:`cgx_torch.solve.wbell.batched_cg`) over the
    rank's slabs, each column with its own α, β and exit; per iteration one
    halo exchange and one K7/K8 launch for every column, two all-reduces
    of ``(k,)`` dots and one host read."""
    loc = part.local(mesh.rank, mesh.device)
    tiers = None
    if tiered is not False and part.span <= 16:
        tiers = _local_tiers(part, loc)
    elif tiered:
        raise ValueError("tiered=True needs span <= 16")
    idi = safe_recip(loc.diag)[None] if jacobi else None
    return batched_cg(
        partial(local_wbell_matvec_multi, loc, mesh=mesh, tiers=tiers),
        _own(part, bi, mesh.rank, mesh.device),
        None if x0i is None else _own(part, x0i, mesh.rank, mesh.device),
        (lambda r: r * idi) if jacobi else (lambda r: r), bool(jacobi),
        tol=tol, atol=atol, maxiter=maxiter, group=mesh.group)


def _to_internal_block(part: WBellPartition, B: torch.Tensor) -> torch.Tensor:
    """(n, k) standard order → ``(k, nd·gs, 8, 128)``."""
    return torch.stack([part.to_internal(B[:, j]) for j in range(B.shape[1])])


def _from_internal_block(part: WBellPartition, xl: torch.Tensor,
                         mesh: RowMesh) -> torch.Tensor:
    """This rank's ``(k, gs, 8, 128)`` slabs → the whole (n, k) block in
    standard order on every rank (one all-gather)."""
    xg = gather_rows(xl.movedim(0, 1), mesh).movedim(1, 0)
    return torch.stack([part.from_internal(xg[j]) for j in range(xg.shape[0])],
                       dim=1)


def dist_wbell_cg_solve_multi(
    part: WBellPartition,
    b,
    mesh: RowMesh,
    *,
    x0=None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    jacobi: bool = False,
    tiered: Optional[bool] = None,
) -> CGResult:
    """Multi-RHS ``A X = B`` through the row-partitioned engine; every rank
    calls it.  ``b`` (and the warm start ``x0``) standard-order ``(n,
    k)``; the result's ``x`` is the whole ``(n, k)`` block on every rank
    and its scalars ``(k,)``.  ``tiered`` (default: on for ``span <=
    16``) runs K8 over each shard's tier plan, else K7; both read the
    shard's K7 layout, so the two give the same products bit for bit."""
    dev = mesh.device
    B = torch.as_tensor(b).to(dev)
    n, k = B.shape
    res = _multi_solve_internal(
        part, _to_internal_block(part, B), mesh,
        x0i=None if x0 is None else _to_internal_block(
            part, torch.as_tensor(x0).to(dev)),
        tol=float(tol), atol=float(atol),
        maxiter=n if maxiter is None else int(maxiter), jacobi=bool(jacobi),
        tiered=tiered)
    return dataclasses.replace(res, x=_from_internal_block(part, res.x, mesh))

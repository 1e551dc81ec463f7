"""Windowed block-ELL (WBELL): the unstructured-sparsity format (PyTorch).

Counterpart of :mod:`cgx.sparse.wbell`.  The host build is a numpy copy of
the JAX package's: the matrix is RCM-permuted, refined by a block-count
sort, densified into 8×8 blocks, and packed into *slot planes* of 128
blocks each (one per lane, lane = block row within a group of 128 block
rows).  Every array it returns equals the JAX builder's.

Vectors live in the *internal layout* ``(nt, 8, 128)``: group, element
within block, lane.  The solvers stay in it; :meth:`WBELLMatrix.to_internal`
and :meth:`WBELLMatrix.from_internal` convert at the solve boundary.

What differs from the JAX package:

* the arrays are tensors on ``device`` (the card unless the caller asks
  for the CPU); kernel metadata stays int32, ``perm``/``iperm`` are int64
  for torch indexing;
* :func:`pick_format` takes ``device=`` where the JAX package takes
  ``backend=``: ``"wbell"`` on CUDA where the JAX package says TPU;
* the plane-walking CUDA kernel K10 (:mod:`cgx_torch.kernels.wbell`)
  walks each output group's planes; :attr:`WBELLMatrix.resident_walk`
  and :attr:`WBELLMatrix.windowed_walk` build those per-group ranges once
  per matrix, on its device;
* K7, K8 and K9 read a compact row layout (:class:`WBellRows`, sliced ELL
  over the internal rows) that :func:`row_layout` builds from the planes
  once per matrix (:attr:`WBELLMatrix.rows`,
  :attr:`WBELLMatrix.windowed_rows`; K8's from its tier plan's planes):
  the planes' 8×8 blocks hold 5.6 nonzeros of 64 at thermal2 scale, a fill
  that the TPU's (8, 128) vregs wanted and the card does not.  The
  prototypes P1 and P3 build theirs from their own planes
  (:func:`rows_from_steps`, :func:`rows_from_entries`).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.sparse.types import CSRMatrix, ell_from_csr, resolve_device

__all__ = ["WBELLMatrix", "wbell_from_csr", "auto_format", "pick_format",
           "WBELL_MIN_ROWS", "group_walk", "WBellRows", "row_layout",
           "rows_from_steps", "rows_from_entries", "ROW_SLICE",
           "ROW_OFFSET_LIMIT", "STAGE_WINDOW_GROUPS", "row_layout_builds"]

# The JAX package's routing threshold, measured on a TPU v5e (a 2.0 s
# build at 49 k rows breaks even at ~370 iterations); not measured on the
# card.  Every "auto" surface derives from it through pick_format.
WBELL_MIN_ROWS = 30_000

# Internal rows of one slice of the row layout: one warp, a row a thread.
ROW_SLICE = 32
# The widest window of x (floats) whose columns a stage stores as 16-bit
# offsets.
ROW_OFFSET_LIMIT = 1 << 16
# K9's widest stage window, in groups of x (4 KB of fp32 each): two
# buffers of it fit in the 227 KB of shared memory an H100 block may use.
STAGE_WINDOW_GROUPS = 28

# Row layouts built so far (a run resets it to show where layouts are built).
row_layout_builds = 0


def group_walk(og: torch.Tensor, keep: torch.Tensor, nt: int,
               within: Optional[torch.Tensor] = None):
    """Per-group ranges over a list of planes (or tiles): ``order`` holds
    the kept indices sorted by output group ``og``, within a group by
    ``within`` (default: index order, the order the TPU grid visits), and
    ``order[ptr[g]:ptr[g+1]]`` are group g's.  Both int32, on ``og``'s
    device."""
    idx = torch.nonzero(keep).reshape(-1)
    if within is not None:
        idx = idx[torch.argsort(within.long()[idx], stable=True)]
    g = og.long()[idx]
    order = idx[torch.argsort(g, stable=True)]
    ptr = torch.zeros(nt + 1, dtype=torch.int64, device=og.device)
    ptr[1:] = torch.cumsum(torch.bincount(g, minlength=nt), 0)
    return order.to(torch.int32), ptr.to(torch.int32)


@dataclass(frozen=True, eq=False)
class WBellRows:
    """The compact row layout of a WBELL operator: sliced ELL over the
    internal rows, built from the slot planes by :func:`row_layout`.

    Internal row ``1024·g + 128·i + l`` (group g, row i of lane l's block
    row) holds its nonzeros in walk order (plane order, then j), each with
    its value in the planes' dtype and the internal index ``1024·(ga +
    lc>>7) + 128·j + (lc & 127)`` of its x operand; zero values are left
    out.  Within each group the rows are sorted by their count of entries,
    longest first, stably (``rowmap[q]`` is the internal row at position
    q), and each 32 positions form a slice, stored slot-major: slot t of
    the slice's lane e at ``sbase[k] + 32·t + e``, so a warp's loads of
    values and columns are coalesced.  Padding slots hold value 0 and
    column 0 of their window.

    A group's entries are split into stages (``sptr``), each summed after
    the one before it, so every row keeps its walk order.  The resident
    layout (K7) has one stage per group; the windowed layout (K9) one stage
    per run of planes with one window start, whose window of x K9 stages
    in shared memory, cut by column into parts of at most
    :data:`STAGE_WINDOW_GROUPS` groups of x where the run draws from a
    wider window (a row's columns ascend within a run, so the cut keeps
    its order).  Stage st's entries read x from ``x0[st] .. x0[st] +
    xlen[st]`` (floats), and a column is stored as its offset from
    ``x0[st]`` in 16 bits (int16 storage read as unsigned), or, where a
    resident group spans more than 65,536 floats of x, as the absolute
    index in int32 with ``x0 = 0``.  Slice ``32·st + w`` holds stage st's
    entries of the positions ``32·w .. 32·w + 31`` of its group.

    A *segmented* layout (:func:`rows_from_entries` with ``step``, the
    4×8 half-block prototype P3's) flags each entry that continues the
    previous entry's (row, plane) segment: bit e of ``flags[sbase[k] / 32
    + t]`` for slot t of slice k's lane e, one 32-bit word a warp reads
    whole per slot (1/32 of a word a slot; the columns keep their 16 bits).
    Its product sums each segment from 0 and adds the segment's sum to the
    row's at the next unflagged entry and at the row's end."""

    values: torch.Tensor   # (slots,) the planes' dtype
    cols: torch.Tensor     # (slots,) int16 offset from x0 (or int32 index)
    sbase: torch.Tensor    # (32·stages + 1,) int64 first slot of each slice
    rowmap: torch.Tensor   # (nt·1024,) int32 internal row at each position
    sptr: torch.Tensor     # (nt + 1,) int32 stages of each group
    x0: torch.Tensor       # (stages,) int32 window start (floats)
    xlen: torch.Tensor     # (stages,) int32 window length (floats)
    nt: int
    nnz: int               # entries that are not padding
    window: int            # widest xlen
    windowed: bool         # K9's layout (one stage per window start)
    flags: Optional[torch.Tensor] = None  # (slots / 32,) int32, segmented

    @property
    def segmented(self) -> bool:
        """P3's layout: each entry flags whether it continues a segment."""
        return self.flags is not None

    @property
    def slots(self) -> int:
        return int(self.values.numel())

    @property
    def nbytes(self) -> int:
        """Bytes of the layout's arrays: what one product streams besides
        x and y."""
        return sum(int(f.numel()) * f.element_size()
                   for f in (self.values, self.cols, self.sbase, self.rowmap,
                             self.sptr, self.x0, self.xlen, self.flags)
                   if f is not None)

    def call_bytes(self, nrhs: int) -> int:
        """Bytes one product of ``nrhs`` fp32 columns must move: the
        layout once, each column of x read once and of y written once."""
        return self.nbytes + 2 * nrhs * self.nt * 1024 * 4


def _row_order(cnt: torch.Tensor) -> torch.Tensor:
    """σ: the internal rows of each group by count, longest first."""
    nrows = cnt.numel()
    cmax = int(cnt.max()) if nrows else 0
    key = (torch.arange(nrows, device=cnt.device) >> 10) * (cmax + 1) \
        + (cmax - cnt)
    return torch.sort(key, stable=True).indices


def row_layout(values: torch.Tensor, lc: torch.Tensor, walk, og: torch.Tensor,
               ga: torch.Tensor, nt: int, *,
               windowed: bool = False) -> WBellRows:
    """The row layout (:class:`WBellRows`) of raw plane arrays: ``values``
    (P, 8, 8, 128), ``lc`` (P, 1, 128), the walk ``(order, ptr)`` of
    :func:`group_walk`, the per-plane output group ``og`` and window start
    ``ga``.  Built with torch ops on ``values``' device."""
    order = walk[0].long()
    return rows_from_steps(values, lc, order, og.long()[order],
                           ga.long()[order], nt, windowed=windowed)


def rows_from_steps(values: torch.Tensor, lc: torch.Tensor,
                    plane: torch.Tensor, og: torch.Tensor, ga: torch.Tensor,
                    nt: int, *, windowed: bool = False) -> WBellRows:
    """:func:`row_layout` of a walk given step by step: step s adds plane
    ``plane[s]`` to group ``og[s]`` with window start ``ga[s]`` (sorted by
    ``og``, as :func:`cgx_torch.kernels.wbell.walk_product` takes it).

    Raises:
      ValueError: windowed, a row's columns do not ascend within a run of
        one window start, so the run cannot be cut into parts.
    """
    dev = values.device
    plane, og, ga = plane.long(), og.long(), ga.long()
    # Entries in walk order: nonzero() is lexicographic in (step, i, j, l).
    s, i, j, l = torch.nonzero(values.ne(0)[plane]).unbind(1)
    p = plane[s]
    val = values[p, i, j, l]
    lcv = lc[p, 0, l].long()
    col = ((ga[s] + (lcv >> 7)) << 10) + (j << 7) + (lcv & 127)
    row = (og[s] << 10) + (i << 7) + l
    if not windowed:
        return rows_from_entries(row, col, val, nt)
    # A stage: a run of non-empty steps with one group and window start.
    steps, at = torch.unique_consecutive(s, return_inverse=True)
    gs, gas = og[steps], ga[steps]
    new = torch.ones(steps.numel(), dtype=torch.bool, device=dev)
    new[1:] = (gs[1:] != gs[:-1]) | (gas[1:] != gas[:-1])
    run = (torch.cumsum(new, 0) - 1)[at]
    # Cut each run by column into parts of `cut` groups of x from its
    # first group: K9's two window buffers fit in shared memory and the
    # offsets in 16 bits whatever the build's span.
    cut = max(1, min(STAGE_WINDOW_GROUPS, ROW_OFFSET_LIMIT >> 10))
    xg = col >> 10
    g_lo = torch.full((int(new.sum()),), nt, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, run, xg, "amin")
    part = (xg - g_lo[run]) // cut
    nparts = int(part.max()) + 1 if part.numel() else 1
    keys, st = torch.unique(run * nparts + part, return_inverse=True)
    return _pack_rows(row, col, val, st, gs[new][keys // nparts], nt,
                      windowed=True)


def rows_from_entries(row: torch.Tensor, col: torch.Tensor,
                      val: torch.Tensor, nt: int, *,
                      step: Optional[torch.Tensor] = None) -> WBellRows:
    """The resident row layout (one stage per group) of entries given in
    walk order: entry e adds ``val[e]·x[col[e]]`` to internal row
    ``row[e]`` (both internal indices), and each row keeps its entries in
    the order given.

    With ``step``, the walk step (plane) that holds each entry, the layout
    is *segmented*: each entry that continues the previous entry's (row,
    step) segment is flagged in :attr:`WBellRows.flags`, and the products
    sum each segment from 0 on its own, then add it to the row's sum (the
    4×8 half-block prototype's rounding).
    """
    return _pack_rows(row, col, val, row >> 10,
                      torch.arange(nt, device=row.device), nt, step=step)


def _pack_rows(row, col, val, st, stage_group, nt, *, windowed=False,
               step=None) -> WBellRows:
    """Slice, pad and store the entries ``(row, col, val)``, given in walk
    order, entry e in stage ``st[e]`` of group ``stage_group[st[e]]``."""
    global row_layout_builds
    row_layout_builds += 1
    dev = row.device
    nrows = nt * 1024
    nst = int(stage_group.numel())
    # Each row's entries together, in walk order (a stable sort by row).
    by_row = torch.sort(row, stable=True).indices
    row, st, col, val = row[by_row], st[by_row], col[by_row], val[by_row]
    if windowed and bool(((row[1:] == row[:-1]) & (st[1:] < st[:-1])).any()):
        raise ValueError("windowed row layout: a row's columns do not ascend "
                         "within a run of one window start")
    n_e = row.numel()
    cont = None
    if step is not None:
        step = step.long()[by_row]
        cont = torch.zeros(n_e, dtype=torch.int64, device=dev)
        if n_e:
            cont[1:] = ((row[1:] == row[:-1])
                        & (step[1:] == step[:-1])).long()
    rowmap = _row_order(torch.bincount(row, minlength=nrows))
    pos_of = torch.empty_like(rowmap)
    pos_of[rowmap] = torch.arange(nrows, device=dev)
    q = pos_of[row] & 1023
    # Rank of an entry within its row's part of its stage.
    first = torch.ones(n_e, dtype=torch.bool, device=dev)
    if n_e:
        first[1:] = (row[1:] != row[:-1]) | (st[1:] != st[:-1])
    starts = torch.nonzero(first)[:, 0]
    rank = torch.arange(n_e, device=dev) - starts[torch.cumsum(first, 0) - 1]
    slice_ = st * ROW_SLICE + (q >> 5)
    width = torch.zeros(nst * ROW_SLICE, dtype=torch.int64, device=dev)
    width.scatter_reduce_(0, slice_, rank + 1, "amax")
    sbase = torch.zeros(nst * ROW_SLICE + 1, dtype=torch.int64, device=dev)
    sbase[1:] = torch.cumsum(width * ROW_SLICE, 0)
    addr = sbase[slice_] + rank * ROW_SLICE + (q & 31)
    # Each stage's window of x: 128-byte aligned start, whole 16-byte units.
    lo = torch.full((nst,), nrows, dtype=torch.int64, device=dev)
    lo.scatter_reduce_(0, st, col, "amin")
    hi = torch.zeros(nst, dtype=torch.int64, device=dev)
    hi.scatter_reduce_(0, st, col, "amax")
    x0 = torch.where(lo < nrows, lo & ~31, 0)
    xlen = torch.where(lo < nrows, (hi + 1 - x0 + 3) & ~3, 0)
    window = int(xlen.max()) if nst else 0
    if window <= ROW_OFFSET_LIMIT:                     # windowed: always
        cdata, cdtype = col - x0[st], torch.int16      # read as unsigned
    else:
        x0 = torch.zeros_like(x0)
        cdata, cdtype = col, torch.int32
    total = int(sbase[-1])
    flags = None
    if cont is not None:
        # Bit e of word sbase/32 + t: slots are sbase + 32·t + e.
        words = torch.zeros(total // ROW_SLICE, dtype=torch.int64,
                            device=dev)
        words.index_add_(0, addr // ROW_SLICE, cont << (addr % ROW_SLICE))
        flags = torch.where(words >= 1 << 31, words - (1 << 32),
                            words).to(torch.int32)
    vals_out = torch.zeros(total, dtype=val.dtype, device=dev)
    vals_out[addr] = val
    cols_out = torch.zeros(total, dtype=cdtype, device=dev)
    cols_out[addr] = cdata.to(torch.int32).to(cdtype)
    sptr = torch.zeros(nt + 1, dtype=torch.int64, device=dev)
    sptr[1:] = torch.cumsum(torch.bincount(stage_group, minlength=nt), 0)
    return WBellRows(values=vals_out, cols=cols_out, sbase=sbase,
                     rowmap=rowmap.to(torch.int32),
                     sptr=sptr.to(torch.int32), x0=x0.to(torch.int32),
                     xlen=xlen.to(torch.int32), nt=int(nt), nnz=int(n_e),
                     window=window, windowed=bool(windowed), flags=flags)


@dataclass(frozen=True, eq=False)
class WBELLMatrix:
    """Windowed block-ELL matrix (see the module docstring)."""

    # Slot planes: plane p holds one 8×8 block per lane (block row).
    values: torch.Tensor       # (P, 8, 8, 128) fp32 (or bf16), [i, j, lane]
    lc: torch.Tensor           # (P, 1, 128) int32 window-local block column
    # Per virtual tile (the windowed kernel K9).
    outg: torch.Tensor         # (ntv,) int32 output group of the tile
    ps: torch.Tensor           # (ntv,) int32 first plane of the tile
    wb: torch.Tensor           # (ntv,) int32 planes in the tile (<= wbcap)
    zi: torch.Tensor           # (ntv,) int32 1 iff first tile of its group
    g0: torch.Tensor           # (ntv,) int32 window start group
    gn: torch.Tensor           # (ntv,) int32 next group's window start
    perm: torch.Tensor         # (n,) int64 RCM permutation
    iperm: torch.Tensor        # (n,) int64 inverse permutation
    diag_internal: torch.Tensor  # (nt, 8, 128) fp32 diagonal
    pgo: torch.Tensor          # (P,) int32 per-plane window group offset
    # Per plane (the resident kernel K7): output group, absolute window
    # start group.
    p_og: torch.Tensor         # (P,) int32
    p_ga: torch.Tensor         # (P,) int32
    shape: Tuple[int, int]
    ng_real: int
    nt: int                    # groups + pad groups
    ngw: int
    wbcap: int
    span: int = 1
    nnz: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def vector_dtype(self) -> torch.dtype:
        """fp32 when the slot planes are stored in bf16, else their dtype."""
        return (torch.float32 if self.values.dtype == torch.bfloat16
                else self.values.dtype)

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz_stored(self) -> int:
        """Stored (densified) values, fill included."""
        return int(self.values.shape[0]) * 64 * 128

    def diagonal(self) -> torch.Tensor:
        """The diagonal in the INTERNAL layout (for Jacobi PCG)."""
        return self.diag_internal

    def to(self, device) -> "WBELLMatrix":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    # -- the per-group walks of the CUDA kernels (built once, cached) -----

    @functools.cached_property
    def resident_walk(self):
        """K7's ``(order, ptr)``: the planes of each output group in plane
        order; all-zero planes (the zero plane, the padding to a multiple
        of 64 planes, the slots of empty tiles, all at ``p_og = 0``) are
        left out, so group 0 carries no extra work."""
        keep = self.values.reshape(self.values.shape[0], -1).ne(0).any(1)
        return group_walk(self.p_og, keep, self.nt)

    @functools.cached_property
    def windowed_walk(self):
        """K9's ``(order, ptr)``: the virtual tiles of each output group in
        tile order (every tile, pad groups' included)."""
        return group_walk(self.outg, torch.ones_like(self.outg,
                                                     dtype=torch.bool),
                          self.nt)

    def windowed_steps(self):
        """K9's walk step by step, ``(plane, og, ga)`` (int64): the planes
        of each group's virtual tiles in tile order, window start ``g0[t]
        + pgo[p]``."""
        torder, _ = self.windowed_walk
        t = torder.long()
        cnt = self.wb.long()[t]
        first = torch.cumsum(cnt, 0) - cnt
        step = torch.arange(int(cnt.sum()), device=cnt.device)
        plane = (torch.repeat_interleave(self.ps.long()[t], cnt) + step
                 - torch.repeat_interleave(first, cnt))
        og = torch.repeat_interleave(self.outg.long()[t], cnt)
        ga = (torch.repeat_interleave(self.g0.long()[t], cnt)
              + self.pgo.long()[plane])
        return plane, og, ga

    @functools.cached_property
    def rows(self) -> WBellRows:
        """K7's row layout: :func:`row_layout` of :attr:`resident_walk`,
        built once, on the matrix's device."""
        return row_layout(self.values, self.lc, self.resident_walk,
                          self.p_og, self.p_ga, self.nt)

    @functools.cached_property
    def windowed_rows(self) -> WBellRows:
        """K9's row layout: its tile walk, split into window stages."""
        return rows_from_steps(self.values, self.lc, *self.windowed_steps(),
                               self.nt, windowed=True)

    # -- solve-boundary layout transforms ----------------------------------

    def to_internal(self, v: torch.Tensor) -> torch.Tensor:
        """(n,) standard-order vector → (nt, 8, 128) internal layout."""
        vp = v.to(self.vector_dtype)[self.perm]
        vp = torch.nn.functional.pad(vp, (0, self.ng_real * 1024 - self.n))
        vi = vp.reshape(self.ng_real, 128, 8).transpose(1, 2)
        return torch.nn.functional.pad(
            vi, (0, 0, 0, 0, 0, self.nt - self.ng_real))

    def from_internal(self, vi: torch.Tensor) -> torch.Tensor:
        """(nt, 8, 128) internal layout → (n,) standard order."""
        v = vi[:self.ng_real].transpose(1, 2).reshape(-1)[:self.n]
        return v[self.iperm]


def _rcm(a_csr):
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(a_csr, symmetric_mode=True),
                      dtype=np.int64)


def _balance_blocks(a, perm: np.ndarray, window: int) -> np.ndarray:
    """Refine ``perm`` with a within-window stable sort of block rows
    (8-row units) by block count, so each 128-lane group holds rows of
    like block counts (the JAX package measured fill 20.7 → 17.5× on the
    thermal2 class at ``window=1024``)."""
    n = a.shape[0]
    ap = a[perm][:, perm].tocoo()
    br = ap.row.astype(np.int64) >> 3
    bc = ap.col.astype(np.int64) >> 3
    nbr = -(-n // 8)
    uid = np.unique(br * nbr + bc)
    cnt = np.bincount(uid // nbr, minlength=nbr)
    sigma = np.empty(nbr, np.int64)
    for w0 in range(0, nbr, window):
        w1 = min(w0 + window, nbr)
        idx = np.arange(w0, w1)
        sigma[w0:w1] = idx[np.argsort(cnt[w0:w1], kind="stable")]
    rp = (sigma[:, None] * 8 + np.arange(8)[None, :]).reshape(-1)
    rp = rp[rp < n]
    return perm[rp]


def _best_wbcap(wbt: np.ndarray, wb_hard_max: int) -> int:
    """The slot cap that minimises the grid work ``ntv(w) * w``."""
    best, best_cost = int(wbt.max()), None
    for w in range(2, int(wbt.max()) + 1):
        cost = int(np.ceil(wbt / w).sum()) * w
        if best_cost is None or cost < best_cost:
            best, best_cost = w, cost
    return min(best, wb_hard_max)


def _scipy_csr(a):
    """A square scipy CSR matrix from a port :class:`CSRMatrix` (any
    device) or anything ``scipy.sparse.csr_matrix`` takes."""
    import scipy.sparse as sp

    if isinstance(a, CSRMatrix):
        a = sp.csr_matrix((a.values.detach().cpu().numpy().astype(np.float64),
                           a.col_indices.cpu().numpy(),
                           a.indptr.cpu().numpy()), shape=a.shape)
    return sp.csr_matrix(a)


def wbell_from_csr(a, *, order: str = "rcm", max_ngw: int = 128,
                   wbcap: int = 0, value_dtype=None, span: int = 16,
                   balance_window: int = 1024,
                   device="cuda") -> WBELLMatrix:
    """Build a :class:`WBELLMatrix` on ``device`` from a CSR matrix (host
    numpy, as :func:`cgx.sparse.wbell.wbell_from_csr`).

    Args:
      a: a port :class:`~cgx_torch.sparse.types.CSRMatrix` or a
        ``scipy.sparse`` matrix.
      order: ``"rcm"`` (bounded windows on mesh-like matrices) or
        ``"natural"``.
      max_ngw: reject matrices whose tile windows exceed this many groups.
      wbcap: virtual-tile slot cap; 0 picks the one with least grid work.
      span: window groups one slot plane may draw x from (16 is the JAX
        package's measured optimum on the TPU).
      balance_window: block-row window of the count-balancing sort; 0
        disables it.
      value_dtype: slot-plane storage dtype (default fp32); ``bfloat16``
        halves the stored bytes and the kernels upcast in registers.  The
        diagonal stays fp32.

    Raises:
      ValueError: the window exceeds ``max_ngw`` (no bounded-window tiling
        for this matrix and ordering).
    """
    dev = resolve_device(device)
    a = _scipy_csr(a)
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("wbell_from_csr needs a square matrix")

    perm = _rcm(a) if order == "rcm" else np.arange(n, dtype=np.int64)
    if balance_window:
        perm = _balance_blocks(a, perm, int(balance_window))
    ap = a[perm][:, perm].tocsr()
    ap.sort_indices()
    coo = ap.tocoo()
    row = coo.row.astype(np.int64)
    col = coo.col.astype(np.int64)
    val = coo.data.astype(np.float32)

    nbr = -(-n // 8)                  # block rows
    ng_real = -(-nbr // 128)          # real groups

    # Unique 8×8 blocks, ordered (block row, block col).
    br, bc = row >> 3, col >> 3
    key = br * nbr + bc
    uid, inv = np.unique(key, return_inverse=True)
    ub_r, ub_c = uid // nbr, uid % nbr
    nblocks = len(uid)
    tile_of_block = ub_r >> 7

    # Planes packed per (tile, bucket of `span` window groups).
    bucket = (ub_c >> 7) // span
    chg = np.empty(nblocks, bool)
    if nblocks:
        chg[0] = True
        chg[1:] = (ub_r[1:] != ub_r[:-1]) | (bucket[1:] != bucket[:-1])
    grp_start = np.flatnonzero(chg)
    grp_id = np.cumsum(chg) - 1
    rank_rb = np.arange(nblocks, dtype=np.int64) - grp_start[grp_id]

    nb = int(bucket.max()) + 1 if nblocks else 1
    tb_key = tile_of_block * nb + bucket
    tb_uid, tb_inv = np.unique(tb_key, return_inverse=True)
    tb_tile = tb_uid // nb
    wbt_tb = np.zeros(len(tb_uid), np.int64)
    np.maximum.at(wbt_tb, tb_inv, rank_rb + 1)
    pstart_tb = np.concatenate([[0], np.cumsum(wbt_tb[:-1])])

    # Per-tile slot totals (an empty tile keeps one zero-plane slot).
    wbt = np.zeros(ng_real, np.int64)
    np.add.at(wbt, tb_tile, wbt_tb)
    wbt = np.maximum(wbt, 1)
    pstart = np.concatenate([[0], np.cumsum(wbt[:-1])])
    p_real = int(wbt.sum())
    tile_tb0 = np.full(ng_real, np.int64(2) ** 62)
    np.minimum.at(tile_tb0, tb_tile, pstart_tb)
    offset_tb = pstart_tb - tile_tb0[tb_tile]
    plane = pstart[tile_of_block] + offset_tb[tb_inv] + rank_rb

    # Windows, with span-aligned starts.
    g0t = np.full(ng_real, 2**31, np.int64)
    gmax = np.zeros(ng_real, np.int64)
    np.minimum.at(g0t, tile_of_block, ub_c >> 7)
    np.maximum.at(gmax, tile_of_block, ub_c >> 7)
    g0t = np.where(g0t == 2**31, 0, g0t)
    g0t = (g0t // span) * span
    end_al = -(-(gmax + 1) // span) * span
    ngw = max(int((end_al - g0t).max()), span)
    if ngw > max_ngw:
        raise ValueError(
            f"WBELL window needs {ngw} groups > max_ngw={max_ngw}; "
            "this matrix/ordering has no bounded-window tiling")
    nt = ng_real + ngw                # pad groups keep windows in bounds
    g0t = np.minimum(g0t, nt - ngw)

    # Slot planes (+1 zero plane).
    lane = ub_r & 127
    values = np.zeros((p_real + 1, 8, 8, 128), np.float32)
    lcp = np.zeros((p_real + 1, 1, 128), np.int32)
    np.add.at(values, (plane[inv], row & 7, col & 7, lane[inv]), val)
    lcp[plane, 0, lane] = ((ub_c & 127)
                           + 128 * ((ub_c >> 7)
                                    - bucket * span)).astype(np.int32)
    pgo = np.zeros(p_real + 1, np.int64)
    tb_planes = pstart[tb_tile] + offset_tb
    plane_idx = np.repeat(tb_planes, wbt_tb) + (
        np.arange(int(wbt_tb.sum()), dtype=np.int64)
        - np.repeat(pstart_tb, wbt_tb))
    pgo[plane_idx] = np.repeat((tb_uid % nb) * span - g0t[tb_tile], wbt_tb)
    assert pgo.min() >= 0 and pgo.max() + span <= ngw

    # Per-plane output group and absolute window start; planes padded to a
    # multiple of 64 (the zero plane and the pad carry p_og = 0).
    p_og = np.zeros(p_real + 1, np.int64)
    p_og[:p_real] = np.repeat(np.arange(ng_real, dtype=np.int64), wbt)
    p_ga = np.zeros(p_real + 1, np.int64)
    p_ga[plane_idx] = np.repeat((tb_uid % nb) * span, wbt_tb)
    assert p_ga.max() + span <= nt
    pad_p = (-(p_real + 1)) % 64
    if pad_p:
        values = np.concatenate(
            [values, np.zeros((pad_p, 8, 8, 128), np.float32)])
        lcp = np.concatenate([lcp, np.zeros((pad_p, 1, 128), np.int32)])
        pgo = np.concatenate([pgo, np.zeros(pad_p, np.int64)])
        p_og = np.concatenate([p_og, np.zeros(pad_p, np.int64)])
        p_ga = np.concatenate([p_ga, np.zeros(pad_p, np.int64)])

    # Virtual tiles.
    if wbcap <= 0:
        wbcap = _best_wbcap(wbt, wb_hard_max=64)
    nv = -(-wbt // wbcap)
    outg = np.repeat(np.arange(ng_real, dtype=np.int64), nv)
    vidx = np.arange(len(outg)) - np.repeat(
        np.concatenate([[0], np.cumsum(nv[:-1])]), nv)
    ps_v = pstart[outg] + vidx * wbcap
    wb_v = np.minimum(wbcap, wbt[outg] - vidx * wbcap)
    zi_v = (vidx == 0).astype(np.int64)
    g0_v = g0t[outg]
    g0_full = np.concatenate([g0t, np.zeros(ngw, np.int64)])
    gn_v = np.where(outg + 1 < nt, g0_full[np.minimum(outg + 1, nt - 1)], -1)

    # Pad groups: one virtual tile each, on the zero plane.
    pg = np.arange(ng_real, nt, dtype=np.int64)
    outg = np.concatenate([outg, pg])
    ps_v = np.concatenate([ps_v, np.full(ngw, p_real)])
    wb_v = np.concatenate([wb_v, np.ones(ngw, np.int64)])
    zi_v = np.concatenate([zi_v, np.ones(ngw, np.int64)])
    g0_v = np.concatenate([g0_v, np.zeros(ngw, np.int64)])
    gn_v = np.concatenate([gn_v, np.where(pg + 1 < nt, 0, -1)])

    # Diagonal and transforms: permuted row r = 8b + e, b = 128g + l sits
    # at internal index 1024g + 128e + l.
    diag = np.zeros(nt * 1024, np.float32)
    dp = ap.diagonal().astype(np.float32)
    r_all = np.arange(n, dtype=np.int64)
    b_all = r_all >> 3
    internal_idx = ((b_all >> 7) << 10) + ((r_all & 7) << 7) + (b_all & 127)
    diag[internal_idx] = dp
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)

    def i32(v):
        return torch.from_numpy(np.asarray(v, np.int32)).to(dev)

    vdt = torch.float32 if value_dtype is None else value_dtype
    return WBELLMatrix(
        values=torch.from_numpy(values).to(dev).to(vdt),
        lc=i32(lcp), outg=i32(outg), ps=i32(ps_v), wb=i32(wb_v),
        zi=i32(zi_v), g0=i32(g0_v), gn=i32(gn_v),
        perm=torch.from_numpy(perm.copy()).to(dev),
        iperm=torch.from_numpy(iperm).to(dev),
        diag_internal=torch.from_numpy(diag.reshape(nt, 8, 128)).to(dev),
        pgo=i32(pgo), p_og=i32(p_og), p_ga=i32(p_ga),
        shape=(n, n), ng_real=int(ng_real), nt=int(nt), ngw=int(ngw),
        wbcap=int(wbcap), span=int(span), nnz=int(a.nnz))


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def pick_format(a, *, min_rows_wbell: int = WBELL_MIN_ROWS,
                ell_waste_max: float = 1.5, device="cuda",
                allow_wbell: bool = True) -> str:
    """The storage decision for a general CSR operator, with no build:
    ``"ell"`` when the 8-padded width wastes at most ``ell_waste_max``
    slots per nonzero, ``"wbell"`` for a large irregular matrix on CUDA
    (where the JAX package says TPU), else ``"csr"``.  ``a`` needs only
    ``indptr``, ``shape`` and ``nnz``; deciding builds nothing, so
    ``device="cuda"`` needs no card."""
    deg = np.diff(_host(a.indptr))
    w = -(-int(deg.max()) // 8) * 8
    waste = float(w * a.shape[0]) / max(int(_host(a.nnz)), 1)
    if waste <= ell_waste_max:
        return "ell"
    if allow_wbell and a.shape[0] >= min_rows_wbell \
            and torch.device(device).type == "cuda":
        return "wbell"
    return "csr"


def auto_format(a, *, min_rows_wbell: int = WBELL_MIN_ROWS,
                ell_waste_max: float = 1.5, value_dtype=None,
                device="cuda"):
    """``(operator, fmt)`` with ``fmt`` in ``{"ell", "wbell", "csr"}``:
    the format :func:`pick_format` chooses, built on ``device``.  A matrix
    with no bounded-window tiling stays CSR; a CSR result is ``a``
    itself, unchanged."""
    fmt = pick_format(a, min_rows_wbell=min_rows_wbell,
                      ell_waste_max=ell_waste_max, device=device)
    if fmt == "ell":
        return ell_from_csr(a, width_multiple=8, device=device), "ell"
    if fmt == "wbell":
        try:
            return wbell_from_csr(a, value_dtype=value_dtype,
                                  device=device), "wbell"
        except ValueError:
            pass          # no bounded-window tiling for this matrix
    return a, "csr"

"""K7–K10: the WBELL SpMV/SpMM — CUDA kernels and their plain versions.

Counterpart of :mod:`cgx.kernels.wbell`.  All of them compute ``Y = A·X``
on the internal layout ``(nrhs, nt, 8, 128)`` of a
:class:`~cgx_torch.sparse.wbell.WBELLMatrix`:

* **K7** (``wbell_resident_raw``, replaces ``_kernel_resident``): reads
  the compact row layout (:class:`~cgx_torch.sparse.wbell.WBellRows`,
  :attr:`WBELLMatrix.rows`), one warp per slice of 32 internal rows, one
  thread per row, x gathered from the L2.  ``wbell_spmv`` and
  ``wbell_spmm`` take it by default: the card has no VMEM cap, so
  ``_dispatch("auto")`` always picks it.
* **K9** (``wbell_spmv(..., backend="windowed")``, replaces ``_kernel``):
  reads the windowed row layout (:attr:`WBELLMatrix.windowed_rows`), one
  block per output group, each stage's window of x copied into shared
  memory with ``cp.async.bulk`` (the TPU kernel's windowed DMA).
* **K8** (``wbell_tiered_raw``, replaces ``_kernel_resident_tiers``):
  K7's kernel over the row layout of a :class:`WBellTierPlan`, whose slot
  planes are stored class-major {≤4, ≤8, ≤16} with tight window starts
  packed as ``og << 16 | ga``.  The layout keeps each group's planes in
  their original plane order (the plan's ``origin``), not class by class
  as the TPU grid does: the classes shorten a TPU gather chain the card
  does not have.  In that order, with the same absolute columns, the
  layout (:func:`tiered_rows` of the plan's walk) has
  :attr:`WBELLMatrix.rows`' arrays, so the plan holds the matrix's layout
  itself (:attr:`WBellTierPlan.rows`) rather than a copy: K8 equals K7 bit
  for bit and a column of the multi-RHS solve equals the single-RHS solve
  of that column.
* **K10** (``wbell_spmm_stacked``, replaces ``_kernel_resident_stacked``):
  K7's kernel over K7's row layout (:attr:`WBELLMatrix.rows`) with ``X``
  and ``Y`` in the stacked layout ``(nt, k·8, 128)`` (:func:`to_stacked`,
  :func:`from_stacked`), read and written in place by the kernel
  (``Stacked::at`` in the CUDA source); it equals K7 bit for bit.  The TPU
  measured it slower than K7 (docs/PERF_NOTES.md 5a); nothing routes to
  it.

The CUDA source is ``cgx_torch/csrc/wbell.cu``.  Each wrapper launches its
kernel for a CUDA tensor and takes the plain PyTorch version only for a
CPU tensor.  Every kernel and plain version rounds each product and sum
on its own, in walk order (plane order, then j) from 0: the row layout's
(:func:`rows_product`) over the nonzeros, the planes' (:func:`walk_product`)
over every slot.  On finite x the two agree bit for bit, since adding an
exact ±0 product leaves the sum as it was.  A segmented layout (the 4×8
half-block prototype P3's) sums each (row, plane) segment from 0 first,
as that prototype does.  ``wbell_resident_launches``,
``wbell_tiered_launches``, ``wbell_windowed_launches`` and
``wbell_stacked_launches`` count launches.  The plane walks that K7, K8,
K9 and K10 replace stay as ``_planes_k7``, ``_planes_k8``, ``_planes_k9``
and ``_planes_k10`` (CUDA only, counted nowhere): the same-run "before"
of the tests and the smoke.

Not ported, because they encode TPU VMEM: ``_resident_fits``,
``_RESIDENT_VMEM_CAP``, ``_SPLANE``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.sparse.wbell import (ROW_SLICE, WBELLMatrix, WBellRows,
                                    group_walk, row_layout, rows_from_steps)

__all__ = ["wbell_spmv", "wbell_spmm", "wbell_matvec", "wbell_resident_raw",
           "wbell_windowed", "wbell_tiered_raw", "WBellTierPlan",
           "build_tier_plan", "wbell_spmm_tiered", "walk_product",
           "rows_product", "tiered_rows",
           "wbell_resident_reference", "wbell_tiered_reference",
           "wbell_windowed_reference", "wbell_spmm_stacked",
           "wbell_stacked_reference", "to_stacked", "from_stacked",
           "wbell_resident_launches", "wbell_tiered_launches",
           "wbell_windowed_launches", "wbell_stacked_launches"]

# Kernel launches so far (a run resets them to show which kernels it used).
wbell_resident_launches = 0
wbell_tiered_launches = 0
wbell_windowed_launches = 0
wbell_stacked_launches = 0


# -- plain versions ---------------------------------------------------------

def walk_product(x: torch.Tensor, values: torch.Tensor, lc: torch.Tensor,
                 plane: torch.Tensor, og: torch.Tensor, ga: torch.Tensor,
                 nt: int) -> torch.Tensor:
    """Plain ``Y[c, og_s] += Σ_j values[plane_s, :, j, :] ·
    X[c, ga_s + lc // 128, j, lc % 128]`` over the walk ``s`` (sorted by
    ``og``), each group's planes in walk order, ``j`` in order, every
    product and sum rounded on its own.  Runs in rounds: round ``r`` takes
    the r-th plane of every group at once."""
    nrhs = x.shape[0]
    y = torch.zeros((nrhs, nt, 8, 128), dtype=x.dtype, device=x.device)
    if plane.numel() == 0:
        return y
    og, plane, ga = og.long(), plane.long(), ga.long()
    rank = (torch.arange(og.numel(), device=og.device)
            - torch.searchsorted(og, og))
    by_rank = torch.argsort(rank, stable=True)
    for sel in torch.split(by_rank, torch.bincount(rank).tolist()):
        p, g = plane[sel], og[sel]
        lcs = lc[p, 0].long()                          # (s, 128)
        grp = ga[sel, None] + (lcs >> 7)
        xg = x[:, grp, :, lcs & 127].permute(2, 0, 3, 1)  # (nrhs, s, 8, 128)
        v = values[p].to(x.dtype)                      # (s, 8, 8, 128)
        acc = y[:, g]
        for j in range(8):
            acc = acc + v[:, :, j, :] * xg[:, :, j, None, :]
        y[:, g] = acc
    return y


def rows_product(rows: WBellRows, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the row kernels (K7, K8, K9, P1, P3) over a row
    layout: ``x`` ``(nrhs, nt, 8, 128)`` → the same shape.  Each group's
    stages in order, each slice's slots in order, ``acc = acc + v·x`` from
    0, every product and sum rounded on its own, as the kernels sum; over a
    segmented layout ``part = part + v·x`` from 0 per segment and ``acc =
    acc + part`` at each unflagged entry and at the end.  Runs in rounds:
    round r takes the r-th stage of every group, slot t of every slice at
    once."""
    nrhs, nt = x.shape[0], rows.nt
    dev = x.device
    xf = x.reshape(nrhs, -1)
    acc = torch.zeros((nrhs, nt * 1024), dtype=x.dtype, device=dev)
    part = torch.zeros_like(acc) if rows.segmented else None
    sptr = rows.sptr.long()
    nst = int(sptr[-1])
    if nst:
        sgroup = torch.repeat_interleave(torch.arange(nt, device=dev),
                                         sptr[1:] - sptr[:-1])
        srank = torch.arange(nst, device=dev) - sptr[sgroup]
        width = ((rows.sbase[1:] - rows.sbase[:-1]) // ROW_SLICE).reshape(
            nst, ROW_SLICE)
        e = torch.arange(ROW_SLICE, device=dev)
        x0 = rows.x0.long()
        for r in range(int(srank.max()) + 1):
            st = torch.nonzero(srank == r)[:, 0]
            w = width[st]
            for t in range(int(w.max())):
                si, wi = torch.nonzero(w > t).unbind(1)
                sts = st[si]
                addr = (rows.sbase[sts * ROW_SLICE + wi, None]
                        + t * ROW_SLICE + e)
                pos = (sgroup[sts] * 1024 + wi * ROW_SLICE)[:, None] + e
                v = rows.values[addr].to(x.dtype)
                c = rows.cols[addr].long()
                if rows.cols.dtype == torch.int16:
                    c = c & 0xFFFF
                prod = v * xf[:, x0[sts, None] + c]
                if rows.segmented:
                    word = rows.flags[addr // ROW_SLICE].long()
                    new = ((word >> (addr % ROW_SLICE)) & 1) == 0
                    p = part[:, pos]
                    acc[:, pos] = torch.where(new, acc[:, pos] + p,
                                              acc[:, pos])
                    part[:, pos] = torch.where(new, torch.zeros_like(p),
                                               p) + prod
                else:
                    acc[:, pos] = acc[:, pos] + prod
    if rows.segmented:
        acc = acc + part
    y = torch.empty_like(acc)
    y[:, rows.rowmap.long()] = acc
    return y.reshape(x.shape)


def _resident_plain(p_og, p_ga, lc, values, x, walk):
    order = walk[0].long()
    return walk_product(x, values, lc, order, p_og.long()[order],
                        p_ga.long()[order], x.shape[1])


def _tiered_plain(packed, lc, values, x, walk):
    order = walk[0].long()
    pg = packed.long()[order]
    return walk_product(x, values, lc, order, (pg >> 16) & 0xFFFF,
                        pg & 0xFFFF, x.shape[1])


def wbell_resident_reference(a: WBELLMatrix, x: torch.Tensor):
    """K7's plane walk, plain, on any device: ``x`` ``(nrhs, nt, 8,
    128)``; equal to :func:`rows_product` of ``a.rows`` on finite x."""
    return _resident_plain(a.p_og, a.p_ga, a.lc, a.values,
                           x.to(a.vector_dtype), a.resident_walk)


def wbell_tiered_reference(plan: "WBellTierPlan", x: torch.Tensor):
    """K8's plane walk, plain, on any device: equal to :func:`rows_product`
    of ``plan.rows`` on finite x."""
    return _tiered_plain(plan.packed, plan.lc, plan.values,
                         x.to(plan.vector_dtype), plan.walk)


def wbell_windowed_reference(a: WBELLMatrix, x: torch.Tensor):
    """K9's plane walk, plain, on any device: the planes by virtual tile."""
    x = x.to(a.vector_dtype)
    return walk_product(x, a.values, a.lc, *a.windowed_steps(), x.shape[1])


# -- launches ---------------------------------------------------------------

def _check_x(x: torch.Tensor, nt: int, what: str) -> None:
    if x.dim() != 4 or tuple(x.shape[1:]) != (nt, 8, 128):
        raise ValueError(f"{what}: expected batched internal layout "
                         f"(nrhs, {nt}, 8, 128), got {tuple(x.shape)}")


def _launch(fn: str, what: str, values, lc, x, *ints32, nt=None,
            nrhs=None):
    """Check the operands, launch C entry ``fn`` and return ``y`` (shaped
    as ``x``; ``nt`` and ``nrhs`` default to the batched layout's)."""
    from cgx_torch.kernels import _build

    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16 "
                        f"planes, got {values.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32 vectors, got "
                        f"{x.dtype}")
    for v in (values, x, lc) + ints32:
        if v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel needs contiguous "
                             f"operands on {x.device}")
    for v in (lc,) + ints32:
        if v.dtype != torch.int32:
            raise ValueError(f"{what}: index arrays must be int32")
    bf16 = int(values.dtype == torch.bfloat16)
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(values.data_ptr(), bf16, lc.data_ptr(),
                              *(v.data_ptr() for v in ints32), x.data_ptr(),
                              y.data_ptr(),
                              x.shape[1] if nt is None else nt,
                              x.shape[0] if nrhs is None else nrhs, stream)
    _build.check(rc, f"{what} launch")
    return y


def _launch_rows(rows: WBellRows, x: torch.Tensor, what: str, *,
                 stacked: bool = False):
    """Check the operands, launch the row kernel (resident layout: K7, K8,
    P1, P3 segmented; ``stacked``: K10, x and y ``(nt, nrhs·8, 128)``) or
    K9's (windowed) over ``rows`` and return ``y`` (shaped as ``x``)."""
    from cgx_torch.kernels import _build

    if rows.values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16 "
                        f"planes, got {rows.values.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32 vectors, got "
                        f"{x.dtype}")
    if x.device != rows.values.device or not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel needs a contiguous x on "
                         f"{rows.values.device}")
    if stacked:
        if rows.windowed or rows.segmented:
            raise ValueError(f"{what}: the stacked kernel reads a resident, "
                             f"unsegmented row layout")
        if x.dim() != 3 or x.shape[0] != rows.nt or x.shape[1] % 8 \
                or x.shape[1] == 0 or x.shape[2] != 128:
            raise ValueError(f"{what}: stacked layout is (nt={rows.nt}, "
                             f"k*8, 128); got {tuple(x.shape)}")
    else:
        _check_x(x, rows.nt, what)
    if x.data_ptr() % 16:
        x = x.clone()                # cp.async.bulk reads 16-byte units
    y = torch.empty_like(x)
    lib = _build.library()
    bf16 = int(rows.values.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stacked:
            rc = lib.cgx_wbell_rows_stacked(
                rows.values.data_ptr(), bf16, rows.cols.data_ptr(),
                int(rows.cols.dtype == torch.int32), rows.sbase.data_ptr(),
                rows.rowmap.data_ptr(), rows.x0.data_ptr(), x.data_ptr(),
                y.data_ptr(), rows.nt, x.shape[1] // 8, stream)
        elif rows.windowed:
            rc = lib.cgx_wbell_rows_windowed(
                rows.values.data_ptr(), bf16, rows.cols.data_ptr(),
                rows.sbase.data_ptr(), rows.rowmap.data_ptr(),
                rows.sptr.data_ptr(), rows.x0.data_ptr(),
                rows.xlen.data_ptr(), x.data_ptr(), y.data_ptr(), rows.nt,
                x.shape[0], rows.window, stream)
        else:
            rc = lib.cgx_wbell_rows(
                rows.values.data_ptr(), bf16, rows.cols.data_ptr(),
                int(rows.cols.dtype == torch.int32),
                rows.flags.data_ptr() if rows.segmented else None,
                rows.sbase.data_ptr(),
                rows.rowmap.data_ptr(), rows.x0.data_ptr(), x.data_ptr(),
                y.data_ptr(), rows.nt, x.shape[0], stream)
    _build.check(rc, f"{what} launch")
    return y


def _on_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def wbell_resident_raw(p_og: torch.Tensor, p_ga: torch.Tensor,
                       lc: torch.Tensor, values: torch.Tensor,
                       x: torch.Tensor, *, walk=None,
                       rows: Optional[WBellRows] = None) -> torch.Tensor:
    """K7 on raw plane arrays: ``x`` ``(nrhs, nt, 8, 128)`` → the same
    shape, through their row layout.  ``rows`` is the layout
    (:attr:`WBELLMatrix.rows`) and ``walk`` the per-group ``(order, ptr)``
    (:attr:`WBELLMatrix.resident_walk`); each is built here when None."""
    global wbell_resident_launches
    if rows is None:
        nt = x.shape[1]
        if walk is None:
            keep = values.reshape(values.shape[0], -1).ne(0).any(1)
            walk = group_walk(p_og, keep, nt)
        rows = row_layout(values, lc, walk, p_og, p_ga, nt)
    if not _on_device(x, "wbell_resident_raw"):
        return rows_product(rows, x)
    y = _launch_rows(rows, x, "wbell_resident_raw")
    wbell_resident_launches += 1
    return y


def wbell_windowed(a: WBELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """K9: the same product over the windowed row layout, each stage's
    window of x staged in shared memory."""
    global wbell_windowed_launches
    _check_x(x, a.nt, "wbell kernel")
    x = x.to(a.vector_dtype).contiguous()
    if not _on_device(x, "wbell_windowed"):
        return rows_product(a.windowed_rows, x)
    y = _launch_rows(a.windowed_rows, x, "wbell_windowed")
    wbell_windowed_launches += 1
    return y


def _planes_k7(a: WBELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """The plane-walking kernel behind K10, over K7's walk in the batched
    layout: the row layout's same-run "before" in the smoke and tests.
    CUDA only; counted nowhere."""
    return _launch("cgx_wbell_resident", "plane walk", a.values, a.lc, x,
                   *a.resident_walk, a.p_ga)


def _planes_k8(plan: "WBellTierPlan", x: torch.Tensor) -> torch.Tensor:
    """The plane walk over a tier plan's class-major planes in
    :attr:`WBellTierPlan.walk` (K8's and P1's "before"); CUDA only."""
    return _launch("cgx_wbell_tiered", "plane walk", plan.values, plan.lc, x,
                   *plan.walk, plan.packed)


def _planes_k9(a: WBELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """The plane walk by virtual tile (K9's "before"); CUDA only."""
    torder, tptr = a.windowed_walk
    return _launch("cgx_wbell_windowed", "plane walk", a.values, a.lc, x,
                   torder, tptr, a.ps, a.wb, a.g0, a.pgo)


def _planes_k10(a: WBELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """K10's first design: the plane walk in K7's order on the stacked
    layout ``(nt, k·8, 128)`` (K10's "before"); CUDA only, counted
    nowhere."""
    return _launch("cgx_wbell_stacked", "plane walk", a.values, a.lc, x,
                   *a.resident_walk, a.p_ga, nt=a.nt, nrhs=x.shape[1] // 8)


def _wbell_call_resident(a: WBELLMatrix, x: torch.Tensor) -> torch.Tensor:
    _check_x(x, a.nt, "wbell kernel")
    return wbell_resident_raw(a.p_og, a.p_ga, a.lc, a.values,
                              x.to(a.vector_dtype).contiguous(),
                              rows=a.rows)


def _dispatch(a: WBELLMatrix, x: torch.Tensor, backend: str):
    # "auto" is always the resident kernel: the card has no VMEM cap.
    if backend in ("auto", "resident"):
        return _wbell_call_resident(a, x)
    if backend == "windowed":
        return wbell_windowed(a, x)
    raise ValueError(f"unknown wbell backend {backend!r}")


def wbell_spmv(a: WBELLMatrix, x: torch.Tensor, *,
               backend: str = "auto") -> torch.Tensor:
    """``y = A @ x`` on internal-layout ``x``: ``(nt, 8, 128)`` → same.
    ``backend``: ``"auto"`` or ``"resident"`` (K7), ``"windowed"`` (K9)."""
    return _dispatch(a, x[None], backend)[0]


def wbell_spmm(a: WBELLMatrix, x: torch.Tensor, *,
               backend: str = "auto") -> torch.Tensor:
    """``Y = A @ X`` on a batch of internal-layout columns ``(nrhs, nt, 8,
    128)``; one read of the row layout serves up to 8 columns."""
    return _dispatch(a, x, backend)


# -- the column-stacked layout (K10) ------------------------------------------

def to_stacked(xb: torch.Tensor) -> torch.Tensor:
    """Batched internal ``(k, nt, 8, 128)`` → stacked ``(nt, k·8, 128)``."""
    k, nt = xb.shape[0], xb.shape[1]
    return xb.movedim(0, 1).reshape(nt, k * 8, 128)


def from_stacked(xs: torch.Tensor) -> torch.Tensor:
    """Stacked ``(nt, k·8, 128)`` → batched internal ``(k, nt, 8, 128)``."""
    nt, k8 = xs.shape[0], xs.shape[1]
    return xs.reshape(nt, k8 // 8, 8, 128).movedim(1, 0)


def wbell_stacked_reference(a: WBELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """K10's plain version on any device: K7's plane walk through the
    batched layout (the same sums in the same order)."""
    return to_stacked(wbell_resident_reference(a, from_stacked(x)))


def wbell_spmm_stacked(a: WBELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """K10: ``Y = A @ X`` on the stacked layout ``(nt, k·8, 128)`` (column
    c of a group in rows ``c·8 .. c·8+7``) over the row layout
    :attr:`WBELLMatrix.rows`; equal to :func:`wbell_spmm` on the batched
    layout bit for bit.  Raises for ``nt >= 65536``, as the JAX package
    does."""
    global wbell_stacked_launches
    nt = a.nt
    if nt >= 1 << 16:
        raise ValueError(f"wbell_spmm_stacked: nt={nt} must be < 65536")
    if x.dim() != 3 or x.shape[0] != nt or x.shape[1] % 8 \
            or x.shape[1] == 0 or x.shape[2] != 128:
        raise ValueError(f"stacked layout is (nt={nt}, k*8, 128); got "
                         f"{tuple(x.shape)}")
    x = x.to(a.vector_dtype).contiguous()
    if not _on_device(x, "wbell_spmm_stacked"):
        return wbell_stacked_reference(a, x)
    y = _launch_rows(a.rows, x, "wbell_spmm_stacked", stacked=True)
    wbell_stacked_launches += 1
    return y


def wbell_matvec(a: WBELLMatrix, v: torch.Tensor) -> torch.Tensor:
    """``y = A v`` on a standard-order ``(n,)`` vector (a layout round trip
    per call; the solvers stay in the internal layout)."""
    return a.from_internal(wbell_spmv(a, a.to_internal(v)))


# -- the width-tiered plan (K8) ----------------------------------------------

@dataclass(frozen=True, eq=False)
class WBellTierPlan:
    """The planes of a :class:`WBELLMatrix` sorted into classes of actual
    window width {≤4, ≤8, ≤16} with tight per-plane window starts (built by
    :func:`build_tier_plan`).  On the TPU the classes shorten the per-plane
    gather chain; on the card K8 reads their row layout (:attr:`rows`),
    which in K7's plane order is the matrix's own."""

    values: torch.Tensor   # (Ptot, 8, 8, 128) class-major
    lc: torch.Tensor       # (Ptot, 1, 128) int32, tight window offsets
    packed: torch.Tensor   # (Ptot,) int32, og << 16 | tight ga
    origin: torch.Tensor   # (Ptot,) int32, the matrix plane (-1: padding)
    steps: Tuple[int, ...]
    splane: int
    nt: int
    # K8's row layout: the matrix's WBELLMatrix.rows, which equals
    # tiered_rows of :attr:`walk` array for array.
    rows: WBellRows

    @property
    def vector_dtype(self) -> torch.dtype:
        return (torch.float32 if self.values.dtype == torch.bfloat16
                else self.values.dtype)

    @functools.cached_property
    def walk(self):
        """K8's ``(order, ptr)``: each output group's non-zero planes in
        their original plane order."""
        keep = self.values.reshape(self.values.shape[0], -1).ne(0).any(1)
        return group_walk((self.packed.long() >> 16) & 0xFFFF, keep, self.nt,
                          within=self.origin)


def tiered_rows(packed: torch.Tensor, lc: torch.Tensor,
                values: torch.Tensor, walk, nt: int) -> WBellRows:
    """The row layout of class-major planes (a tier plan's, or P1's
    ``build_tiers``) in ``walk`` ``(order, ptr)``, output group and window
    start unpacked from ``packed = og << 16 | ga``."""
    order = walk[0].long()
    pg = packed.long()[order]
    return rows_from_steps(values, lc, order, (pg >> 16) & 0xFFFF,
                           pg & 0xFFFF, nt)


_TIER_SPANS = (4, 8, 16)


def _tier_classes(nz: np.ndarray, lc: np.ndarray, p_og: np.ndarray,
                  p_ga: np.ndarray, nt: int):
    """Classify planes by actual window width, with tight window starts
    clamped so that ``ga + w <= nt`` (host numpy, as the JAX package).
    ``nz`` ``(P, 128)`` marks the lanes that hold a non-zero block.
    Returns, per class of :data:`_TIER_SPANS`, ``(idx, lc_rebased, og,
    ga)`` with ``idx`` the class's planes."""
    gloc = (lc[:, 0, :] // 128).astype(np.int64)
    big = np.int64(1) << 40          # int64 before np.where (NEP 50)
    gmin = np.where(nz, gloc, big).min(axis=1)
    gmin = np.where(gmin == big, 0, gmin)
    width = np.maximum(np.where(nz, gloc, -1).max(axis=1) - gmin + 1, 1)
    cls = np.select([width <= w for w in _TIER_SPANS],
                    _TIER_SPANS, _TIER_SPANS[-1])
    out = []
    for w in _TIER_SPANS:
        idx = np.flatnonzero(cls == w)
        l = lc[idx].copy()
        og = p_og[idx].astype(np.int64)
        ga = np.minimum(p_ga[idx].astype(np.int64) + gmin[idx], nt - w)
        shift = (p_ga[idx].astype(np.int64) + gmin[idx]) - ga   # >= 0
        l[:, 0, :] = np.where(
            nz[idx], l[:, 0, :] - 128 * (gmin[idx] - shift)[:, None], 0)
        if len(idx) and not (0 <= (l[:, 0, :] // 128).min()
                             and (l[:, 0, :] // 128).max() < w
                             and (ga >= 0).all() and (ga + w <= nt).all()):
            raise AssertionError(f"tier class {w}: window out of range")
        out.append((idx, l, og, ga))
    return out


def _pad_tier_class(idx, l, og, ga, n_target: int):
    """Pad one class to ``n_target`` planes (index -1: a zero plane) and
    pack ``og << 16 | ga``."""
    pad = n_target - len(idx)
    if pad < 0:
        raise ValueError("tier class larger than its target")
    if pad:
        idx = np.concatenate([idx, np.full(pad, -1, np.int64)])
        l = np.concatenate([l, np.zeros((pad, 1, 128), np.int32)])
        og = np.concatenate([og, np.zeros(pad, np.int64)])
        ga = np.concatenate([ga, np.zeros(pad, np.int64)])
    return idx, l, (og.astype(np.int32) << 16) | ga.astype(np.int32)


def build_tier_plan(a: WBELLMatrix,
                    splane: Optional[int] = None) -> WBellTierPlan:
    """Classify the planes by actual window width, re-base each plane's
    window to its own least group, sort class-major and pad each class to
    a multiple of ``splane`` (8, as the JAX package pads off the TPU, so
    the plans compare equal).  Needs ``a.span <= 16`` and ``a.nt < 65536``
    (``og`` and ``ga`` are packed 16 bits each).  The plan lands on
    ``a``'s device."""
    if a.span > _TIER_SPANS[-1]:
        raise ValueError(f"tier plan supports span <= {_TIER_SPANS[-1]}")
    if a.nt >= 1 << 16:
        raise ValueError(f"tier plan packs og/ga in 16 bits: nt={a.nt} "
                         "must be < 65536")
    splane = 8 if splane is None else int(splane)
    nz = (a.values.float().abs().sum(dim=(1, 2)) > 0).cpu().numpy()
    host = [v.cpu().numpy() for v in (a.lc, a.p_og, a.p_ga)]
    idx_all, lc_all, pg_all, steps = [], [], [], []
    for idx, l, og, ga in _tier_classes(nz, *host, a.nt):
        n_pad = -(-len(idx) // splane) * splane
        idx, l, pg = _pad_tier_class(idx, l, og, ga, n_pad)
        idx_all.append(idx)
        lc_all.append(l)
        pg_all.append(pg)
        steps.append(n_pad // splane)
    idx = torch.from_numpy(np.concatenate(idx_all)).to(a.device)
    values = torch.zeros((idx.shape[0], 8, 8, 128), dtype=a.values.dtype,
                         device=a.device)
    real = idx >= 0
    values[real] = a.values[idx[real]]
    return WBellTierPlan(
        values=values,
        lc=torch.from_numpy(np.concatenate(lc_all)).to(a.device),
        packed=torch.from_numpy(np.concatenate(pg_all)).to(a.device),
        origin=idx.to(torch.int32), steps=tuple(steps), splane=splane,
        nt=a.nt, rows=a.rows)


def wbell_tiered_raw(packed: torch.Tensor, lc: torch.Tensor,
                     values: torch.Tensor, x: torch.Tensor, *, steps,
                     splane: int,
                     rows: Optional[WBellRows] = None) -> torch.Tensor:
    """K8 on raw class-major plane arrays: ``x`` ``(nrhs, nt, 8, 128)`` →
    the same shape, through their row layout ``rows``
    (:attr:`WBellTierPlan.rows`), built here when None from the planes in
    their stored (class-major) order."""
    global wbell_tiered_launches
    if values.shape[0] != sum(steps) * splane:
        raise ValueError(f"tier plan: {values.shape[0]} planes for steps "
                         f"{tuple(steps)} of {splane}")
    if rows is None:
        keep = values.reshape(values.shape[0], -1).ne(0).any(1)
        walk = group_walk((packed.long() >> 16) & 0xFFFF, keep, x.shape[1])
        rows = tiered_rows(packed, lc, values, walk, x.shape[1])
    if not _on_device(x, "wbell_tiered_raw"):
        return rows_product(rows, x)
    y = _launch_rows(rows, x, "wbell_tiered_raw")
    wbell_tiered_launches += 1
    return y


def wbell_spmm_tiered(plan: WBellTierPlan, x: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` through K8; ``x`` batched internal ``(nrhs, nt, 8,
    128)``.  Equal to :func:`wbell_spmm` bit for bit."""
    if x.dim() != 4 or x.shape[1] != plan.nt \
            or tuple(x.shape[2:]) != (8, 128):
        raise ValueError(f"tier kernel: expected (nrhs, {plan.nt}, 8, 128), "
                         f"got {tuple(x.shape)}")
    return wbell_tiered_raw(plan.packed, plan.lc, plan.values,
                            x.to(plan.vector_dtype).contiguous(),
                            steps=plan.steps, splane=plan.splane,
                            rows=plan.rows)

"""P3: the 4×8 half-block WBELL SpMV (experiments/halfblock_proto.py).

The prototype packs 4-row half-blocks instead of 8×8 blocks into
``(P, 4, 8, 128)`` planes in WBELL's RCM and count-balanced order
(:func:`build_halfblock`, host numpy as the reference): per lane, a plane
holds the top or the bottom half of the lane's 8-row block row, named by
bit 14 of ``lc`` (bits 0–13: the window offset, group·128 + lane).  Fewer
stored zeros, more planes.  The prototype sums each plane's 4×8 product
from 0 on its own, then adds it to the row's sum.

On the card the planes become a *segmented* row layout (:func:`half_rows`,
built once from the planes on their device): sliced ELL over the internal
rows (row ``og·1024 + (4·half + i)·128 + l``, column ``(ga + off >>
7)·1024 + j·128 + (off & 127)``), each row's nonzeros in walk order, and
each entry that continues the previous entry's (row, plane) segment
flagged in a word of flags beside it.  :func:`half_spmv` launches K7's
row kernel in its segmented form (``cgx_wbell_rows`` in
``cgx_torch/csrc/wbell.cu``), which sums each segment from 0 and adds it to
the row's sum at the next unflagged entry and at the row's end: the
prototype's rounding, so it equals its plain version
:func:`half_reference` (the plane walk) bit for bit on finite x.
``half_spmv_launches`` counts launches.  The plane-walking kernel it
replaces stays as ``_planes_p3`` (CUDA only, counted nowhere), the smoke's
same-run "before".

The reference packs with ``span`` 16, checks with the matrix's own span and
times with a literal 16; here the caller passes the span the build used,
and :func:`half_walk` checks every offset against it.

Run on the card: ``python3 -m cgx_torch.experiments.halfblock_proto
[name] [scale]`` (defaults ``thermal2 1.0``).  Besides the product, it
times the layout over 16-bit columns and flag words against the same
layout over int32 columns.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from cgx_torch.kernels import wbell as kw
from cgx_torch.sparse.types import resolve_device
from cgx_torch.sparse.wbell import (_balance_blocks, _rcm, _scipy_csr,
                                    group_walk, rows_from_entries)

__all__ = ["build_halfblock", "half_walk", "half_rows", "half_spmv",
           "half_reference", "half_spmv_launches", "main"]

half_spmv_launches = 0


def build_halfblock(a_sp, span: int = 16, *, device="cuda"):
    """Pack 4×8 half-blocks of ``a_sp`` (scipy or a port CSR) in WBELL's
    RCM + balance order.  Returns the reference's six outputs: ``values``
    ``(P, 4, 8, 128)`` float32, ``lc`` ``(P, 1, 128)`` int32, ``p_og`` and
    ``p_ga`` ``(P,)`` int32 (on ``device``), the fill (stored over real
    values) and the number of real planes; planes padded to a multiple of
    64."""
    dev = resolve_device(device)
    a_sp = _scipy_csr(a_sp)
    n = a_sp.shape[0]
    perm = _balance_blocks(a_sp, _rcm(a_sp), 1024)
    ap = a_sp[perm][:, perm].tocoo()
    row = ap.row.astype(np.int64)
    col = ap.col.astype(np.int64)
    val = ap.data.astype(np.float32)
    nbr = -(-n // 8)

    # Unique (half-block row, block column) pairs, sorted.
    uid, inv = np.unique((row >> 2) * nbr + (col >> 3), return_inverse=True)
    hb_r, hb_c = uid // nbr, uid % nbr
    pb = hb_r >> 1                      # the parent 8-row block row
    half = hb_r & 1
    lane = pb & 127
    tile = pb >> 7
    bucket = (hb_c >> 7) // span
    nblocks = len(uid)

    # Rank within (parent block row, bucket): each half-block of a lane
    # takes its own slot, ordered by block column, then half.
    order = np.lexsort((half, hb_c, bucket, pb))
    pbo, bko = pb[order], bucket[order]
    chg = np.empty(nblocks, bool)
    chg[0] = True
    chg[1:] = (pbo[1:] != pbo[:-1]) | (bko[1:] != bko[:-1])
    gstart = np.flatnonzero(chg)
    rank = np.empty(nblocks, np.int64)
    rank[order] = np.arange(nblocks) - gstart[np.cumsum(chg) - 1]

    # Planes per (tile, bucket), in that order.
    nb = int(bucket.max()) + 1
    tb_uid, tb_inv = np.unique(tile * nb + bucket, return_inverse=True)
    wbt_tb = np.zeros(len(tb_uid), np.int64)
    np.maximum.at(wbt_tb, tb_inv, rank + 1)
    pstart_tb = np.concatenate([[0], np.cumsum(wbt_tb[:-1])])
    p_real = int(wbt_tb.sum())
    plane = pstart_tb[tb_inv] + rank

    values = np.zeros((p_real, 4, 8, 128), np.float32)
    lcp = np.zeros((p_real, 1, 128), np.int32)
    np.add.at(values, (plane[inv], row & 3, col & 7, lane[inv]), val)
    lcp[plane, 0, lane] = ((hb_c & 127) + 128 * ((hb_c >> 7) - bucket * span)
                           + 16384 * half).astype(np.int32)
    p_og = np.repeat(tb_uid // nb, wbt_tb)
    p_ga = np.repeat((tb_uid % nb) * span, wbt_tb)
    pad = (-p_real) % 64
    if pad:
        values = np.concatenate([values,
                                 np.zeros((pad, 4, 8, 128), np.float32)])
        lcp = np.concatenate([lcp, np.zeros((pad, 1, 128), np.int32)])
        p_og = np.concatenate([p_og, np.zeros(pad, np.int64)])
        p_ga = np.concatenate([p_ga, np.zeros(pad, np.int64)])
    fill = values.size / max(len(val), 1)
    return (torch.from_numpy(values).to(dev), torch.from_numpy(lcp).to(dev),
            torch.from_numpy(p_og.astype(np.int32)).to(dev),
            torch.from_numpy(p_ga.astype(np.int32)).to(dev), fill, p_real)


def half_walk(packed: torch.Tensor, lc: torch.Tensor, values: torch.Tensor,
              nt: int, span: int):
    """Each output group's non-zero half-block planes in stored order, the
    ``(order, ptr)`` that :func:`half_spmv` walks.  Raises if a lane's
    window offset reaches past ``span`` groups."""
    if int(((lc & 0x3FFF) >> 7).max()) >= span:
        raise ValueError(f"half-block planes reach past span {span}: pass "
                         "the span the build used")
    keep = values.reshape(values.shape[0], -1).ne(0).any(1)
    return group_walk((packed.long() >> 16) & 0xFFFF, keep, nt)


def half_rows(packed: torch.Tensor, lc: torch.Tensor, values: torch.Tensor,
              nt: int, walk):
    """P3's segmented row layout (:class:`~cgx_torch.sparse.wbell.WBellRows`)
    of the half-block planes in ``walk`` (:func:`half_walk`'s), built with
    torch ops on their device; a segment is one row's entries of one
    plane, in j order."""
    order = walk[0].long()
    # Entries in walk order: nonzero() is lexicographic in (step, i, j, l).
    s, i, j, l = torch.nonzero(values.ne(0)[order]).unbind(1)
    p = order[s]
    raw = lc[p, 0, l].long()
    off = raw & 0x3FFF
    pg = packed.long()[p]
    row = (((pg >> 16) & 0xFFFF) << 10) + ((4 * ((raw >> 14) & 1) + i) << 7) \
        + l
    col = (((pg & 0xFFFF) + (off >> 7)) << 10) + (j << 7) + (off & 127)
    return rows_from_entries(row, col, values[p, i, j, l], nt, step=s)


def _half_plain(packed, lc, values, x, walk):
    """Plain ``Y[c, og] += (Σ_j v[p, :, j, l] · X[c, ga + off // 128, j,
    off % 128])`` on the rows of the lane's half, per plane in walk order,
    the plane's 4×8 product summed from 0 first, every operation rounded
    on its own.  Runs in rounds, as :func:`kw.walk_product`."""
    nrhs, nt = x.shape[0], x.shape[1]
    y = torch.zeros((nrhs, nt, 8, 128), dtype=x.dtype, device=x.device)
    order = walk[0].long()
    if order.numel() == 0:
        return y
    pg = packed.long()[order]
    og, ga = (pg >> 16) & 0xFFFF, pg & 0xFFFF
    rank = (torch.arange(og.numel(), device=og.device)
            - torch.searchsorted(og, og))
    by_rank = torch.argsort(rank, stable=True)
    for sel in torch.split(by_rank, torch.bincount(rank).tolist()):
        p, g = order[sel], og[sel]
        raw = lc[p, 0].long()                          # (s, 128)
        off = raw & 0x3FFF
        top = ((raw >> 14) & 1).eq(0)[None, :, None, :]
        grp = ga[sel, None] + (off >> 7)
        xg = x[:, grp, :, off & 127].permute(2, 0, 3, 1)  # (nrhs, s, 8, 128)
        v = values[p].to(x.dtype)                      # (s, 4, 8, 128)
        c = torch.zeros((nrhs, p.numel(), 4, 128), dtype=x.dtype,
                        device=x.device)
        for j in range(8):
            c = c + v[:, :, j, :] * xg[:, :, j, None, :]
        acc = y[:, g]
        zero = torch.zeros_like(c)
        y[:, g] = torch.cat([acc[:, :, :4] + torch.where(top, c, zero),
                             acc[:, :, 4:] + torch.where(top, zero, c)], 2)
    return y


def _check(values, x, splane):
    if values.dim() != 4 or tuple(values.shape[1:]) != (4, 8, 128) \
            or values.shape[0] % splane:
        raise ValueError(f"half_spmv: values must be (P, 4, 8, 128) with P "
                         f"a multiple of {splane}, got "
                         f"{tuple(values.shape)}")
    if x.dim() != 4 or tuple(x.shape[2:]) != (8, 128):
        raise ValueError(f"half_spmv: expected (nrhs, nt, 8, 128), got "
                         f"{tuple(x.shape)}")
    if x.shape[1] >= 1 << 16:
        raise ValueError(f"half_spmv: og/ga are packed in 16 bits: nt="
                         f"{x.shape[1]} must be < 65536")


def half_reference(packed, lc, values, x, *, span: int, splane: int,
                   walk=None) -> torch.Tensor:
    """P3's plain version on any device: the plane walk."""
    _check(values, x, splane)
    if walk is None:
        walk = half_walk(packed, lc, values, x.shape[1], span)
    return _half_plain(packed, lc, values, x, walk)


def half_spmv(packed: torch.Tensor, lc: torch.Tensor, values: torch.Tensor,
              x: torch.Tensor, *, span: int, splane: int,
              rows=None) -> torch.Tensor:
    """``y = A @ x`` over :func:`build_halfblock`'s planes, ``packed`` =
    ``p_og << 16 | p_ga``; ``x`` ``(nrhs, nt, 8, 128)`` float32 in the 8×8
    build's internal layout (the same permutation), ``nrhs`` 1 for the
    prototype's SpMV.  ``rows`` is :func:`half_rows`' layout (built here
    when None).  A CUDA ``x`` launches the row kernel; a CPU one takes the
    layout's plain version."""
    global half_spmv_launches
    _check(values, x, splane)
    if rows is None:
        rows = half_rows(packed, lc, values, x.shape[1],
                         half_walk(packed, lc, values, x.shape[1], span))
    if not kw._on_device(x, "half_spmv"):
        return kw.rows_product(rows, x)
    y = kw._launch_rows(rows, x.contiguous(), "half_spmv")
    half_spmv_launches += 1
    return y


def _planes_p3(packed, lc, values, x, walk):
    """The half-block plane walk :func:`half_spmv` replaces (its same-run
    "before"); CUDA only, counted nowhere."""
    return kw._launch("cgx_wbell_half", "plane walk", values, lc,
                      x.contiguous(), walk[0], walk[1], packed)


def main(name: str = "thermal2", scale: float = 1.0) -> None:
    """Build the half-block planes of ``name``'s stand-in (or the real
    matrix), hold :func:`half_spmv` against its plain version and the plane
    walk (bit for bit) and the fp64 CSR product (1e-5 of the peak), and
    time it beside the 8×8 K7 and the plane walk."""
    import scipy.sparse as sp

    from cgx_torch.experiments import interleaved_ms, require_card
    from cgx_torch.io.suitesparse import load_or_standin
    from cgx_torch.sparse.wbell import wbell_from_csr

    dev, card = require_card()
    a, _ = load_or_standin(name, scale=scale, device="cpu")
    a_sp = sp.csr_matrix((a.values.numpy().astype(np.float64),
                          a.col_indices.numpy(), a.indptr.numpy()),
                         shape=a.shape)
    n = a_sp.shape[0]
    wb = wbell_from_csr(a_sp, device=dev)
    span = 16
    t0 = time.perf_counter()
    v4, lc4, og4, ga4, fill4, p4 = build_halfblock(a_sp, span, device=dev)
    t_build = time.perf_counter() - t0
    planes8 = int(wb.values.reshape(wb.values.shape[0], -1).ne(0).any(1)
                  .sum())
    print(f"[{card}] {name}: 4x8 build {t_build:.1f} s (host), fill "
          f"{fill4:.2f}x, planes {p4} (8x8: fill "
          f"{wb.nnz_stored / wb.nnz:.2f}x, planes {planes8})")
    packed4 = (og4 << 16) | ga4
    splane = 64
    walk = half_walk(packed4, lc4, v4, wb.nt, span)
    rows = half_rows(packed4, lc4, v4, wb.nt, walk)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    xi = wb.to_internal(torch.from_numpy(x).to(dev))[None]
    y4 = half_spmv(packed4, lc4, v4, xi, span=span, splane=splane, rows=rows)
    y_plain = half_reference(packed4, lc4, v4, xi, span=span, splane=splane,
                             walk=walk)
    truth = a_sp @ x.astype(np.float64)
    y4s = wb.from_internal(y4[0]).double().cpu().numpy()
    err = float(np.abs(y4s - truth).max() / (np.abs(truth).max() + 1e-30))
    same = torch.equal(y4, y_plain)
    same_planes = torch.equal(y4, _planes_p3(packed4, lc4, v4, xi, walk))
    print(f"[{card}] 4x8 correctness max rel-to-peak err {err:.2e}; bitwise "
          f"equal to the plain version: {same}, to the plane walk: "
          f"{same_planes}")
    if not same or not same_planes or err > 1e-5:
        sys.exit(1)
    ms = interleaved_ms({
        "K7": lambda: kw.wbell_spmv(wb, xi[0]),
        "P3": lambda: half_spmv(packed4, lc4, v4, xi, span=span,
                                splane=splane, rows=rows),
        "planes": lambda: _planes_p3(packed4, lc4, v4, xi, walk)})
    plain = interleaved_ms({"plain": lambda: half_reference(
        packed4, lc4, v4, xi, span=span, splane=splane, walk=walk)},
        reps=3, inner=1)["plain"]
    print(f"[{card}] 8x8 K7: {ms['K7']:.4f} ms/SpMV; 4x8 half-block: "
          f"{ms['P3']:.4f} ms/SpMV ({ms['K7'] / ms['P3']:.2f}x of K7's speed; "
          f"layout bytes {rows.nbytes / 1e6:.1f} MB, K7's "
          f"{wb.rows.nbytes / 1e6:.1f}); the plane walk {ms['planes']:.4f} "
          f"ms; plain {plain:.4f} ms")
    # The flags' encoding: words of their own beside 16-bit columns, against
    # int32 columns (where a flag in bit 31 would go), the same layout built
    # with the 16-bit window limit at 0.
    from cgx_torch.sparse import wbell as sparse_wbell
    limit = sparse_wbell.ROW_OFFSET_LIMIT
    sparse_wbell.ROW_OFFSET_LIMIT = 0
    try:
        rows32 = half_rows(packed4, lc4, v4, wb.nt, walk)
    finally:
        sparse_wbell.ROW_OFFSET_LIMIT = limit
    y32 = half_spmv(packed4, lc4, v4, xi, span=span, splane=splane,
                    rows=rows32)
    if not torch.equal(y32, y4):
        print("P3 over int32 columns differs", file=sys.stderr)
        sys.exit(1)
    enc = interleaved_ms({
        name: (lambda r=r: half_spmv(packed4, lc4, v4, xi, span=span,
                                     splane=splane, rows=r))
        for name, r in (("16-bit", rows), ("int32", rows32))})
    print(f"[{card}] 4x8 half-block over 16-bit columns and flag words: "
          f"{enc['16-bit']:.4f} ms/SpMV, {rows.nbytes / 1e6:.1f} MB; over "
          f"int32 columns: {enc['int32']:.4f} ms/SpMV, "
          f"{rows32.nbytes / 1e6:.1f} MB (equal bit for bit)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "thermal2",
         float(sys.argv[2]) if len(sys.argv) > 2 else 1.0)

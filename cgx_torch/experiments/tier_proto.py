"""P1: the single-call width-tiered WBELL SpMM (experiments/tier_proto.py).

The prototype sorts a :class:`~cgx_torch.sparse.wbell.WBELLMatrix`'s
planes into classes of actual window width {≤4, ≤8, ≤16} with tight
per-plane windows (:func:`build_tiers`, host numpy as the reference) and
runs the three class segments in one call.  Its Pallas body is K8's
(``cgx/kernels/wbell.py:275-318``) line for line; the two differ only in
how the segments are unrolled and in ``build_tiers``.  On the card the
classes' planes (17.5× the nonzeros at thermal2 scale) become a row layout
(:func:`tier_rows`: sliced ELL over the internal rows, built once from the
planes on their device), and :func:`tier_spmm` launches K7's row kernel
(``cgx_wbell_rows`` in ``cgx_torch/csrc/wbell.cu``) over it, as K8 does
over its plan's.  Each row keeps its entries in the prototype's
class-major walk (each group's planes in stored order, then j), so the
product equals the plane walk in that order (:func:`tier_spmm_reference`)
bit for bit on finite x, and K7 (plane order) up to fp32 summation order.
``tier_spmm_launches`` counts its launches.  The plane walk it replaces
stays as ``_planes_p1`` (CUDA only, counted nowhere), the smoke's
same-run "before".

Unlike the JAX package's :func:`build_tier_plan`, the prototype's
``build_tiers`` does not clamp a window to ``nt``; the card reads each
lane's group directly (``ga + lc // 128``), so no window is read past its
end.

Run on the card: ``python3 -m cgx_torch.experiments.tier_proto [name]
[scale] [ks]`` (defaults ``thermal2 1.0 1,4``).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from cgx_torch.kernels import wbell as kw
from cgx_torch.sparse.wbell import group_walk

__all__ = ["build_tiers", "tier_walk", "tier_rows", "tier_spmm",
           "tier_spmm_reference", "tier_spmm_launches", "main"]

tier_spmm_launches = 0
_CLASSES = (4, 8, 16)


def build_tiers(wb, splane: int):
    """Reorder ``wb``'s planes into width classes with tight per-plane
    windows (host numpy, as the prototype's ``build_tiers``): returns
    ``(values, lc, packed, steps)`` on ``wb``'s device, the classes
    concatenated {4, 8, 16}, each padded with zero planes (``og = ga =
    0``) to a multiple of ``splane``; ``packed`` is ``og << 16 | ga``,
    ``steps`` the planes of each class over ``splane``."""
    if wb.nt >= 1 << 16:
        raise ValueError(f"build_tiers packs og/ga in 16 bits: nt={wb.nt} "
                         "must be < 65536")
    lc = wb.lc.cpu().numpy()
    p_ga = wb.p_ga.cpu().numpy()
    p_og = wb.p_og.cpu().numpy()
    nz = (wb.values.float().abs().sum(dim=(1, 2)) > 0).cpu().numpy()
    gloc = lc[:, 0, :] // 128
    gmin = np.where(nz, gloc, 10**6).min(axis=1)
    gmin = np.where(gmin == 10**6, 0, gmin)
    width = np.maximum(np.where(nz, gloc, -1).max(axis=1) - gmin + 1, 1)
    cls = np.where(width <= 4, 4, np.where(width <= 8, 8, 16))
    idx_all, out_l, out_pg, steps = [], [], [], []
    for w in _CLASSES:
        idx = np.flatnonzero(cls == w)
        pad = (-len(idx)) % splane
        l = lc[idx].copy()
        og = p_og[idx].astype(np.int64)
        ga = p_ga[idx].astype(np.int64) + gmin[idx]
        l[:, 0, :] = np.where(nz[idx], l[:, 0, :] - 128 * gmin[idx][:, None],
                              0)
        if len(idx) and (l[:, 0, :] // 128).max() >= w:
            raise ValueError(f"tier class {w}: a window is wider than its "
                             f"class (span {wb.span} > 16?)")
        idx_all.append(np.concatenate([idx, np.full(pad, -1, np.int64)]))
        out_l.append(np.concatenate([l, np.zeros((pad, 1, 128), np.int32)]))
        out_pg.append(np.concatenate([
            (og.astype(np.int32) << 16) | ga.astype(np.int32),
            np.zeros(pad, np.int32)]))
        steps.append((len(idx) + pad) // splane)
    idx = torch.from_numpy(np.concatenate(idx_all)).to(wb.device)
    values = torch.zeros((idx.shape[0], 8, 8, 128), dtype=wb.values.dtype,
                         device=wb.device)
    real = idx >= 0
    values[real] = wb.values[idx[real]]
    return (values, torch.from_numpy(np.concatenate(out_l)).to(wb.device),
            torch.from_numpy(np.concatenate(out_pg)).to(wb.device),
            tuple(steps))


def tier_walk(packed: torch.Tensor, values: torch.Tensor, nt: int):
    """Each output group's non-zero planes in stored (class-major) order:
    the ``(order, ptr)`` that :func:`tier_spmm` walks."""
    keep = values.reshape(values.shape[0], -1).ne(0).any(1)
    return group_walk((packed.long() >> 16) & 0xFFFF, keep, nt)


def tier_rows(packed: torch.Tensor, lc: torch.Tensor, values: torch.Tensor,
              nt: int, walk=None):
    """P1's row layout (:class:`~cgx_torch.sparse.wbell.WBellRows`): the
    classes' planes in :func:`tier_walk`'s class-major order (``walk``,
    built here when None), built once on their device."""
    if walk is None:
        walk = tier_walk(packed, values, nt)
    return kw.tiered_rows(packed, lc, values, walk, nt)


def _check(values, x, steps, splane):
    if values.shape[0] != sum(steps) * splane:
        raise ValueError(f"tier_spmm: {values.shape[0]} planes for steps "
                         f"{tuple(steps)} of {splane}")
    if x.dim() != 4 or tuple(x.shape[2:]) != (8, 128):
        raise ValueError(f"tier_spmm: expected (nrhs, nt, 8, 128), got "
                         f"{tuple(x.shape)}")


def tier_spmm_reference(packed, lc, values, x, *, steps, splane, walk=None):
    """P1's plain version on any device: K8's plain walk in stored order."""
    _check(values, x, steps, splane)
    if walk is None:
        walk = tier_walk(packed, values, x.shape[1])
    return kw._tiered_plain(packed, lc, values, x, walk)


def tier_spmm(packed: torch.Tensor, lc: torch.Tensor, values: torch.Tensor,
              x: torch.Tensor, *, steps, splane: int,
              rows=None) -> torch.Tensor:
    """``Y = A @ X`` over :func:`build_tiers`' arrays; ``x`` ``(nrhs, nt, 8,
    128)`` float32.  ``rows`` is :func:`tier_rows`' layout (built here when
    None).  A CUDA ``x`` launches the row kernel; a CPU one takes the
    layout's plain version."""
    global tier_spmm_launches
    _check(values, x, steps, splane)
    if rows is None:
        rows = tier_rows(packed, lc, values, x.shape[1])
    if not kw._on_device(x, "tier_spmm"):
        return kw.rows_product(rows, x)
    y = kw._launch_rows(rows, x.contiguous(), "tier_spmm")
    tier_spmm_launches += 1
    return y


def _planes_p1(packed, lc, values, x, walk):
    """The plane walk :func:`tier_spmm` replaces, in stored order (its
    same-run "before"); CUDA only, counted nowhere."""
    return kw._launch("cgx_wbell_tiered", "plane walk", values, lc,
                      x.contiguous(), walk[0], walk[1], packed)


def main(name: str = "thermal2", scale: float = 1.0, ks=(1, 4)) -> None:
    """Build the tiers of ``name``'s stand-in (or the real matrix) on the
    card, hold :func:`tier_spmm` at each k in ``ks`` against its plain
    version and the plane walk (bit for bit) and K7 (1e-5 of the peak), and
    time it beside K7, K8, the plane walk and the plain version."""
    from cgx_torch.experiments import interleaved_ms, require_card
    from cgx_torch.io.suitesparse import load_or_standin
    from cgx_torch.sparse.wbell import wbell_from_csr

    dev, card = require_card()
    a, _ = load_or_standin(name, scale=scale, device=dev)
    n = a.shape[0]
    wb = wbell_from_csr(a, device=dev)
    splane = 8
    t0 = time.perf_counter()
    v, l, pg, steps = build_tiers(wb, splane)
    walk = tier_walk(pg, v, wb.nt)
    rows = tier_rows(pg, l, v, wb.nt, walk)
    torch.cuda.synchronize()
    print(f"[{card}] {name} ({n} rows): tiers steps {steps} (x{splane} "
          f"planes), built in {time.perf_counter() - t0:.2f} s (host)")
    plan = kw.build_tier_plan(wb)
    rng = np.random.default_rng(0)
    for k in ks:
        x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
        xb = torch.stack([wb.to_internal(x[:, j].to(dev)) for j in range(k)])
        y_ref = kw.wbell_spmm(wb, xb)
        y_t = tier_spmm(pg, l, v, xb, steps=steps, splane=splane, rows=rows)
        y_p = tier_spmm_reference(pg, l, v, xb, steps=steps, splane=splane,
                                  walk=walk)
        err = float((y_t - y_ref).abs().max() / y_ref.abs().max())
        same = torch.equal(y_t, y_p)
        same_planes = torch.equal(y_t, _planes_p1(pg, l, v, xb, walk))
        print(f"[{card}] k={k}: tiers vs K7 max rel-to-peak diff {err:.2e}; "
              f"bitwise equal to the plain version: {same}, to the plane "
              f"walk: {same_planes}")
        if not same or not same_planes or err > 1e-5:
            sys.exit(1)
        ms = interleaved_ms({
            "K7": lambda: kw.wbell_spmm(wb, xb),
            "K8": lambda: kw.wbell_spmm_tiered(plan, xb),
            "P1": lambda: tier_spmm(pg, l, v, xb, steps=steps, splane=splane,
                                    rows=rows),
            "planes": lambda: _planes_p1(pg, l, v, xb, walk)})
        plain = interleaved_ms({"plain": lambda: tier_spmm_reference(
            pg, l, v, xb, steps=steps, splane=splane, walk=walk)},
            reps=3, inner=1)["plain"]
        print(f"[{card}] k={k}: tiered single call {ms['P1']:.4f} ms/SpMM = "
              f"{ms['P1'] / k:.4f} ms/RHS; K7 {ms['K7']:.4f}, K8 "
              f"{ms['K8']:.4f}, the plane walk {ms['planes']:.4f}, plain "
              f"{plain:.4f} ms/SpMM")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "thermal2",
         float(sys.argv[2]) if len(sys.argv) > 2 else 1.0,
         tuple(int(v) for v in (sys.argv[3].split(",")
                                if len(sys.argv) > 3 else ["1", "4"])))

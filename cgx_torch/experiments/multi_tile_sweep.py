"""K5's kernel A over march plans, beside the first kernel A.

At the multi-RHS cells of ``chip_smoke.py`` (DIA-27 160³ under Jacobi, 13
symmetric planes, and the 224³ 7-point stencil; k = 4 seeded columns),
kernel A's march (``multi_a2``) runs at each tile height in
:data:`TILE_LINES` (lines of 512 / tj nodes, two a thread) and each chunk
length in :data:`LENGTHS` (None: as many planes as fill the card's blocks
in one wave), and the first kernel A (``multi_a``, the same-run "before")
at its own grid.  Each plan's q is checked against the first
kernel A's bit for bit, then all are timed in turns (CUDA events around
ten calls each, launched with their arguments built once, medians of
interleaved repetitions).  Each line gives µs per call, the ratio to the
first kernel A, the grid and the shared memory a block; the default plan
(:func:`march_plan` on the card) is marked.  It is the measurement behind
``march_plan``'s defaults.

Run on the card from the repository root:
``python3 -m cgx_torch.experiments.multi_tile_sweep``.  Without a card it
exits with code 2.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TILE_LINES", "LENGTHS", "main"]

TILE_LINES = (8, 16, 32)
LENGTHS = (None, 8, 16, 32)
K = 4


def cells(dev):
    """``{label: engine}`` of the two multi-RHS cells (and DIA-27's bf16
    planes)."""
    import cgx_torch
    from cgx_torch.io.poisson import poisson3d_dia27
    from cgx_torch.kernels.fused_cg import stencil_taps
    from cgx_torch.kernels.fused_dia_cg import dia_prep
    from cgx_torch.kernels.fused_multi import FusedCGMulti

    d = poisson3d_dia27(160, 160, 160, variable=True, seed=0, device=dev)
    m = cgx_torch.JacobiPrecond.from_matrix(d)
    nx, ny, nz, taps, coeffs, planes, _, w, sym = dia_prep(
        d, torch.float32, inv_diag=m.inv_diag)
    out = {"DIA-27 160^3": FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs,
                                        planes=planes, weight=w, sym=sym),
           "DIA-27 160^3 bf16 planes": FusedCGMulti(
               nx, ny, nz, taps, coeffs=coeffs, planes=planes, weight=w,
               sym=sym, plane_dtype=torch.bfloat16)}
    del d, m, planes
    nx, ny, nz, taps, coeffs = stencil_taps(
        cgx_torch.poisson3d_stencil(224, 224, 224))
    out["stencil 224^3"] = FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs)
    return out


def main() -> None:
    """Print one block of lines per cell."""
    from cgx_torch.experiments import interleaved_ms, require_card
    from cgx_torch.kernels.fused_multi import (MARCH_BLOCKS_PER_SM,
                                               _FIRST_DESIGN, _MARCH,
                                               _kernel_a_launcher as launcher,
                                               march_plan)

    dev, card = require_card()
    blocks = MARCH_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count
    print(f"[{card}] K5 kernel A, k = {K}: us per call (CUDA events "
          f"around 10 calls, median of 5 interleaved repetitions)")
    for label, eng in cells(dev).items():
        p = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (K, eng.n)).astype(np.float32)).to(dev)
        default = march_plan(eng.nx, eng.ny, eng.nz, eng.taps, blocks=blocks)
        fns, grids, plans = {}, {}, {}
        run0, q0, g0 = launcher(eng, p, _FIRST_DESIGN)
        run0()
        fns["first kernel A"], grids["first kernel A"] = run0, g0
        wide = label.endswith("bf16 planes")
        for tj in (default.tj,) if wide else TILE_LINES:
            for length in (default.length,) if wide else LENGTHS:
                plan = march_plan(eng.nx, eng.ny, eng.nz, eng.taps, tj=tj,
                                  length=length, blocks=blocks)
                run, q, g = launcher(eng, p, _MARCH, plan)
                run()
                torch.cuda.synchronize()
                if not torch.equal(q, q0):
                    raise SystemExit(f"{label} tj={tj} len={length}: q "
                                     f"differs from the first kernel A")
                name = f"tj {tj} x tk {plan.tk}, len {plan.length}"
                if name in fns:
                    continue
                fns[name], grids[name], plans[name] = run, g, plan
        ms = interleaved_ms(fns, reps=5, inner=10)
        base = ms["first kernel A"]
        print(f"[{card}] {label}: first kernel A {base * 1e3:.2f} us "
              f"(grid {g0})")
        for name, u in ms.items():
            if name == "first kernel A":
                continue
            mark = " (default)" if plans[name] == default else ""
            print(f"[{card}]     {name}: {u * 1e3:.2f} us ({u / base:.3f}; "
                  f"grid {grids[name]}, {plans[name].smem_bytes} B shared)"
                  f"{mark}")
        del eng, p, q0, fns


if __name__ == "__main__":
    main()

"""K2's constant mode over grids and sizes, beside the three-phase kernel.

For the 7-point Poisson stencil at each size in :data:`SIZES` (b = ones,
tol 1e-6), the two-phase kernel runs at each grid of :data:`BLOCKS_PER_SM`
blocks an SM that fits, and the three-phase kernel it replaced (the
same-run "before") at its own full grid, their solves interleaved.  Each
line gives µs per iteration, the ratio to the three-phase kernel and the
iterations (the sums, so the trajectory, depend on the grid).  It is the
measurement behind ``fused_resident.default_grid``: where the five
vectors of the constant mode fit the card's L2, fewer blocks than fit
win.

Run on the card from the repository root:
``python3 -m cgx_torch.experiments.resident_grid_sweep``.  Without a card
it exits with code 2.
"""
from __future__ import annotations

import torch

__all__ = ["SIZES", "BLOCKS_PER_SM", "main"]

SIZES = (96, 128, 144, 160, 192)
BLOCKS_PER_SM = (3, 4, 5, 6)


def main() -> None:
    """Print one block of lines per size."""
    import cgx_torch
    from cgx_torch.experiments import interleaved_ms, require_card
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels.fused_cg import stencil_taps

    dev, card = require_card()
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    print(f"[{card}] L2 {props.L2_cache_size} B, {sms} SMs; us per "
          f"iteration (CUDA events, median of interleaved solves)")
    for side in SIZES:
        a = cgx_torch.poisson3d_stencil(side, side, side)
        n = a.shape[0]
        spec = stencil_taps(a)
        b = torch.ones(n, dtype=torch.float32, device=dev)
        full = k2.resident_grid(spec, dev)
        fns = {"three-phase": lambda: k2._three_phase_call(
            spec, b, tol=1e-6, maxiter=n)}
        for per_sm in BLOCKS_PER_SM:
            if per_sm * sms <= full:
                fns[per_sm * sms] = (lambda g=per_sm * sms:
                                     k2.resident_cg_call(spec, b, tol=1e-6,
                                                         maxiter=n, grid=g))
        its = {name: int(fn()[3]) for name, fn in fns.items()}
        ms = interleaved_ms(fns, reps=9, inner=1)
        base = ms["three-phase"] / its["three-phase"]
        default = k2.default_grid(full, n, sms, props.L2_cache_size, False)
        print(f"[{card}] {side}^3 (five vectors {20 * n / 1e6:.1f} MB; "
              f"default grid {default} of {full}): three-phase "
              f"{base * 1e3:.2f} us/iter ({its['three-phase']} it)")
        for name, t in ms.items():
            if name != "three-phase":
                u = t / its[name]
                print(f"[{card}]     grid {name}: {u * 1e3:.2f} us/iter "
                      f"({u / base:.3f}; {its[name]} it)")


if __name__ == "__main__":
    main()

"""K11's tiled path against its general path over fp32 block sizes and k.

For each ``bs`` in :data:`BLOCKS` and ``k`` in :data:`COLUMNS`, a random
block-ELL operator of ``2**21 // bs**2`` block rows and :data:`WB` slots
(about 64 MB of values) is multiplied through the tiled path and the
general path, each forced through its plan, their times interleaved.  The
two are checked equal bit for bit.  Each line gives the plan's path for
the shape and both times; ``bell_plan`` leaves the shapes whose tiled
block has fewer than 5 threads to the general path, which this sweep
shows to be faster there.

Run on the card from the repository root:
``python3 -m cgx_torch.experiments.bell_sweep``.  Without a card it exits
with code 2.
"""
from __future__ import annotations

import sys

import torch

from cgx_torch.kernels import bsr as kb

__all__ = ["BLOCKS", "COLUMNS", "WB", "main"]

BLOCKS = (8, 16, 24, 32, 48, 64, 128)
COLUMNS = (16, 32, 64, 128, 256, 512)
WB = 8


def _operator(bs: int, k: int, dev, seed: int):
    nbr = max(2 ** 21 // (bs * bs), 64)
    g = torch.Generator(device=dev).manual_seed(seed)
    values = torch.randn((nbr, WB, bs, bs), device=dev, generator=g)
    cols = torch.randint(0, nbr, (nbr, WB), device=dev, generator=g,
                         dtype=torch.int32).sort(dim=1).values
    a = kb.BlockELL(values=values, block_cols=cols,
                    shape=(nbr * bs, nbr * bs))
    return a, torch.randn((nbr * bs, k), device=dev, generator=g)


def main() -> None:
    """Print one line per (bs, k); exit 1 if the paths ever differ."""
    from cgx_torch.experiments import interleaved_ms, require_card

    dev, card = require_card()
    print(f"[{card}] fp32, wb {WB}; us per call (CUDA events, median)")
    same_everywhere = True
    for bs in BLOCKS:
        for k in COLUMNS:
            a, x = _operator(bs, k, dev, 1000 * bs + k)
            plans = {p: kb.bell_plan(bs, k, torch.float32, True, path=p)
                     for p in ("tiled", "general")}
            ms = interleaved_ms({p: (lambda q=q: kb._k11(a, x, q))
                                 for p, q in plans.items()}, inner=10)
            same = torch.equal(kb._k11(a, x, plans["tiled"]),
                               kb._k11(a, x, plans["general"]))
            same_everywhere &= same
            chosen = kb.bell_plan(bs, k, torch.float32, True)
            print(f"[{card}] bs {bs:3d} k {k:3d} ({a.values.shape[0]} block "
                  f"rows): plan {chosen.path:7s}; tiled "
                  f"{ms['tiled'] * 1e3:8.1f} us ({plans['tiled'].threads} "
                  f"threads), general {ms['general'] * 1e3:8.1f} us, "
                  f"general/tiled {ms['general'] / ms['tiled']:.2f}; equal "
                  f"{same}", flush=True)
            del a, x
    if not same_everywhere:
        sys.exit(1)


if __name__ == "__main__":
    main()

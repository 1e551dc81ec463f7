"""The prototypes P1–P3: counterparts of the JAX package's ``experiments/``.

Each module holds one prototype kernel's entry point, its plain PyTorch
version and a ``main()`` that runs it on the card against the kernel it
was measured against:

* :mod:`~cgx_torch.experiments.tier_proto` (P1): the single-call
  width-tiered WBELL SpMM, through K8's CUDA kernel;
* :mod:`~cgx_torch.experiments.bell_pair_proto` (P2): the paired-slot
  block-ELL SpMM (``csrc/bsr.cu``);
* :mod:`~cgx_torch.experiments.halfblock_proto` (P3): the 4×8 half-block
  WBELL SpMV (``csrc/wbell.cu``).

:mod:`~cgx_torch.experiments.bell_sweep` is no prototype: it times K11's
tiled path against its general path over fp32 block sizes and ``k``, the
measurement behind ``bell_plan``'s rule for small blocks;
:mod:`~cgx_torch.experiments.resident_grid_sweep` times K2's constant mode
over grids and sizes beside the three-phase kernel, the measurement
behind ``fused_resident.default_grid``;
:mod:`~cgx_torch.experiments.multi_tile_sweep` times K5 A's march over
tile heights and chunk lengths beside its first kernel A, the
measurement behind ``fused_multi.march_plan``'s defaults.

Run one on the card from the repository root, for example
``python3 -m cgx_torch.experiments.tier_proto thermal2 1.0 1,4``.  A
``main()`` exits non-zero without a card: the timings have no CPU mode.
The entry points take CPU tensors through their plain versions.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

import torch

__all__ = ["require_card", "interleaved_ms"]


def require_card():
    """``(device, card)`` of CUDA card 0, with ``card`` the card's name and
    power limit as ``nvidia-smi`` reports them; exits with code 2 when
    there is no card."""
    if not torch.cuda.is_available():
        print("needs a CUDA card: the prototype's timings have no CPU mode",
              file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        print(f"nvidia-smi failed: {proc.stderr.strip()}", file=sys.stderr)
        sys.exit(1)
    return dev, proc.stdout.strip().splitlines()[0]


def interleaved_ms(fns: dict, reps: int = 5, inner: int = 10) -> dict:
    """Median ms per call of each function in ``fns`` (name -> callable),
    by CUDA events over ``inner`` calls, the order reversed on every other
    repetition (a, b, c, c, b, a, ...)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / inner)
    return {name: statistics.median(v) for name, v in times.items()}

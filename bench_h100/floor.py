"""The least time a CG iteration can take on the card, from what the
iteration needs, whatever implements it.

A CG iteration (preconditioned or not) over k right-hand sides reads and
writes each of x, r and p once (6 vector streams a column) and reads the
operator's coefficients once, shared by the k columns, at their stored
precision: nothing for a constant stencil, the unique planes of a stored
operator (a symmetric one stores each ±offset pair once, and its diagonal,
from which the Jacobi scaling follows).  Neighbour reads, q, z and the
scaling vector are left out: a kernel may keep them on chip.  The operations
are two per stored entry of the product and twelve a row and column for the
dots, the updates and the preconditioner.  At these intensities (about one
operation a byte against the card's ridge of 20) the bytes bound the time.
"""
from __future__ import annotations

from typing import Optional

# Published peaks of one card, NVIDIA's H100 SXM data sheet (dense, no
# sparsity), at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def peak(device_name: str) -> Optional[dict]:
    """The card's peaks, or None for a card not in the table."""
    if device_name in PEAKS:
        return PEAKS[device_name]
    if "H100" in device_name and "HBM3" in device_name:
        return PEAKS["NVIDIA H100 80GB HBM3"]
    return None


def coefficient_planes(config: dict) -> int:
    """Unique coefficient planes a CG iteration reads."""
    if config["coefficients"] == "constant":
        return 0
    planes = int(config["planes"])
    return (planes + 1) // 2 if config.get("symmetric") else planes


def iteration_bytes(n: int, k: int, planes: int, itemsize: int = 4) -> int:
    """Bytes one iteration needs: 6 vector streams a column, the planes once."""
    return (6 * n * k + planes * n) * itemsize


def iteration_flops(n: int, k: int, taps: int) -> int:
    """Operations of one iteration: the product's two a stored entry, twelve
    a row for the dots, the updates and the preconditioner, each column."""
    return n * k * (2 * taps + 12)


def iteration_floor_s(config: dict, k: int, device_name: str) -> Optional[float]:
    """Seconds an iteration takes at the card's peak, the larger of bytes
    over bandwidth and operations over the fp32 rate; None for a card not in
    the table."""
    pk = peak(device_name)
    if pk is None:
        return None
    n = int(config["rows"])
    b = iteration_bytes(n, k, coefficient_planes(config))
    f = iteration_flops(n, k, int(config["taps"]))
    return max(b / pk["hbm_bytes_per_s"], f / pk["fp32_flops_per_s"])

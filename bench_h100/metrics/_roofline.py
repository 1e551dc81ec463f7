"""Shared by the ``*_roofline`` readers: a kernel's share of its floor.

The floor is :func:`bench_h100.floor.iteration_floor_s` (what a CG
iteration needs, over the card's published peaks) times the iterations of
the traced calls (the slowest column of a call: the multi-RHS engine runs
its columns for the shared count); the time is the device time of the
kernels that match ``patterns`` in the same calls.
"""
from bench_h100 import floor, trace


def share(ctx, patterns):
    if ctx.traced is None:
        return None
    kernel_s = trace.kernel_seconds(ctx.traced["reduced"]["device"], patterns)
    per_iter = floor.iteration_floor_s(ctx.config, ctx.columns,
                                       ctx.device_name)
    if kernel_s <= 0.0 or per_iter is None:
        return None
    iters = sum(max(c.iterations) for c in ctx.traced["calls"])
    return 100.0 * per_iter * iters / kernel_s

"""The 95th percentile of every call's wall time in the window, in ms."""
from bench_h100 import stats

LAYER, UNIT, BETTER, SOURCE, MOVES = ("end to end", "ms", "lower",
                                      "host_clock", "solve_p95_ms")


def read(ctx):
    return stats.percentile([c.wall_s * 1000.0 for c in ctx.calls], 95.0)

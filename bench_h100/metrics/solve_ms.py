"""Milliseconds a call: the window's seconds × 1000 over its calls."""
from bench_h100 import stats

LAYER, UNIT, BETTER, SOURCE, MOVES = ("end to end", "ms", "lower",
                                      "host_clock", "solve_ms")


def read(ctx):
    return stats.rate_ms(ctx.window_s, len(ctx.calls))

"""Share of a call's wall time in which nothing runs on the card: each pool
entry's mean wall time in the (untraced) window against the device's busy
time (kernels and copies, their union) in its traced call, over the pool.
The traced calls give only the device's time, which the profiler's own host
cost does not lengthen; the wall times are the window's."""
from bench_h100 import stats

LAYER, UNIT, BETTER, SOURCE, MOVES = ("device", "%", "lower",
                                      "device_trace", "solve_ms")


def read(ctx):
    if ctx.traced is None:
        return None
    calls = ctx.traced["calls"]
    busy = ctx.traced["reduced"]["busy_s"] / len(calls)
    return 100.0 * (1.0 - busy / stats.pool_wall_s(ctx.calls, calls))

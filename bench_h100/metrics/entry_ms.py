"""Milliseconds a call spends outside the engine's own kernels: each pool
entry's mean wall time in the window less the device time of the engine
kernels in its traced call, averaged over the pool.  It holds the route's
checks, the operator's preparation, the launches and the read-back."""
from bench_h100 import stats, trace

LAYER, UNIT, BETTER, SOURCE, MOVES = ("entry and operator prep", "ms",
                                      "lower", "device_trace", "solve_ms")

# The engines' kernels, by name: K2, K3 A and B, K5 A (either design) and B.
ENGINE_KERNELS = [r"\btwo_phase_kernel\b", r"\bkernel_a2\b", r"\bkernel_b2\b",
                  r"\bmulti_a2?\b", r"\bmulti_b\b"]


def read(ctx):
    if ctx.traced is None:
        return None
    calls = ctx.traced["calls"]
    engine_s = trace.kernel_seconds(ctx.traced["reduced"]["device"],
                                    ENGINE_KERNELS)
    if engine_s <= 0.0:
        return None
    wall = stats.pool_wall_s(ctx.calls, calls)
    return 1000.0 * (wall - engine_s / len(calls))

"""K5's (the multi-RHS engine's kernels A, either design, and B) share of
the iteration floor of its k columns."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("kernel", "%", "higher",
                                      "device_trace", "solve_ms")
KERNELS = [r"\bmulti_a2?\b", r"\bmulti_b\b"]


def read(ctx):
    from bench_h100.metrics._roofline import share

    return share(ctx, KERNELS)

"""K3's (the two-pass engine's kernels A and B) share of the iteration
floor."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("kernel", "%", "higher",
                                      "device_trace", "solve_ms.history")
KERNELS = [r"\bkernel_a2\b", r"\bkernel_b2\b"]


def read(ctx):
    from bench_h100.metrics._roofline import share

    return share(ctx, KERNELS)

"""K2's (the whole-solve kernel's) share of the iteration floor."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("kernel", "%", "higher",
                                      "device_trace", "solve_ms")
KERNELS = [r"\btwo_phase_kernel\b"]


def read(ctx):
    from bench_h100.metrics._roofline import share

    return share(ctx, KERNELS)

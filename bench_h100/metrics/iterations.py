"""CG iterations a call, the mean over its columns, averaged over the
window's calls (the program's ``CGResult.iterations``)."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("engine", "iter", "lower",
                                      "program_counter", "solve_ms")


def read(ctx):
    per_call = [sum(c.iterations) / len(c.iterations) for c in ctx.calls]
    return sum(per_call) / len(per_call)

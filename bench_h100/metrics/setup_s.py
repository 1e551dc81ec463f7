"""Seconds from the process's start to the first timed call."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("end to end", "s", "lower",
                                      "host_clock", "setup_s")


def read(ctx):
    return ctx.setup_s

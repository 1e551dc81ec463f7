"""Blocking reads of device state a call: the program's counter
``cgx_torch.utils.profiling.host_syncs`` (its ``cgx.sync`` spans, one a
``host_read``) of each traced call, averaged over the calls.  The engines
K3 and K5 read their exit flag once a chunk of launches."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("engine", "reads", "lower",
                                      "program_counter", "solve_ms")


def read(ctx):
    from bench_h100.metrics._spans import by_call
    from cgx_torch.utils import profiling

    got = by_call(ctx)
    if got is None:
        return None
    _, roots = got
    return sum(profiling.host_syncs(r) for r in roots) / len(roots)

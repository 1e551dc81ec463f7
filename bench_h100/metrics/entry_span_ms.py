"""Host milliseconds a call spends in the program's entry: its ``cgx.route``,
``cgx.prep`` and ``cgx.result`` spans directly under the call's
``cgx.solve`` (the route and its checks, the operator's preparation and the
engine's set-up, the packaging of the answer), summed a call and averaged
over the traced calls.  The engine's host loop (``cgx.engine``) is left
out."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("entry and operator prep", "ms",
                                      "lower", "program_span", "solve_ms")

PHASES = ("cgx.route", "cgx.prep", "cgx.result")


def read(ctx):
    from bench_h100.metrics._spans import by_call

    got = by_call(ctx)
    if got is None:
        return None
    sp, roots = got
    top = set(roots)
    ns = sum(s.end_ns - s.start_ns for s in sp
             if s.parent in top and s.name in PHASES)
    return ns * 1e-6 / len(roots)

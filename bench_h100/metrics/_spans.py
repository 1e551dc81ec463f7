"""Shared by the span readers: the program's spans of the traced calls.

The program records its spans (``cgx_torch.utils.profiling.spans()``) only
while a profiler session records, so in a run of this harness they are the
traced cycle's alone.  Each ``cgx.solve`` root is one call; a nested solve
is a child, not a root.
"""


def by_call(ctx):
    """``(spans, roots)``: the recorded spans and the index of each call's
    root, or None where the run was not traced, the program records no
    spans, or the roots are not one a traced call."""
    if ctx.traced is None:
        return None
    from cgx_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    sp = spans()
    roots = [i for i, s in enumerate(sp) if s.call == i]
    if not roots or len(roots) != len(ctx.traced["calls"]):
        return None
    return sp, roots

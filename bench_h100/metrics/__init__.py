"""One reader a metric (``metrics/<name>.py``).

Each module names its ``LAYER``, ``UNIT``, ``BETTER``, ``SOURCE`` and the
end-to-end metric it ``MOVES`` (itself, for an end-to-end metric), and
``read(ctx)`` returns the number, or None where the run holds nothing to
read.  ``ctx`` (built by :func:`bench_h100.harness.run_cell`) carries the
configuration, the traffic, the window's calls, the set-up time and, in a
traced run, the reduced trace.
"""

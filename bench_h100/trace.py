"""One profiler session over a few calls, and its reduction.

The session records CPU and CUDA activity (``torch.profiler``) around calls
that the harness wraps in ``record_function`` spans of its own: ``WINDOW``
around the traced calls, ``CALL`` around each ``auto_solve`` call (route,
preparation and engine) and ``READBACK`` around the reads of its result.
The Chrome trace is written under the temporary directory the process is
given, read back and deleted.  :func:`reduce` turns its events into the
device's busy time inside the window, the device operations by time, and
the idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

WINDOW = "bench.window"
CALL = "route+prep+engine"
READBACK = "readback"

# Event categories that occupy the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def session():
    """A profiler over CPU and CUDA activity (not yet started)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events(prof) -> list:
    """The complete events of a finished session, from its Chrome trace."""
    fd, path = tempfile.mkstemp(prefix="bench_h100_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def short_name(name: str) -> str:
    """A kernel's function name without its namespace and template
    arguments (``void cgx::(anonymous namespace)::kernel_a2<…>(…)`` →
    ``kernel_a2``)."""
    s = name.replace("(anonymous namespace)", "anon")
    s = re.sub(r"^void\s+", "", s)
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip() or name


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _outermost(spans):
    """The outermost of ``spans`` (``(start, end, name)``, nested or
    disjoint, as one thread's operations are): disjoint, sorted by start."""
    out = []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _at(outer, starts, t):
    """The name of the span of ``outer`` (from :func:`_outermost`, with
    ``starts`` its start times) that covers ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and outer[i][0] <= t <= outer[i][1]:
        return outer[i][2]
    return None


def reduce(evs: list, top: int = 10) -> dict:
    """The traced window's device time.

    Returns ``window_s`` (the ``WINDOW`` span), ``busy_s`` (the union of the
    device's kernels and copies inside it), ``kernel_s`` (the kernels'
    summed durations), ``device`` (each device event inside it as ``(name,
    seconds)``), ``device_ops`` (the ``top`` labels by time: a kernel's
    short name, after the torch operation that launched it where there is
    one) and ``idle_gaps`` (the ``top`` labels by idle time: the harness's
    span and the longest torch operation on the host during each gap).
    """
    win = [e for e in evs if e["name"] == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("bench_h100: the trace holds no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = {}
    host_ops, spans = [], []
    for e in evs:
        cat = e.get("cat")
        if cat == "cpu_op":
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                ops[ext] = e["name"]
            host_ops.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"]))
        elif cat == "user_annotation" and e["name"] in (CALL, READBACK):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"]))
    device, iv = [], []
    kernel_s = 0.0
    by_label = defaultdict(float)
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < w0 or s > w1:
            continue
        s, t = max(s, w0), min(s + d, w1)
        iv.append((s, t))
        device.append((e["name"], (t - s) * 1e-6))
        if e.get("cat") == "kernel":
            kernel_s += (t - s) * 1e-6
        label = short_name(e["name"]) if e.get("cat") == "kernel" else e["name"]
        op = ops.get(e.get("args", {}).get("External id"))
        if op is not None:
            label = f"{op}: {label}"
        by_label[label] += (t - s) * 1e-6
    busy = _merge(iv)
    spans, host_ops = _outermost(spans), _outermost(host_ops)
    span_at, op_at = [s[0] for s in spans], [o[0] for o in host_ops]
    gaps = defaultdict(float)
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = 0.5 * (prev + s)
            span = _at(spans, span_at, mid) or "between calls"
            op = _at(host_ops, op_at, mid)
            gaps[span if op is None else f"{span}: {op}"] += (s - prev) * 1e-6
        prev = max(prev, e)
    rank = (lambda d: sorted(([k, v] for k, v in d.items()),
                             key=lambda kv: -kv[1])[:top])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "kernel_s": kernel_s, "device": device,
            "device_ops": rank(by_label), "idle_gaps": rank(gaps)}


def kernel_seconds(device: list, patterns) -> float:
    """Summed seconds of the device events whose name matches any of
    ``patterns`` (regular expressions)."""
    rx = [re.compile(p) for p in patterns]
    return sum(d for name, d in device if any(r.search(name) for r in rx))

"""Tracing and profiling hooks (PyTorch).

Counterpart of :mod:`cgx.utils.profiling`.  The reference's only
instrumentation is whole-second wall clock around the solve
(``time(NULL)``, ``cg.c:71-75``).  Here:

* :func:`trace` — ``torch.profiler`` around a block, CPU and (when a card
  is there) CUDA activities, written as a Chrome trace (JSON) into
  ``log_dir``; view it in Perfetto or ``chrome://tracing``, or read it
  with :func:`trace_report` / :func:`overlap_report`;
* :func:`annotate` — a named region on that timeline (``record_function``);
* :func:`time_fresh` — the best time of a call over distinct inputs, taken
  between two card synchronisations, the inputs cycled so that none is
  warm in the L2 from the call before;
* :func:`solve_stats` — derived metrics of a solve (per-iteration time,
  nnz/s, effective bandwidth against an operator byte model).

The JAX package reads the TPU profiler's ``.xplane.pb``
(``cgx.utils.xplane``); the port reads the Chrome trace's JSON instead,
so it needs no protobuf parser.  On the card the profiler has read some
kernels low late in a long process (PERF.md §7): where a kernel's device
time matters, hold it against CUDA events.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Callable, Iterable, Optional

import torch

__all__ = ["trace", "time_fresh", "solve_stats", "annotate",
           "trace_report", "overlap_report"]

# Trace event categories that run on the device.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block: ``with trace('/tmp/tb'): solve(...)``.
    Writes ``trace_<n>.json`` (Chrome trace format) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        n = len(glob.glob(os.path.join(log_dir, "trace_*.json")))
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n}.json"))


def annotate(name: str):
    """A named region that shows on the trace's timeline."""
    return torch.profiler.record_function(name)


def time_fresh(fn: Callable, variants: Iterable, reps: int = 3) -> float:
    """Best time in seconds of ``fn(v)`` over ``reps`` calls, cycling the
    distinct inputs ``variants``; the card is synchronised before and
    after each call (host clock)."""
    variants = list(variants)
    cuda = torch.cuda.is_available()
    best = float("inf")
    for i in range(reps):
        v = variants[i % len(variants)]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(v)
        if cuda:
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _events(log_dir: str, device_only: bool):
    """The complete (``"ph": "X"``) events of every trace in ``log_dir``."""
    for path in sorted(glob.glob(os.path.join(log_dir, "*.json"))):
        with open(path) as f:
            doc = json.load(f)
        evs = doc["traceEvents"] if isinstance(doc, dict) else doc
        for e in evs:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", ""))
            if device_only and cat not in _DEVICE_CATS:
                continue
            yield e


def trace_report(log_dir: str, device_only: bool = True,
                 top: Optional[int] = 25) -> list:
    """Per-op timing table from the traces :func:`trace` wrote: event
    durations summed per (category, stream or thread, name).  Rows sorted
    by total time: ``{"plane", "line", "op", "count", "total_us",
    "avg_us"}``, with ``plane`` the event's category (``"kernel"`` for a
    device kernel) and ``line`` its stream or thread."""
    from collections import defaultdict

    acc = defaultdict(lambda: [0, 0.0])
    for e in _events(log_dir, device_only):
        k = (str(e.get("cat", "")), str(e.get("tid", "")), str(e["name"]))
        acc[k][0] += 1
        acc[k][1] += float(e["dur"])
    rows = [{"plane": p, "line": ln, "op": op, "count": n,
             "total_us": us, "avg_us": us / n}
            for (p, ln, op), (n, us) in acc.items()]
    rows.sort(key=lambda r: -r["total_us"])
    return rows[:top] if top else rows


def overlap_report(log_dir: str, a_keys=("memcpy", "memset", "copy"),
                   b_keys=("kernel", "cgx")) -> dict:
    """Concurrency between two families of device events: each event whose
    lowercased name or category contains a key of ``a_keys`` (else of
    ``b_keys``) joins that family; each family's intervals are merged, and
    ``overlap_frac`` is the share of family A's time under family B."""
    def merged(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    a_iv, b_iv = [], []
    for e in _events(log_dir, device_only=True):
        text = (str(e["name"]) + " " + str(e.get("cat", ""))).lower()
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if any(k in text for k in a_keys):
            a_iv.append(iv)
        elif any(k in text for k in b_keys):
            b_iv.append(iv)
    a_m, b_m = merged(a_iv), merged(b_iv)

    def total(iv):
        return sum(e - s for s, e in iv)

    inter = 0.0
    j = 0
    for s, e in a_m:
        while j < len(b_m) and b_m[j][1] <= s:
            j += 1
        k = j
        while k < len(b_m) and b_m[k][0] < e:
            inter += min(e, b_m[k][1]) - max(s, b_m[k][0])
            k += 1
    ta = total(a_m)
    return {"a_total_us": ta, "b_total_us": total(b_m), "overlap_us": inter,
            "overlap_frac": inter / ta if ta else 0.0,
            "a_events": len(a_iv), "b_events": len(b_iv)}


def solve_stats(seconds: float, iterations: int, nnz: int,
                bytes_per_iter: Optional[int] = None) -> dict:
    """Throughput summary for a converged solve."""
    it = max(int(iterations), 1)
    per_iter = seconds / it
    out = {
        "seconds": seconds,
        "iterations": int(iterations),
        "s_per_iter": per_iter,
        "gnnz_per_s": nnz / per_iter / 1e9,
    }
    if bytes_per_iter:
        out["effective_gb_per_s"] = bytes_per_iter / per_iter / 1e9
    return out

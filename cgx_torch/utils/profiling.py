"""Tracing and profiling hooks (PyTorch).

Counterpart of :mod:`cgx.utils.profiling`.  The reference's only
instrumentation is whole-second wall clock around the solve
(``time(NULL)``, ``cg.c:71-75``).  Here:

* :func:`trace` — ``torch.profiler`` around a block, CPU and (when a card
  is there) CUDA activities, written as a Chrome trace (JSON) into
  ``log_dir``; view it in Perfetto or ``chrome://tracing``, or read it
  with :func:`trace_report` / :func:`overlap_report`;
* :func:`annotate` — the program's span: a named region on that timeline
  (``record_function``) that is also kept in memory (:func:`spans`);
* :func:`host_read` — the program's one way to bring device state to the
  host, each read a ``cgx.sync`` span;
* :func:`time_fresh` — the best time of a call over distinct inputs, taken
  between two card synchronisations, the inputs cycled so that none is
  warm in the L2 from the call before;
* :func:`solve_stats` — derived metrics of a solve (per-iteration time,
  nnz/s, effective bandwidth against an operator byte model).

Spans.  While a ``torch.profiler`` session records (:func:`trace`, or any
``torch.profiler.profile(...)`` the caller opens), each span enters
``record_function``, so it lands in the session's Chrome trace on the
profiler's clock beside the kernels and copies it launched, and appends
``Span(name, start_ns, end_ns, parent, call)`` to an in-memory list
(host ``time.perf_counter_ns``; ``parent`` the index of the enclosing
span, ``call`` the index of the outermost ``cgx.solve`` span, shared by
every span of one solve).  With no session recording a span costs one
check and returns a shared null context: nothing is timed or kept.
:func:`spans` returns the list and :func:`clear_spans` empties it; the
program never writes it to disk.  Spans are kept for one thread.

The solve path's spans (a fixed set):

* ``cgx.solve`` — ``auto_solve``, the whole call; a nested one is a child;
* ``cgx.route`` — ``select_backend`` and ``cg_solve_multi``'s route, with
  the checks they run;
* ``cgx.check.wrap``, ``cgx.check.sym`` — each DIA check, wherever called;
* ``cgx.prep`` — everything between the route and the engine's first
  launch: the threshold, the engine's construction, state and history,
  grid queries, tap arrays (a call may have several segments), with
  ``dia_prep`` nested as ``cgx.prep.dia``;
* ``cgx.engine`` — the engine's host loop: K2's launch, K3's and K5's
  chunk loops, the loops' iterations;
* ``cgx.sync`` — each :func:`host_read`, mostly inside ``cgx.engine``;
* ``cgx.result`` — packaging the answer: K3's history padding, the DIA
  unscaling, the ``CGResult``.

``cgx.route``, ``cgx.prep``, ``cgx.engine`` and ``cgx.result`` are
siblings under ``cgx.solve``.  No span wraps a single kernel launch of a
loop.  The counter :func:`host_syncs` is the number of ``cgx.sync``
spans.  An operator's use::

    with profiling.trace("/tmp/tb"):
        auto_solve(a, b)

then open ``/tmp/tb/trace_0.json`` in Perfetto (ui.perfetto.dev): each
``cgx.*`` span sits on the host thread over the torch operations and
launches it made, and the device's kernels line up below it.

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
from typing import Callable, Iterable, NamedTuple, Optional

import torch

__all__ = ["trace", "time_fresh", "solve_stats", "annotate",
           "trace_report", "overlap_report", "host_read", "host_syncs",
           "spans", "clear_spans", "Span", "SPAN_NAMES"]

# The program's spans (the module note says where each is opened).
SOLVE = "cgx.solve"
ROUTE = "cgx.route"
CHECK_WRAP = "cgx.check.wrap"
CHECK_SYM = "cgx.check.sym"
PREP = "cgx.prep"
PREP_DIA = "cgx.prep.dia"
ENGINE = "cgx.engine"
SYNC = "cgx.sync"
RESULT = "cgx.result"
SPAN_NAMES = (SOLVE, ROUTE, CHECK_WRAP, CHECK_SYM, PREP, PREP_DIA, ENGINE,
              SYNC, RESULT)

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


class Span(NamedTuple):
    """One recorded span: host nanoseconds (``time.perf_counter_ns``),
    the index of the enclosing span and of the outermost ``cgx.solve``
    (None outside any)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    call: Optional[int]


_spans: list = []
_open: list = []        # indices of the spans entered and not yet left
_generation = 0         # bumped by clear_spans: spans open then are dropped
_recording = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class _Recorded:
    """A span while a session records: ``record_function`` and the list."""

    __slots__ = ("name", "_rf", "_i", "_gen")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # The profiler takes its start inside record_function's enter and
        # its end at the close of the exit: the span starts halfway
        # through the enter and ends after the exit, so that its length
        # agrees with the trace's.
        self._rf = torch.profiler.record_function(self.name)
        t0 = time.perf_counter_ns()
        self._rf.__enter__()
        start = (t0 + time.perf_counter_ns()) // 2
        parent = _open[-1] if _open else None
        call = None if parent is None else _spans[parent].call
        if call is None and self.name == SOLVE:
            call = len(_spans)
        self._i, self._gen = len(_spans), _generation
        _spans.append(Span(self.name, start, None, parent, call))
        _open.append(self._i)
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        if self._gen == _generation:
            _open.pop()
            _spans[self._i] = _spans[self._i]._replace(end_ns=end)
        return False


def annotate(name: str):
    """The program's span ``name``: recorded while a profiler session
    records, else a shared null context after one check."""
    if not _recording():
        return _NULL
    return _Recorded(name)


def host_read(t: torch.Tensor, read: Callable = torch.Tensor.tolist):
    """``read(t)`` (``int``, ``bool`` or ``tolist``) of a tensor the solve
    computed: a blocking read of device state, a ``cgx.sync`` span."""
    if not _recording():
        return read(t)
    with _Recorded(SYNC):
        return read(t)


def spans() -> list:
    """The recorded :class:`Span` list, in the order the spans opened."""
    return list(_spans)


def clear_spans() -> None:
    """Empty the recorded list (spans open now are not recorded)."""
    global _generation
    _spans.clear()
    _open.clear()
    _generation += 1


def host_syncs(call: Optional[int] = None) -> int:
    """The counter of blocking reads: the recorded ``cgx.sync`` spans (of
    solve ``call`` alone, where given)."""
    return sum(1 for s in _spans if s.name == SYNC
               and (call is None or s.call == call))


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

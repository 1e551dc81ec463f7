"""Profiling hooks of the port (``cgx_torch.utils.profiling``) and the
import boundary of the modules of the accuracy and reliability layer.

``solve_stats`` is held against ``cgx.utils.profiling.solve_stats``
(equal dicts).  ``trace`` runs ``torch.profiler`` here on CPU activity
only: its Chrome trace is parsed by ``trace_report`` and
``overlap_report``, which the card's smoke (phase PF) runs on device
activity.
"""
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cgx_torch
from cgx_torch.utils import profiling as prof

CPU = "cpu"


@pytest.mark.parametrize("bytes_per_iter", [None, 16 * 2**20])
def test_solve_stats_matches_cgx(bytes_per_iter):
    from cgx.utils.profiling import solve_stats as j_stats

    for seconds, its, nnz in ((0.1, 100, 14_581_760), (2.5, 0, 7),
                              (1e-3, 301, 14_450_688)):
        assert prof.solve_stats(seconds, its, nnz, bytes_per_iter) == \
            j_stats(seconds, its, nnz, bytes_per_iter)


def _cpu_solve():
    a = cgx_torch.poisson3d_stencil(12, 12, 12)
    b = torch.ones(a.shape[0])
    return cgx_torch.cg_solve(a, b, tol=1e-6, maxiter=200)


def test_trace_writes_a_chrome_trace_and_reports_cpu_ops(tmp_path):
    d = str(tmp_path / "tb")
    with prof.trace(d):
        with prof.annotate("cgx_solve_region"):
            res = _cpu_solve()
    assert bool(res.converged)
    files = os.listdir(d)
    assert files == ["trace_0.json"]
    with open(os.path.join(d, files[0])) as f:
        assert "traceEvents" in json.load(f)
    rows = prof.trace_report(d, device_only=False, top=None)
    names = {r["op"] for r in rows}
    assert "cgx_solve_region" in names
    assert any(n.startswith("aten::") for n in names)
    assert rows == sorted(rows, key=lambda r: -r["total_us"])
    region = next(r for r in rows if r["op"] == "cgx_solve_region")
    assert region["count"] == 1
    assert region["total_us"] >= max(r["total_us"] for r in rows
                                     if r["op"].startswith("aten::"))
    for r in rows:
        assert r["avg_us"] == pytest.approx(r["total_us"] / r["count"])
    # No device here: the device-only table is empty, and so is overlap.
    assert prof.trace_report(d) == []
    ov = prof.overlap_report(d)
    assert ov["a_events"] == ov["b_events"] == 0
    assert ov["overlap_frac"] == 0.0


def test_trace_numbers_successive_traces(tmp_path):
    d = str(tmp_path / "tb")
    for _ in range(2):
        with prof.trace(d):
            torch.ones(8).sum()
    assert sorted(os.listdir(d)) == ["trace_0.json", "trace_1.json"]
    assert len(prof.trace_report(d, device_only=False, top=3)) == 3


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_reports_on_device_events(tmp_path):
    """trace_report and overlap_report on a hand-written device trace:
    two kernels on one stream, a copy overlapping the first by 3 µs."""
    d = str(tmp_path)
    ev = [
        {"ph": "X", "cat": "kernel", "name": "cgx_k2", "ts": 0, "dur": 10,
         "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "cgx_k2", "ts": 20, "dur": 6,
         "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 7,
         "dur": 5, "tid": 8},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 50, "tid": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
    ]
    _write_trace(os.path.join(d, "t.json"), ev)
    rows = prof.trace_report(d)
    assert rows[0] == {"plane": "kernel", "line": "7", "op": "cgx_k2",
                       "count": 2, "total_us": 16.0, "avg_us": 8.0}
    assert [r["op"] for r in rows] == ["cgx_k2", "Memcpy HtoD"]
    assert len(prof.trace_report(d, device_only=False, top=None)) == 3
    ov = prof.overlap_report(d)
    assert ov == {"a_total_us": 5.0, "b_total_us": 16.0, "overlap_us": 3.0,
                  "overlap_frac": 0.6, "a_events": 1, "b_events": 2}


def test_time_fresh_cycles_its_inputs():
    seen = []

    def fn(v):
        seen.append(v)
        return v * 2

    best = prof.time_fresh(fn, [torch.ones(4), torch.zeros(4)], reps=5)
    assert best >= 0.0 and np.isfinite(best)
    assert len(seen) == 5
    assert [float(v[0]) for v in seen] == [1.0, 0.0, 1.0, 0.0, 1.0]


_NEW = ("cgx_torch.ops.df64", "cgx_torch.solve.hp",
        "cgx_torch.utils.checkpoint", "cgx_torch.io.native_format",
        "cgx_torch.utils.profiling")


def test_new_modules_import_neither_jax_nor_cgx():
    """Importing the accuracy and reliability layer (and the package)
    leaves JAX and the JAX package out of sys.modules."""
    code = ("import sys, cgx_torch, cgx_torch.interop; "
            + "; ".join(f"import {m}" for m in _NEW)
            + "; print(sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'cgx' or "
              "m.startswith('cgx.')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_new_names_are_exported_as_cgx_exports_them():
    import cgx

    for name in ("cg_solve_checkpointed", "df64_cg_solve", "ir_df64_solve",
                 "make_ir_df64_solver", "make_ir_df64_solver_multi",
                 "IRDF64Operator"):
        assert name in cgx.__all__ and name in cgx_torch.__all__
        assert getattr(cgx_torch, name) is not None
    import importlib
    for m in _NEW:
        mod = importlib.import_module(m)
        ref = importlib.import_module(m.replace("cgx_torch", "cgx"))
        assert set(ref.__all__) <= set(mod.__all__), m


# -- the program's spans ----------------------------------------------------

PHASES = (prof.ROUTE, prof.PREP, prof.ENGINE, prof.RESULT)


def _stencil():
    return cgx_torch.poisson3d_stencil(8, 8, 8)


def _rhs(n, k=None, seed=3):
    g = torch.Generator().manual_seed(seed)
    shape = (n,) if k is None else (n, k)
    return torch.rand(shape, generator=g, dtype=torch.float32) - 0.5


def _dia():
    from cgx_torch.io.poisson import poisson3d_dia

    return poisson3d_dia(8, 8, 8, dtype=np.float32, device=CPU)


# (name, operator, b's columns, auto_solve's options): the CPU routes of
# auto_solve, each engine's plain version among them.
ROUTES = [
    ("loop", _stencil, None, {}),
    ("loop_history", _stencil, None, {"track_history": True}),
    ("k2_plain", _stencil, None, {"backend": "resident_stencil"}),
    ("k3_plain_history", _stencil, None,
     {"backend": "fused_stencil", "track_history": True}),
    ("k3_dia_jacobi", _dia, None,
     {"backend": "fused_dia", "track_history": True, "jacobi": True}),
    ("block_loop", _stencil, 3, {}),
    ("k5_plain", _stencil, 3, {"backend": "fused"}),
]


def _solve(make, k, opts):
    a = make()
    opts = dict(opts)
    if opts.pop("jacobi", False):
        opts["preconditioner"] = cgx_torch.JacobiPrecond.from_matrix(a)
    return cgx_torch.auto_solve(a, _rhs(a.shape[0], k), tol=1e-6, **opts)


def _bench_session():
    """A profiler session opened as the benchmark opens its one."""
    from bench_h100 import trace as bench_trace

    return bench_trace.session()


def _roots(sp):
    return [i for i, s in enumerate(sp) if s.call == i]


def _check_tree(sp):
    """Every span closed and inside its parent; per root the four phases
    directly beneath it, disjoint, none inside another phase."""
    for i, s in enumerate(sp):
        assert s.name in prof.SPAN_NAMES
        assert s.end_ns is not None and s.end_ns >= s.start_ns
        if s.parent is not None:
            p = sp[s.parent]
            assert s.parent < i and p.start_ns <= s.start_ns
            assert s.end_ns <= p.end_ns and s.call == p.call
        if s.name in PHASES:
            up = s.parent
            while up is not None and sp[up].name != prof.SOLVE:
                assert sp[up].name not in PHASES, (s.name, sp[up].name)
                up = sp[up].parent
    for root in _roots(sp):
        top = [s for s in sp if s.parent == root and s.name in PHASES]
        assert {s.name for s in top} >= {prof.PREP, prof.ENGINE,
                                         prof.RESULT}
        for u, v in zip(top, top[1:]):
            assert u.end_ns <= v.start_ns


def test_no_session_records_nothing_and_enters_no_record_function(
        monkeypatch):
    entered = []

    def spy(name, *args, **kw):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    prof.clear_spans()
    res = _solve(_stencil, None, {})
    with prof.annotate(prof.PREP):
        assert prof.host_read(torch.tensor(7), int) == 7
    assert int(res.iterations) > 0
    assert entered == [] and prof.spans() == [] and prof.host_syncs() == 0
    # The same patch sees the spans once a session records.
    with _bench_session():
        with prof.annotate(prof.PREP):
            prof.host_read(torch.tensor(7), int)
    assert entered == [prof.PREP, prof.SYNC]
    assert [s.name for s in prof.spans()] == [prof.PREP, prof.SYNC]


def test_span_tree_parent_call_and_clear():
    prof.clear_spans()
    with _bench_session():
        with prof.annotate("outer"):
            for _ in range(2):
                with prof.annotate(prof.SOLVE):
                    with prof.annotate(prof.SOLVE):      # nested: a child
                        prof.host_read(torch.ones(2))
    names = [s.name for s in prof.spans()]
    assert names == ["outer"] + [prof.SOLVE, prof.SOLVE, prof.SYNC] * 2
    sp = prof.spans()
    assert _roots(sp) == [1, 4]
    assert [s.parent for s in sp] == [None, 0, 1, 2, 0, 4, 5]
    assert [s.call for s in sp] == [None, 1, 1, 1, 4, 4, 4]
    assert prof.host_syncs() == 2 and prof.host_syncs(call=4) == 1
    prof.clear_spans()
    assert prof.spans() == [] and prof.host_syncs() == 0


@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES])
def test_session_changes_no_answer(route):
    """x, iterations and history bit for bit with and without a session,
    and the calls' span trees well formed."""
    _, make, k, opts = route
    plain = _solve(make, k, opts)
    prof.clear_spans()
    with _bench_session():
        traced = _solve(make, k, opts)
    for f in ("x", "iterations", "converged", "residual_norm_sq", "history"):
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f
    sp = prof.spans()
    assert len(_roots(sp)) == 1
    _check_tree(sp)
    if make is _dia:
        names = [s.name for s in sp]
        assert prof.CHECK_WRAP in names and prof.CHECK_SYM in names
        dia = next(s for s in sp if s.name == prof.PREP_DIA)
        assert sp[dia.parent].name == prof.PREP


def _chrome_cgx(path):
    with open(path) as f:
        doc = json.load(f)
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith("cgx.")]
    evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    parents, stack = [], []
    for i, e in enumerate(evs):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        while stack and float(evs[stack[-1]]["ts"]) + float(
                evs[stack[-1]]["dur"]) < t1:
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    return evs, parents


def _traced_pair(log_dir, session, k):
    """Two auto_solve calls in one session opened as ``session`` says;
    the recorded spans and the path of the Chrome trace."""
    prof.clear_spans()
    log_dir.mkdir()
    path = str(log_dir / "trace_0.json")
    opened = (_bench_session() if session == "benchmark"
              else prof.trace(str(log_dir)))
    with opened as p:
        for seed in (1, 2):
            a = _stencil()
            cgx_torch.auto_solve(a, _rhs(a.shape[0], k, seed))
    if session == "benchmark":
        p.export_chrome_trace(path)
    return prof.spans(), path


@pytest.mark.parametrize("k", [None, 3], ids=["1d", "2d"])
@pytest.mark.parametrize("session", ["benchmark", "trace"])
def test_spans_match_the_chrome_trace(tmp_path, session, k):
    """The recorded spans are the trace's ``cgx.*`` events, in the same
    order and nesting, each as long within 10 % or 50 µs.  A host stall
    inside the profiler's own enter or exit (tens of µs on a loaded CPU)
    can part the two clocks on one span, so the calls are traced up to
    three times: the tree holds in every session and the lengths agree
    span by span in one."""
    for attempt in range(3):
        sp, path = _traced_pair(tmp_path / str(attempt), session, k)
        assert len(_roots(sp)) == 2
        _check_tree(sp)
        for root in _roots(sp):
            assert [s.name for s in sp if s.parent == root] == list(PHASES)
        evs, parents = _chrome_cgx(path)
        assert [e["name"] for e in evs] == [s.name for s in sp]
        assert parents == [s.parent for s in sp]
        off = [(s.name, float(e["dur"]), (s.end_ns - s.start_ns) / 1e3)
               for e, s in zip(evs, sp)]
        off = [o for o in off if abs(o[1] - o[2]) > max(0.1 * o[1], 50.0)]
        if not off:
            return
    pytest.fail(f"span lengths (trace µs, recorded µs) off in three "
                f"sessions, the last: {off}")


def test_host_syncs_count_the_loops_reads():
    """The loops whose reads ``cg.host_reads`` counts: as many ``cgx.sync``
    spans as reads; ``cg_solve`` (auto_solve's loop route) reads its exit
    test once an iteration and once more, through the same spans, and
    ``host_reads`` does not count it."""
    from cgx_torch.solve import cg

    a = _stencil()
    b = _rhs(a.shape[0])
    for solve in (cg.cg_solve_single_reduction, cg.cg_solve_pipelined):
        cg.host_reads = 0
        plain = solve(a, b, tol=1e-6)
        untraced = cg.host_reads
        assert untraced == int(plain.iterations) + 1
        prof.clear_spans()
        cg.host_reads = 0
        with _bench_session():
            traced = solve(a, b, tol=1e-6)
        assert cg.host_reads == untraced
        assert prof.host_syncs() == untraced
        assert torch.equal(plain.x, traced.x)
    cg.host_reads = 0
    prof.clear_spans()
    with _bench_session():
        res = cgx_torch.auto_solve(a, b)
    assert cg.host_reads == 0
    root = _roots(prof.spans())[0]
    assert prof.host_syncs(call=root) == int(res.iterations) + 1
    engine = next(i for i, s in enumerate(prof.spans())
                  if s.name == prof.ENGINE)
    assert all(s.parent == engine for s in prof.spans()
               if s.name == prof.SYNC)

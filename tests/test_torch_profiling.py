"""Profiling hooks of the port (``cgx_torch.utils.profiling``) and the
import boundary of the modules of the accuracy and reliability layer.

``solve_stats`` is held against ``cgx.utils.profiling.solve_stats``
(equal dicts).  ``trace`` runs ``torch.profiler`` here on CPU activity
only: its Chrome trace is parsed by ``trace_report`` and
``overlap_report``, which the card's smoke (phase PF) runs on device
activity.
"""
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

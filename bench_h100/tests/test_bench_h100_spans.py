"""The span readers (``entry_span_ms``, ``host_syncs``) on synthetic span
lists, on spans the program recorded on the CPU, and in the catalog."""
from types import SimpleNamespace

import pytest
import torch

from bench_h100 import catalog
from bench_h100 import trace as bench_trace
from cgx_torch.utils import profiling
from cgx_torch.utils.profiling import Span

BENCH = catalog.benchmark()
MS = 1_000_000


def _ctx(n_calls):
    return SimpleNamespace(traced={"calls": [object()] * n_calls})


def _call(at, route, prep, engine, result, syncs=0, checks=0):
    """One call's spans from index ``at``: the root, then each phase
    ``(name, ms)`` laid end to end, ``syncs`` inside the engine and
    ``checks`` inside the route."""
    out = [Span("cgx.solve", 0, None, None, at)]
    t = 0
    for name, ms in (("cgx.route", route), ("cgx.prep", prep),
                     ("cgx.engine", engine), ("cgx.result", result)):
        i = at + len(out)
        out.append(Span(name, t, t + int(ms * MS), at, at))
        if name == "cgx.route":
            out += [Span("cgx.check.wrap", t, t + 1, i, at)] * checks
        if name == "cgx.engine":
            out += [Span("cgx.sync", t, t + 1, i, at)] * syncs
        t += int(ms * MS)
    out[0] = out[0]._replace(end_ns=t)
    return out


def _patch(monkeypatch, sp):
    monkeypatch.setattr(profiling, "_spans", list(sp))


def test_entry_sums_the_top_level_phases(monkeypatch):
    sp = _call(0, 0.25, 1.5, 100.0, 0.5, syncs=19, checks=2)
    sp += _call(len(sp), 0.75, 2.5, 90.0, 1.5, syncs=18)
    # A nested solve's phases are its own, not the call's.
    sp.append(Span("cgx.solve", 0, 7 * MS, 5, 0))
    sp.append(Span("cgx.prep", 0, 7 * MS, len(sp) - 1, 0))
    _patch(monkeypatch, sp)
    entry = catalog.metric("entry_span_ms").read(_ctx(2))
    assert entry == pytest.approx(((0.25 + 1.5 + 0.5)
                                   + (0.75 + 2.5 + 1.5)) / 2)
    assert catalog.metric("host_syncs").read(_ctx(2)) == 18.5


@pytest.mark.parametrize("name", ["entry_span_ms", "host_syncs"])
def test_no_number_without_a_trace_or_with_other_roots(monkeypatch, name):
    reader = catalog.metric(name)
    sp = _call(0, 1.0, 1.0, 1.0, 1.0, syncs=3)
    _patch(monkeypatch, sp)
    assert reader.read(SimpleNamespace(traced=None)) is None
    assert reader.read(_ctx(2)) is None            # one root, two calls
    assert reader.read(_ctx(1)) is not None
    _patch(monkeypatch, [])
    assert reader.read(_ctx(1)) is None
    # A program that records no spans (before they existed) gives none.
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(_ctx(1)) is None


def test_readers_on_the_programs_own_spans():
    """Two CPU solves on the loop route in a session opened as the
    harness opens its one: a sync a read of the exit test."""
    import cgx_torch

    a = cgx_torch.poisson3d_stencil(6, 6, 6)
    g = torch.Generator().manual_seed(5)
    profiling.clear_spans()
    with bench_trace.session():
        res = [cgx_torch.auto_solve(a, torch.rand(a.shape[0], generator=g))
               for _ in range(2)]
    ctx = SimpleNamespace(traced={"calls": res})
    reads = sum(int(r.iterations) + 1 for r in res) / 2
    assert catalog.metric("host_syncs").read(ctx) == reads
    entry = catalog.metric("entry_span_ms").read(ctx)
    sp = profiling.spans()
    whole = sum(s.end_ns - s.start_ns for s in sp
                if s.name == "cgx.solve") * 1e-6 / 2
    assert 0.0 < entry < whole
    profiling.clear_spans()


def test_split_span_metrics_read_by_their_base():
    for name in ("entry_span_ms", "host_syncs"):
        assert catalog.metric(f"{name}.history").__name__ == \
            f"bench_h100.metrics.{name}"


@pytest.mark.parametrize("cell, names", [
    ("poisson7_224.single", {"entry_span_ms"}),
    ("poisson7_224.block4", {"entry_span_ms", "host_syncs"}),
    ("poisson7_224.history", {"entry_span_ms.history",
                              "host_syncs.history"}),
])
def test_each_cell_lists_its_span_metrics(cell, names):
    got = {m["name"] for m, _ in catalog.cell(cell).per_layer
           if m["name"].split(".")[0] in ("entry_span_ms", "host_syncs")}
    assert got == names

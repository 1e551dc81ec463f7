"""The comparison that decides ``correct``, driven end to end on the CPU at
a small size with the chip's look skipped: the program passes, the control
(the program's own path one precision down) fails, and so does every fault
these cells can have, planted under the timed path."""
import dataclasses
import time

import pytest
import torch

from bench_h100 import catalog, control, harness, trace

N = 12
CELLS = ["poisson7_224.single", "poisson7_224.block4", "poisson7_224.history"]


def small(name):
    cell = catalog.cell(name)
    cfg = dict(cell.config, grid=[N, N, N], rows=N ** 3)
    return dataclasses.replace(cell, config=cfg)


def run(cell, wrap=None, check_route=False, seed=2 ** 31 + 3):
    return harness.run_cell(cell, seed, 0.15, False, device="cpu",
                            t_start=time.perf_counter(), wrap=wrap,
                            check_route=check_route)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    out = run(small(name))
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["samples"] >= 1
    assert set(out["checks"]) >= {"relres"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small(name)
    out = run(cell, wrap=control.control_wrap(cell))
    assert not out["correct"]
    assert out["checks"]["relres"]["value"] > out["checks"]["relres"]["limit"]


def _unchanged(problem, solve):
    """A step that returns its state unchanged: x is x0."""
    def broken(b):
        res = solve(b)
        return dataclasses.replace(res, x=torch.zeros_like(res.x))
    return broken


def _altered(problem, solve):
    """An answer altered where it is produced: one entry of x moved."""
    def broken(b):
        res = solve(b)
        x = res.x.clone()
        x[x.shape[0] // 2] += 1.0
        return dataclasses.replace(res, x=x)
    return broken


def _half_batch(problem, solve):
    """Half of the batch left out, the mean of the rest in its place."""
    def broken(b):
        k = b.shape[1]
        res = solve(b[:, :k // 2].contiguous())
        mean = res.x.mean(dim=1, keepdim=True).expand(-1, k - k // 2)
        return dataclasses.replace(
            res, x=torch.cat([res.x, mean], dim=1),
            iterations=torch.cat([res.iterations.reshape(-1)] * 2),
            converged=torch.cat([res.converged.reshape(-1)] * 2))
    return broken


def _history_altered(problem, solve):
    """The history altered where it is produced."""
    def broken(b):
        res = solve(b)
        return dataclasses.replace(res, history=res.history * 1.5)
    return broken


FAULTS = [(c, f) for c in CELLS for f in (_unchanged, _altered)] + [
    ("poisson7_224.block4", _half_batch),
    ("poisson7_224.history", _history_altered)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(name, fault):
    out = run(small(name), wrap=fault)
    assert not out["correct"], out["numbers"]


def test_a_call_off_its_route_fails():
    # On the CPU no kernel launches, so the K2 route's counters stay still.
    out = run(small("poisson7_224.single"), check_route=True)
    assert out["failed"] == out["attempted"] and not out["correct"]


def test_route_check_reads_the_counters():
    route = catalog.route("K2")
    names = route["moves"] + route["still"]
    before = dict.fromkeys(names, 0)
    after = dict(before)
    after[route["moves"][0]] = 1
    assert harness._route_check(route, before, after)[0]
    after[route["still"][0]] = 3
    ok, text = harness._route_check(route, before, after)
    assert not ok and "off route" in text
    assert not harness._route_check(route, before, before)[0]


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def test_trace_reduction():
    evs = [
        _ev(trace.WINDOW, "user_annotation", 0.0, 1000.0),
        _ev(trace.CALL, "user_annotation", 0.0, 600.0),
        _ev(trace.READBACK, "user_annotation", 600.0, 400.0),
        _ev("aten::mul", "cpu_op", 10.0, 50.0, **{"External id": 7}),
        _ev("void cgx::(anonymous namespace)::two_phase_kernel<7>(cgx::A)",
            "kernel", 100.0, 400.0),
        _ev("void at::native::vectorized_elementwise_kernel<4>(int)",
            "kernel", 520.0, 30.0, **{"External id": 7}),
        _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 900.0, 10.0),
        _ev("aten::item", "cpu_op", 650.0, 300.0),
    ]
    red = trace.reduce(evs)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx(440e-6)
    assert red["kernel_s"] == pytest.approx(430e-6)
    assert red["device_ops"][0] == ["two_phase_kernel", pytest.approx(400e-6)]
    assert ["aten::mul: vectorized_elementwise_kernel",
            pytest.approx(30e-6)] in red["device_ops"]
    gaps = dict((k, v) for k, v in red["idle_gaps"])
    # Each gap is named by what the host was doing at its middle.
    assert gaps == pytest.approx({"route+prep+engine: aten::mul": 100e-6,
                                  "route+prep+engine": 20e-6,
                                  "readback: aten::item": 350e-6,
                                  "readback": 90e-6})
    assert trace.kernel_seconds(red["device"], [r"\btwo_phase_kernel\b"]) \
        == pytest.approx(400e-6)
    with pytest.raises(RuntimeError, match="no window"):
        trace.reduce(evs[1:])

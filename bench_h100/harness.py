"""Run one cell once: set-up, the measured window, the traced calls and the
judgement.

The traffic is a closed loop with one caller, as a time-stepping code is: it
issues the next call when the last result is on the host.  At set-up the
harness draws a pool of right-hand sides (``pool`` of them, ``columns``
wide, uniform in ``[rhs_low, rhs_high)``) on the card from the seed, after
the configuration's operator, with one ``torch.Generator``; x0 is zero and
the calls cycle through the pool.  A call is ``auto_solve(operator, b,
preconditioner=…, tol=…, **options)``; it ends when its ``iterations`` and
``converged`` (and, where the mix reads it, the history up to the exit) are
on the host and the card is synchronised; x stays on the card.  Each call's
route is checked by the launch counters its route file names, and its
``converged``: a call that fails either is counted in ``failed``.

Set-up is everything from the process's start to the first timed call: the
CUDA context, the kernel library, the operator, the pool and two warm calls
at the cell's own shapes.  The run prints when each of these ended.  The window then runs calls for ``seconds``; a
traced run adds one profiler session over one cycle of the pool after it.
Once those are done, the peak of device memory is read, the program's state
is freed and the reference judges a sample of the window's calls drawn from
the seed (:mod:`bench_h100.judge`).
"""
from __future__ import annotations

import contextlib
import importlib
import random
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from bench_h100 import catalog, judge, trace

# Calls the sample keeps besides the last one.
SAMPLES = 3
# Warm calls at set-up.
WARM = 2


@dataclass(eq=False)
class Call:
    t0: float
    t1: float
    pool: int
    iterations: list
    converged: list
    route: str
    route_ok: bool
    result: object = field(default=None, repr=False)

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    @property
    def failed(self) -> bool:
        return not (self.route_ok and all(self.converged))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _counter_reader(route: dict) -> Callable[[], dict]:
    """A function that reads every counter the route names."""
    names = list(route["moves"]) + list(route["still"])
    mods = {n: importlib.import_module(n.split(":")[0]) for n in names}

    def read():
        return {n: int(getattr(mods[n], n.split(":")[1])) for n in names}

    return read


def _route_check(route: dict, before: dict, after: dict) -> tuple:
    """``(ok, text)``: the route's ``moves`` counters grew (by
    ``launches_per_call`` where it is set) and its ``still`` counters
    did not."""
    moved = {n: after[n] - before[n] for n in route["moves"]}
    still = {n: after[n] - before[n] for n in route["still"]
             if after[n] != before[n]}
    grown = sum(moved.values())
    want = route.get("launches_per_call")
    ok = grown > 0 and not still and (want is None or grown == want)
    text = ", ".join(f"{n.split(':')[1]} +{d}" for n, d in moved.items() if d)
    if still:
        text += "; off route: " + ", ".join(
            f"{n.split(':')[1]} +{d}" for n, d in still.items())
    return ok, f"{route['engine']} ({text or 'no launch'})"


class Caller:
    """The one caller of the closed loop: issues a call, reads its result
    back, checks its route."""

    def __init__(self, solve, pool, counters, route, read_history, sync):
        self.solve, self.pool, self.counters = solve, pool, counters
        self.route, self.read_history, self.sync = route, read_history, sync
        self.traced = False

    def _span(self, name):
        if self.traced:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def __call__(self, i: int) -> Call:
        p = i % self.pool.shape[0]
        before = self.counters() if self.counters else None
        t0 = time.perf_counter()
        with self._span(trace.CALL):
            res = self.solve(self.pool[p])
        with self._span(trace.READBACK):
            its = res.iterations.reshape(-1).tolist()
            conv = res.converged.reshape(-1).tolist()
            hist = (res.history[:max(its) + 1].cpu() if self.read_history
                    else None)
            self.sync()
        t1 = time.perf_counter()
        ok, text = True, "not checked"
        if self.counters:
            ok, text = _route_check(self.route, before, self.counters())
        return Call(t0, t1, p, its, [bool(c) for c in conv], text, ok,
                    SimpleNamespace(x=res.x, history=hist))


def run_cell(cell: catalog.Cell, seed: int, seconds: float, traced: bool, *,
             device: str, t_start: float, wrap: Optional[Callable] = None,
             check_route: bool = True) -> dict:
    """Run ``cell`` once.  ``wrap(problem, solve)`` replaces the program's
    call ``solve(b)`` with another (the control and the fault tests);
    ``check_route=False`` skips the launch counters (the CPU, where no
    kernel launches).  Returns the pieces of the result line (see
    :mod:`bench_h100.run`)."""
    cfg, tr, route = cell.config, cell.traffic, cell.route
    if tr["loop"] != "closed" or int(tr["callers"]) != 1:
        raise ValueError(f"{tr['name']}: the harness drives a closed loop "
                         f"with one caller")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stages = []

    def stage(name):
        sync()
        stages.append((name, time.perf_counter() - t_start))

    stage("start")
    if cuda:
        torch.zeros(1, device=dev)
        stage("context")
        from cgx_torch.kernels import _build

        _build.library()
        stage("library")
    from cgx_torch.solve.auto import auto_solve

    stage("program")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    problem = catalog.generator(cfg["kind"]).make(cfg, gen, dev)
    stage("operator")
    n, k, n_pool = int(cfg["rows"]), int(tr["columns"]), int(tr["pool"])
    shape = (n_pool, n) if k == 1 else (n_pool, n, k)
    pool = torch.empty(shape, dtype=getattr(torch, cfg["dtype"]), device=dev)
    pool.uniform_(float(tr["rhs_low"]), float(tr["rhs_high"]), generator=gen)
    stage("pool")
    opts = dict(tr["options"])

    def solve(b):
        return auto_solve(problem.operator, b,
                          preconditioner=problem.preconditioner,
                          tol=float(cfg["tol"]), **opts)
    if wrap is not None:
        solve = wrap(problem, solve)
    caller = Caller(solve, pool, _counter_reader(route) if check_route
                    else None, route, bool(tr["read_history"]), sync)

    for i in range(WARM):
        caller(i)
        stage(f"warm {i + 1}")
    setup_s = time.perf_counter() - t_start
    log("setup: " + ", ".join(f"{name} {t:.3f}" for name, t in stages)
        + " s after the start")

    # The window; the sample is a reservoir over its calls, drawn from the
    # seed, and the last call.  Only the sample keeps its answers.
    rng = random.Random(f"{seed}:sample")
    kept, calls = [], []
    deadline = time.perf_counter() + seconds
    while True:
        c = caller(len(calls))
        if len(kept) < SAMPLES:
            kept.append(c)
        else:
            j = rng.randrange(len(calls) + 1)
            if j < SAMPLES:
                kept[j].result = None
                kept[j] = c
        if calls and calls[-1] not in kept:
            calls[-1].result = None
        calls.append(c)
        if c.t1 >= deadline:
            break
    window_s = calls[-1].t1 - calls[0].t0
    samples = kept + ([calls[-1]] if calls[-1] not in kept else [])
    log(f"window: {len(calls)} calls in {window_s:.6f} s; "
        f"route {calls[-1].route}")

    tinfo = None
    if traced:
        tinfo = _traced(caller, n_pool, cuda)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # Free the program's state before the reference runs.
    data = problem.data
    del problem, solve, caller
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge.judge(
        [{"x": s.result.x, "b": pool[s.pool], "pool": s.pool,
          "iterations": s.iterations, "history": s.result.history}
         for s in samples],
        data, catalog.reference(cfg["kind"]), cfg, bool(tr["read_history"]))
    ok, checks = judge.verdict(numbers, cfg["limits"])
    everything = calls + (tinfo["calls"] if tinfo else [])
    failed = sum(1 for c in everything if c.failed)
    ctx = SimpleNamespace(config=cfg, traffic=tr, columns=k, calls=calls,
                          window_s=window_s, setup_s=setup_s, traced=tinfo,
                          device_name=(torch.cuda.get_device_name(dev)
                                       if cuda else "cpu"))
    return {"correct": bool(ok and failed == 0), "attempted": len(everything),
            "failed": failed, "checks": checks, "numbers": numbers,
            "samples": len(samples), "route": calls[-1].route,
            "reference_s": time.perf_counter() - t_ref, "ctx": ctx,
            "memory_peak_bytes": int(memory_peak)}


def _answerless(call: Call) -> Call:
    """``call`` with its answer dropped at once, so that the allocator
    reuses its memory for the next call as in the window."""
    call.result = None
    return call


def _traced(caller: Caller, count: int, cuda: bool) -> dict:
    """One profiler session over ``count`` calls (one cycle of the pool),
    with the harness's spans, and CUDA events around the same calls."""
    prof = trace.session()
    ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
    ev1 = torch.cuda.Event(enable_timing=True) if cuda else None
    caller.traced = True
    try:
        with prof:
            with torch.profiler.record_function(trace.WINDOW):
                if cuda:
                    ev0.record()
                calls = [_answerless(caller(i)) for i in range(count)]
                if cuda:
                    ev1.record()
                    torch.cuda.synchronize()
    finally:
        caller.traced = False
    reduced = trace.reduce(trace.events(prof))
    event_s = ev0.elapsed_time(ev1) * 1e-3 if cuda else 0.0
    return {"calls": calls, "reduced": reduced, "event_s": event_s}

"""Device time per launch of the single-card two-pass engines' kernels.

K3 (``kernel_a2``, ``kernel_b2``) on the 224³ 7-point stencil and on
DIA-7 192³ under Jacobi (the smoke's ``scaled_dia7``: D·A·D with D ~
U[0.5, 2) from seed 0, symmetric planes), and K5 (``multi_a2``,
``multi_b``) on DIA-27 160³ under Jacobi and on the 224³ stencil at k = 4
seeded columns.  Each engine is built once and runs its solve for a fixed
number of iterations (``tol = 0``): torch.profiler's device time per launch
of each kernel (CUDA activity only), and CUDA events around the whole solve
(µs per iteration, the median of three solves).  Then each kernel alone,
kernel A in its x0 mode and kernel B one step from p's sums, its
arguments built once: device µs per call by CUDA events around 20 calls
queued behind a spin kernel (median of three; ``queued_a``,
``queued_b``).  Prints one JSON line ``{"root": ..., "card": ...,
"cells": {label: {kernel: µs, ..., "us_per_iter": ...}}}``.

Run on the card: ``python3 cgx_torch/experiments/engine_times.py [--root
DIR]``.  ``--root`` imports the ``cgx_torch`` of another checkout (built in
its own ``build/``) instead of this one's, so that two trees are compared
in one session on one card by running the script on each in turns.
Without a card it exits with code 2.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ITERS = 200
K = 4
SEED = 0
# The kernels of the main path, as their instances are named.
KERNELS = re.compile(r"\b(kernel_a2|kernel_b2|multi_a2|multi_a|multi_b)<")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _scaled_dia7(dims, dev):
    import torch

    from cgx_torch.io.poisson import poisson3d_dia
    from cgx_torch.sparse.types import DIAMatrix

    a = poisson3d_dia(*dims, device="cpu")
    n = a.shape[0]
    d = np.random.default_rng(SEED).uniform(0.5, 2.0, n)
    data = a.data.numpy()
    for k, off in enumerate(a.offsets):
        tgt = np.arange(n) + off
        ok = (tgt >= 0) & (tgt < n)
        data[k, ok] *= d[ok] * d[tgt[ok]]
    return DIAMatrix(data=torch.from_numpy(data.astype(np.float32)).to(dev),
                     offsets=a.offsets, shape=a.shape, grid=a.grid)


def cells(dev):
    """``{label: (engine, b)}``: the solve-space right-hand sides."""
    import torch

    import cgx_torch
    from cgx_torch.io.poisson import poisson3d_dia27
    from cgx_torch.kernels.fused_cg import build_fused
    from cgx_torch.kernels.fused_dia_cg import build_fused_dia, dia_prep
    from cgx_torch.kernels.fused_multi import FusedCGMulti

    rng = np.random.default_rng(SEED)

    def rhs(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    out = {}
    s224 = cgx_torch.poisson3d_stencil(224, 224, 224)
    out["K3 stencil 224^3"] = (build_fused(s224, torch.float32),
                               rhs(224 ** 3))
    eng, e, _ = build_fused_dia(_scaled_dia7((192, 192, 192), dev),
                                torch.float32)
    out["K3 DIA-7 192^3 Jacobi"] = (eng, e * rhs(192 ** 3))
    d160 = poisson3d_dia27(160, 160, 160, variable=True, seed=SEED,
                           device=dev)
    nx, ny, nz, taps, coeffs, planes, e, w, sym = dia_prep(d160,
                                                           torch.float32)
    out[f"K5 DIA-27 160^3 Jacobi k={K}"] = (
        FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                     weight=w, sym=sym), e[None] * rhs(K, 160 ** 3))
    k3 = out["K3 stencil 224^3"][0]
    out[f"K5 stencil 224^3 k={K}"] = (
        FusedCGMulti(224, 224, 224, k3.taps, coeffs=k3.coeffs),
        rhs(K, 224 ** 3))
    return out


def queued_us(fn, calls: int = 20, reps: int = 3) -> float:
    """Device µs per call of ``fn``: CUDA events around ``calls`` calls
    enqueued behind a spin kernel (the spin doubled until it outlasts the
    enqueue), the median of ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times, spin = [], 10_000_000
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            times.append(start.elapsed_time(end) / calls * 1e3)
        elif spin > 80_000_000:
            raise RuntimeError("queued_us: the spin ran out")
        else:
            spin *= 2
    return statistics.median(times)


def _checked(lib_fn, args):
    def run():
        rc = lib_fn(*args)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
    return run


def k3_launchers(eng, b):
    """Kernel A (x0 mode) and kernel B (one step) of K3 on p = b."""
    import torch

    from cgx_torch.kernels import fused_engine as k3

    p = b.contiguous()
    lib, ga, _ = eng._setup(p)
    q = torch.empty_like(p)
    part = torch.empty(2 * ga, dtype=torch.float64, device=p.device)
    run_a = _checked(lib.cgx_fused_a, eng._a_args(
        p, q, part, ga, None, 1, None, None, init=1, design=k3._REDESIGN))
    run_a()
    torch.cuda.synchronize()
    q64, p64 = q.double(), p.double()
    pq, qq = torch.sum(q64 * p64).float(), torch.sum(q64 * q64).float()
    lib, args, _ = eng._kernel_b_setup(torch.sum(p64 * p64).float(), pq, qq,
                                       0.5 * p, p, p, q, k3._REDESIGN)
    return run_a, _checked(lib.cgx_fused_b, args)


def k5_launchers(eng, b):
    """Kernel A (its design on the card) and kernel B (one step) of K5 on
    P = b."""
    import torch

    from cgx_torch.kernels import fused_multi as k5

    p = b.contiguous()
    k, dev = p.shape[0], p.device
    design = eng.a_design()
    run_a, q, _ = k5._kernel_a_launcher(eng, p, design)
    run_a()
    torch.cuda.synchronize()
    q64, p64 = q.double(), p.double()
    lib, _, gb = eng._setup(p, design)
    ctl, f = eng._ctl(k, dev)
    for fld, v in ((k5._RZ, torch.sum(p64 * p64, dim=1)),
                   (k5._PQ, torch.sum(q64 * p64, dim=1)),
                   (k5._QQ, torch.sum(q64 * q64, dim=1))):
        eng._field(f, fld).copy_(v.float())
    ctl[k5._MAXIT] = 2 ** 31 - 1
    part = torch.empty(2 * k * gb, dtype=torch.float64, device=dev)
    args = eng._b_args(0.5 * p, p.clone(), p.clone(), q, part, gb, ctl)
    return run_a, _checked(lib.cgx_multi_b, args)


def measure(eng, b) -> dict:
    """The kernels' device µs per launch over one solve of ITERS
    iterations, and the solve's event µs per iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def solve():
        return eng.solve(b, tol=0.0, maxiter=ITERS)

    solve()                                  # builds and warms up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = solve()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    its = int(res.iterations.reshape(-1)[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    row = {"iterations": its,
           "us_per_iter": statistics.median(times) / its * 1e3}
    for ev in prof.key_averages():
        m = KERNELS.search(ev.key)
        if m and ev.self_device_time_total > 0:
            row[m.group(1)] = ev.self_device_time_total / ev.count
            row[m.group(1) + "_launches"] = ev.count
    run_a, run_b = (k5_launchers if b.dim() == 2 else k3_launchers)(eng, b)
    row["queued_a"], row["queued_b"] = queued_us(run_a), queued_us(run_b)
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]),
                        help="the checkout whose cgx_torch is timed")
    root = str(Path(parser.parse_args().root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("engine_times: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import cgx_torch

    if not cgx_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {cgx_torch.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    out = {label: measure(eng, b) for label, (eng, b) in cells(dev).items()}
    print(json.dumps({"root": root, "card": _card(), "cells": out}))


if __name__ == "__main__":
    main()

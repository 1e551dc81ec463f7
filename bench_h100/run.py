"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m bench_h100.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository, on a machine with the cards the cell asks
for.  With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from one profiler
session after the window.  The numbers the comparison judged are printed
beside their limits as the last lines on standard error and under the last
key of the result line; the result line is the last line on standard
output.  Without a card, without the program or with JAX loaded, the run
prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# Modules that may not be loaded in the process that prints the result,
# compared by whole top-level names (``cgx_torch`` is not ``cgx``).
FORBIDDEN = ("jax", "jaxlib", "flax", "cgx")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def fail(msg: str, code: int = 1):
    print(f"bench_h100: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench_h100.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_h100 import catalog

    cell = catalog.cell(args.workload)
    import torch

    print(f"setup: torch imported {time.perf_counter() - T_START:.3f} s "
          f"after the start", file=sys.stderr, flush=True)
    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    try:
        import cgx_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program (cgx_torch) is not importable: {e}")
    from bench_h100 import harness, stats

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t_start=T_START)
    ctx = out["ctx"]
    bad = forbidden_modules()
    if bad:
        fail(f"loaded in this process: {', '.join(bad)}", 3)

    log = harness.log
    card = power_limit()
    log(f"card: {card}")
    specs = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for spec, mod in specs:
        v = mod.read(ctx)
        if v is not None:
            metrics[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    walls = [c.wall_s for c in ctx.calls]
    log(f"samples: {len(walls)} calls in the window, "
        f"{stats.beyond(walls, 95.0)} above the 95th percentile; "
        f"route {out['route']}")
    device = {"platform": "gpu", "kind": ctx.device_name,
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit": card}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        t = ctx.traced
        red = t["reduced"]
        if red["kernel_s"] <= 0.0:
            fail("the profiler recorded no device time")
        log(f"trace: kernels {red['kernel_s']:.6f} s, busy {red['busy_s']:.6f}"
            f" s in a window of {red['window_s']:.6f} s; CUDA events over the "
            f"same calls {t['event_s']:.6f} s (kernels/events "
            f"{red['kernel_s'] / t['event_s']:.4f})")
        device["busy_s"] = red["busy_s"]
        device["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    for name, v in metrics.items():
        log(f"metric {name}: {v['value']!r} {v['unit']}")
    log(f"reference: {out['samples']} calls judged in "
        f"{out['reference_s']:.3f} s; numbers {out['numbers']}")
    log(f"failed calls: {out['failed']} of {out['attempted']} (limit 0)")
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    checks = {name: {"value": c["value"], "limit": c["limit"]}
              for name, c in out["checks"].items()}
    checks["failed_calls"] = {"value": out["failed"], "limit": 0}
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

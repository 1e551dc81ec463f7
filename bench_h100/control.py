"""The readings that the comparison's limits are set from.

    python3 -m bench_h100.control --workload <cell> --seeds 1,2,3 --seconds 5 [--control]

runs the cell's window on each seed in one process and prints each seed's
compared numbers as a JSON line, then the largest and smallest of each.
Without ``--control`` it runs the program as the benchmark does (the lower
readings); with it, the control: the program's own path one precision down
(``generators/<kind>.py``'s ``control_solve``), which the comparison has to
find wrong (the upper readings).  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from bench_h100 import catalog


def control_wrap(cell: catalog.Cell):
    """``wrap`` for :func:`bench_h100.harness.run_cell` that puts the
    control in the program's place."""
    gen = catalog.generator(cell.config["kind"])
    return lambda problem, _: gen.control_solve(problem, cell.config,
                                                cell.traffic)


def readings(cell: catalog.Cell, seeds, seconds: float, control: bool,
             device: str) -> list:
    from bench_h100 import harness

    rows = []
    for seed in seeds:
        out = harness.run_cell(cell, seed, seconds, False, device=device,
                               t_start=time.perf_counter(),
                               wrap=control_wrap(cell) if control else None,
                               check_route=not control)
        row = {"workload": cell.name, "seed": seed, "control": control,
               "correct": out["correct"], "calls": len(out["ctx"].calls),
               "failed": out["failed"], "numbers": out["numbers"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench_h100.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_h100: no CUDA device", file=sys.stderr)
        return 1
    cell = catalog.cell(args.workload)
    rows = readings(cell, [int(s) for s in args.seeds.split(",")],
                    args.seconds, args.control, "cuda:0")
    names = sorted({k for r in rows for k in r["numbers"]})
    print(json.dumps({"workload": cell.name, "control": args.control,
                      "seeds": len(rows),
                      "max": {k: max(r["numbers"][k] for r in rows)
                              for k in names},
                      "min": {k: min(r["numbers"][k] for r in rows)
                              for k in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

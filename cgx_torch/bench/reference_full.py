"""The reference program's full-size problem (PyTorch).

Counterpart of :mod:`cgx.bench.reference_full`.  The reference's Makefile
``run-full`` target solves its course dataset — n ≈ 52,269 rows with
≈ 18.02 M nonzeros (the capacities hard-coded at ``cg.c:235,260-265``) —
for 30 iterations.  That dataset is not in its tree, so this harness
builds an SPD system of exactly that shape (a 345-diagonal banded
operator, 52,269 × 345 ≈ 18.0 M nonzeros), writes it in the reference's
4-line format, runs the compiled C program and the port for the same
fixed count of updates, and compares the solutions at the program's print
precision.

Run: ``python -m cgx_torch.bench.reference_full [--iters 30] [--ref-dir
DIR] [--device cpu]``.  The reference tree is ``--ref-dir``, else
``$CGX_REFERENCE_DIR``, else ``~/reference``; without it the command
fails, as the JAX package's does.  The C program's O(n²) product takes
~2 s an iteration at this size.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

__all__ = ["build_full_problem", "solve_full", "main"]

REF_DIR = os.environ.get("CGX_REFERENCE_DIR",
                         os.path.join(os.path.expanduser("~"), "reference"))


def build_full_problem(n=52269, bands=172, seed=0):
    """Banded SPD matrix with 2·bands + 1 diagonals (≈ the course nnz) and
    a seeded right-hand side, as scipy CSR and numpy: the JAX package's
    generator, entry for entry."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    offsets = list(range(-bands, bands + 1))
    # Symmetric, strongly diagonally dominant => SPD: diag = 2*bands + 1,
    # each off-diagonal -1/(2*bands)  (row |offdiag| sum = 1 << diag).
    diags = [np.full(n - abs(o),
                     2.0 * bands + 1.0 if o == 0 else -1.0 / (2 * bands))
             for o in offsets]
    a = sp.diags(diags, offsets, format="csr")
    a.sort_indices()
    b = rng.standard_normal(n)
    return a, b


def solve_full(a, b, iters: int, fmt: str = "csr", device="cuda"):
    """The port's side of the comparison: ``cg_solve(tol=0,
    maxiter=iters + 1)`` in fp32 on ``device`` (the reference runs
    ``iters + 1`` updates: its break comes after the update,
    ``cg.c:125-127``).  ``a`` is the port's CSR matrix, ``b`` a numpy
    vector.  Returns ``(x as fp64 numpy, seconds of the first solve,
    seconds of the second)``, each solve timed by CUDA events on the card
    and the host clock on the CPU."""
    import torch

    from cgx_torch.cli import _timer
    from cgx_torch.solve.cg import cg_solve
    from cgx_torch.sparse.types import ell_from_csr, resolve_device

    dev = resolve_device(device)
    a32 = a.astype(torch.float32)
    if fmt == "ell":
        a32 = ell_from_csr(a, width_multiple=128,
                           device=dev).astype(torch.float32)
    b32 = torch.from_numpy(np.asarray(b, np.float32)).to(dev)
    timed = _timer(dev)
    got = []

    def solve():
        got.append(cg_solve(a32, b32, tol=0.0, maxiter=iters + 1))

    t_cold = timed(solve)
    t_warm = timed(solve)
    return got[-1].x.detach().cpu().numpy().astype(np.float64), t_cold, \
        t_warm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cgx_torch.bench.reference_full")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--n", type=int, default=52269)
    ap.add_argument("--bands", type=int, default=172)
    ap.add_argument("--format", default="csr", choices=["csr", "ell"])
    ap.add_argument("--ref-dir", default=REF_DIR,
                    help="the reference program's tree (cg.c, mv_ops.c)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the port's solve runs (default cuda; "
                         "without a card it exits non-zero)")
    args = ap.parse_args(argv)

    from cgx_torch.cli import _device
    from cgx_torch.io.legacy import write_legacy
    from cgx_torch.sparse.types import csr_from_scipy

    dev = _device(args)
    if not os.path.exists(os.path.join(args.ref_dir, "cg.c")):
        raise SystemExit(f"reference_full: no reference tree at "
                         f"{args.ref_dir} (cg.c); pass --ref-dir or set "
                         f"CGX_REFERENCE_DIR")
    print(f"[gen] n={args.n} bands={args.bands} ...", file=sys.stderr,
          flush=True)
    s, b = build_full_problem(args.n, args.bands)
    a = csr_from_scipy(s, device=dev)
    print(f"[gen] nnz={a.nnz:,}", file=sys.stderr, flush=True)

    with tempfile.TemporaryDirectory() as d:
        exe = os.path.join(d, "cg_ref_full")
        subprocess.run(
            ["gcc", "-O2", "-o", exe, os.path.join(args.ref_dir, "cg.c"),
             os.path.join(args.ref_dir, "mv_ops.c"), "-I", args.ref_dir,
             "-lm"], check=True, capture_output=True)
        inp = os.path.join(d, "full.txt")
        print("[io] writing legacy 4-line file ...", file=sys.stderr,
              flush=True)
        write_legacy(inp, a, b)
        print(f"[io] {os.path.getsize(inp)/1e6:.0f} MB", file=sys.stderr,
              flush=True)
        t0 = time.perf_counter()
        out = subprocess.run([exe, inp, str(args.iters)], check=True,
                             capture_output=True, text=True).stdout
        t_ref = time.perf_counter() - t0

    def _is_float(t):
        try:
            float(t)
            return True
        except ValueError:
            return False

    x_ref = np.array([float(line.strip()) for line in out.splitlines()
                      if line.startswith("\t") and _is_float(line.strip())])
    if x_ref.shape != (args.n,):
        raise SystemExit(f"reference_full: the C program printed "
                         f"{x_ref.shape[0]} values, expected {args.n}")

    x, t_cold, t_port = solve_full(a, b, args.iters, args.format, dev)
    err = np.max(np.abs(x - x_ref))
    rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    speed = t_ref / t_port
    print(f"[parity] max|dx|={err:.2e} rel={rel:.2e} "
          f"(C prints 6 decimals; fp32 device arithmetic)",
          file=sys.stderr)
    print(f"[time] C={t_ref:.1f}s  cgx_torch={t_port*1e3:.0f}ms "
          f"(first {t_cold:.1f}s)  speedup={speed:.0f}x", file=sys.stderr)
    print(json.dumps({
        "n": args.n, "nnz": int(a.nnz), "iters": args.iters + 1,
        "max_abs_dx": float(err), "rel_dx": float(rel),
        "ref_seconds": round(t_ref, 2),
        "cgx_seconds": round(t_port, 4),
        "speedup": round(speed, 1),
    }))
    return 0 if rel < 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())

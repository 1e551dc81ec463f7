"""Warm per-RHS df64 run through the factory entry point (PyTorch).

Counterpart of :mod:`cgx.bench.df64_rhs`, with its flags and keys: one
operator build (or a load of the ir_df64 ``.npz`` bundle), one first
right-hand side, then ``--rhs`` timed solves of fresh right-hand sides.
The single-RHS form refines over fp32 WBELL inners (K7); ``--multi K``
solves blocks of K right-hand sides through the batched refinement, whose
tier plan runs K8.

Usage::

    python -m cgx_torch.bench.df64_rhs --name thermal2 [--scale 0.1]
        [--rhs 3] [--operator op.npz] [--multi 4] [--chunk 1000]
        [--device cpu]

Prints one JSON line: ``build_s`` (host seconds), ``first_rhs_s``, then
the seconds per right-hand side of the warm solves (CUDA events on the
card, the host clock on the CPU) — what a deployment pays for each one.
Whenever the matrix is at hand (not a loaded bundle), every solve's TRUE
residual is checked in fp64 against ``1.5 · tol``.

``--operator`` names the bundle: loaded when it exists, else written
after the build (single-RHS form).  The batched form builds no bundle, so
``--multi`` with an ``--operator`` that does not exist exits non-zero.
The solves run on the card (``--device cuda``, the default; without a
card the command exits non-zero) or, when asked, on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cgx_torch.bench.df64_rhs")
    ap.add_argument("--name", default="thermal2",
                    help="SuiteSparse target (real file via "
                         "CGX_SUITESPARSE_DIR, else the documented "
                         "stand-in)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--inner-tol", type=float, default=1e-2)
    ap.add_argument("--maxiter", type=int, default=8000)
    ap.add_argument("--rhs", type=int, default=3,
                    help="timed right-hand sides after the first one")
    ap.add_argument("--multi", type=int, default=0, metavar="K",
                    help="solve blocks of K right-hand sides through the "
                         "batched multi-RHS refinement (K8)")
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--operator", default=None, metavar="OP.npz",
                    help="load the WBELL+df64 operator bundle, or write it "
                         "after the build (single-RHS form only)")
    ap.add_argument("--dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solves run (default cuda; without a "
                         "card it exits non-zero)")
    args = ap.parse_args(argv)

    if args.multi and args.operator and not os.path.exists(args.operator):
        raise SystemExit(
            f"df64_rhs: --multi builds no operator bundle, and "
            f"{args.operator} does not exist; build and save it with the "
            f"single-RHS form (without --multi) first")

    import numpy as np
    import torch

    import cgx_torch
    from cgx_torch.bench.suitesparse import _csr64
    from cgx_torch.cli import _device, _timer
    from cgx_torch.ops.df64 import df_to_f64
    from cgx_torch.solve.hp import (make_ir_df64_solver,
                                    make_ir_df64_solver_multi)

    dev = _device(args)

    def build_solver(a_or_none, op_or_none, m):
        if args.multi:
            return make_ir_df64_solver_multi(
                a_or_none, prebuilt=op_or_none, tol=args.tol,
                inner_tol=args.inner_tol, inner_maxiter=args.maxiter,
                inner_chunk=args.chunk, device=dev)
        return make_ir_df64_solver(
            a_or_none, prebuilt=op_or_none, tol=args.tol,
            inner_tol=args.inner_tol, inner_maxiter=args.maxiter,
            preconditioner=m, inner_chunk=args.chunk,
            save_to=None if op_or_none is not None else args.operator,
            inner_format="wbell", device=dev)

    rec = {"matrix": args.name, "tol": args.tol, "chunk": args.chunk,
           "multi_k": args.multi or None}
    t0 = time.perf_counter()
    if args.operator and os.path.exists(args.operator):
        from cgx_torch.io.native_format import load_df64_operator
        op, _ = load_df64_operator(args.operator, device=dev)
        m = cgx_torch.JacobiPrecond(inv_diag=torch.from_numpy(
            (1.0 / op.diag).astype(np.float32)).to(dev))
        solve = build_solver(None, op, m)
        n = op.a_hp.shape[0]
        rec["operator"] = "loaded"
        a64 = None
    else:
        from cgx_torch.io.suitesparse import load_or_standin
        a, standin = load_or_standin(args.name, args.dir, scale=args.scale,
                                     device=dev)
        rec["standin"] = bool(standin)
        rec["n"] = n = a.shape[0]
        rec["nnz"] = int(a.nnz)
        m = cgx_torch.JacobiPrecond(
            inv_diag=(1.0 / a.diagonal()).to(torch.float32))
        solve = build_solver(a, None, m)
        rec["operator"] = args.operator or "in-memory"
        a64 = _csr64(a)
    rec["build_s"] = round(time.perf_counter() - t0, 2)

    rng = np.random.default_rng(0)
    timed = _timer(dev)

    def one_rhs():
        if args.multi:
            return rng.standard_normal((n, args.multi))
        return rng.standard_normal(n)

    def run(b):
        got = []
        dt = timed(lambda: got.append(solve(b)))
        return got[0] + (dt,)

    def check(res, b, info):
        """The TRUE residual of every column in fp64, where the matrix is
        at hand."""
        if a64 is None:
            return
        x = df_to_f64(res.x)
        r = np.atleast_2d((b - a64 @ x).T)
        bn = np.atleast_2d(np.asarray(b).T)
        for rj, bj in zip(r, bn):
            tr = float(np.linalg.norm(rj) / np.linalg.norm(bj))
            if not tr <= 1.5 * args.tol:
                raise RuntimeError(f"df64_rhs: TRUE relres {tr:.3e} above "
                                   f"1.5 * tol ({info})")

    # The first right-hand side; the rest are the warm regime.
    b0 = one_rhs()
    res, info, dt = run(b0)
    rec["first_rhs_s"] = round(dt, 2)
    rec["first_rhs_relres"] = info["relres"]
    rec["outer"] = info["outer"]
    check(res, b0, info)

    per_rhs = []
    relres = []
    for _ in range(args.rhs):
        b = one_rhs()
        res, info, dt = run(b)
        per_rhs.append(round(dt / max(args.multi, 1), 2))
        relres.append(info["relres"])
        check(res, b, info)
    rec["per_rhs_s"] = per_rhs           # per RHS (block time / k)
    rec["warm_rhs_s"] = round(float(np.median(per_rhs)), 2) \
        if per_rhs else None
    rec["relres"] = relres
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

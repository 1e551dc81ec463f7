"""``cgx_torch`` command-line interface: solve / gen / bench / info.

Counterpart of :mod:`cgx.cli`, with its flags and printed lines, over the
port's modules:

    python -m cgx_torch solve --poisson 128x128x128 --format stencil
    python -m cgx_torch solve --input matrix.mtx --precond jacobi
    python -m cgx_torch bench --poisson 128x128x128 --format stencil
    python -m cgx_torch info

``--device`` (``cuda`` by default, or ``cpu``) is where the operators live
and the solves run.  With ``cuda`` and no card a command exits non-zero:
nothing falls back to the CPU.  ``--legacy-compat`` keeps the reference
program's semantics (a fixed count of ``max_iterations + 1`` updates, the
solution dumped as ``\\t%f`` lines).

``solve --devices N`` row-shards the solve over N ranks
(:mod:`cgx_torch.dist`):

* under ``torchrun --nproc-per-node N`` it joins the group the
  environment describes (NCCL on the cards, gloo with ``--device cpu``),
  and rank 0 prints;
* with ``--device cpu`` and no group it spawns N gloo ranks itself
  (:func:`cgx_torch.dist.run_spmd`) and prints rank 0's output;
* with ``--device cuda`` and no group of N it exits non-zero and names
  ``torchrun``: one card cannot hold two NCCL ranks.

The distributed routes are the JAX package's: the fused engines (K3) for a
fused-capable operator, the row-partitioned WBELL engine (K7) for a CSR
source under ``--format wbell|auto``, else the ELL/DIA partition; with
``--accuracy df64`` the df64 refinement across ranks.  ``bench`` prints one
JSON line with the JAX package's keys; the solve and each SpMV are timed
with CUDA events on the card (the host clock on the CPU), and it writes no
file.  ``--stencil-backend`` is accepted for the JAX package's command
lines and changes nothing: a stencil SpMV on the card always runs K1.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np

__all__ = ["main"]

_PRECONDS = {"none": "none", "jacobi": "jacobi",
             "block-jacobi": "block_jacobi", "poly": "poly",
             "ic0-sweep": "ic0_sweep"}


def _torch_dtype(name: str):
    import torch
    return dict(f32=torch.float32, f64=torch.float64,
                bf16=torch.bfloat16)[name]


def _device(args):
    """The command's device; ``cuda`` without a card exits non-zero."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cgx_torch: --device cuda, but no CUDA card is "
                         "available (pass --device cpu to run on the CPU)")
    return torch.device(args.device)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build_matrix(args, dev):
    """Problem setup from flags → (operator, b, n) on ``dev``."""
    import torch

    import cgx_torch

    dtype = _torch_dtype(args.dtype)
    if args.format is None:
        # File inputs default to the auto pick; the generators keep csr.
        args.format = "auto" if args.input else "csr"

    if args.input:
        if args.input.endswith(".npz"):
            from cgx_torch.io.native_format import (load_df64_operator,
                                                    load_matrix, peek_kind)
            if peek_kind(args.input) == "ir_df64":
                op, b = load_df64_operator(args.input, device=dev)
                n = op.a_hp.shape[0]
                if b is None:
                    b = np.ones((n,), np.float64)
                if getattr(args, "accuracy", "fp32") != "df64":
                    print("ir_df64 operator bundle → --accuracy df64",
                          file=sys.stderr)
                    args.accuracy = "df64"
                print("format=ir_df64 (prebuilt bundle)", file=sys.stderr)
                return op, np.asarray(b, np.float64), n
            a, b = load_matrix(args.input, device=dev)
            if b is None:
                b = torch.ones((a.shape[0],), device=dev)
            if not isinstance(a, cgx_torch.WBELLMatrix):
                a = a.astype(dtype)
            elif args.dtype == "f64":
                raise SystemExit(
                    "--input <prebuilt wbell .npz> is fp32 storage; for "
                    "fp64-grade results use --accuracy df64 (WBELL inner "
                    "solves)")
            else:
                print("format=wbell (prebuilt)", file=sys.stderr)
            b = torch.as_tensor(b).to(device=dev, dtype=dtype)
            if not isinstance(a, cgx_torch.WBELLMatrix):
                a = _apply_unstructured_format(args, a, dev)
            return a, b, a.shape[0]
        if args.input.endswith((".mtx", ".mtx.gz")):
            from cgx_torch.io.matrix_market import read_matrix_market
            a = read_matrix_market(args.input, dtype=np.float64, device=dev)
            b = torch.ones((a.shape[0],), device=dev)
        else:
            from cgx_torch.io.legacy import read_legacy
            a, b = read_legacy(args.input, device=dev)
        a = a.astype(dtype)
        b = b.to(dtype)
        a = _apply_unstructured_format(args, a, dev)
        return a, b, a.shape[0]

    dims = [int(d) for d in args.poisson.split("x")]
    from cgx_torch.io import poisson
    if len(dims) == 2:
        gen = {"csr": poisson.poisson2d, "dia": poisson.poisson2d_dia}
    elif len(dims) == 3:
        gen = {"csr": poisson.poisson3d, "dia": poisson.poisson3d_dia}
    else:
        raise SystemExit("--poisson must be NXxNY or NXxNYxNZ")

    if args.format == "stencil":
        a = (cgx_torch.poisson2d_stencil(*dims) if len(dims) == 2
             else cgx_torch.poisson3d_stencil(*dims))
        n = a.shape[0]
        return a, torch.ones((n,), dtype=dtype, device=dev), n

    fmt = args.format if args.format in ("csr", "dia") else "csr"
    a = gen[fmt](*dims, dtype=np.float64, device=dev)
    if args.format == "ell":
        a = cgx_torch.ell_from_csr(a, device=dev)
    elif args.format == "bsr":
        a = cgx_torch.bsr_from_csr(a, args.blocksize)
    a = a.astype(dtype)
    a = _apply_unstructured_format(args, a, dev)
    n = a.shape[0]
    return a, torch.ones((n,), dtype=dtype, device=dev), n


def _apply_unstructured_format(args, a, dev):
    """``--format wbell|auto`` on a CSR source: the WBELL engine (K7) for
    an unstructured matrix.  No change for other formats, for the df64
    path (the refinement builds its own operators) or across ranks (the
    partition builds its own)."""
    import cgx_torch

    if args.format not in ("wbell", "auto") or not hasattr(a, "indptr"):
        return a
    if getattr(args, "accuracy", "fp32") == "df64":
        return a
    if getattr(args, "devices", 1) > 1:
        return a
    if args.dtype == "f64":
        if args.format == "wbell":
            raise SystemExit("--format wbell is fp32 storage; for "
                             "fp64-grade results use --accuracy df64 "
                             "(WBELL inner solves)")
        return a       # auto + f64: keep the exact CSR
    t0 = time.perf_counter()
    if args.format == "wbell":
        try:
            op, fmt = cgx_torch.wbell_from_csr(a, device=dev), "wbell"
        except ValueError as e:
            raise SystemExit(f"--format wbell: {e}")
    else:
        op, fmt = cgx_torch.auto_format(a, device=dev)
    dt = time.perf_counter() - t0
    extra = ""
    if fmt == "wbell":
        extra = (f" build_s={dt:.1f} fill="
                 f"{op.nnz_stored / max(op.nnz, 1):.1f}x")
    print(f"format={fmt}{extra}", file=sys.stderr)
    return op


def _make_precond(args, a):
    if args.precond == "none":
        return None
    import cgx_torch

    if isinstance(a, cgx_torch.WBELLMatrix):
        # The diagonal family, applied in the engine's internal layout.
        if args.precond == "jacobi":
            from cgx_torch.ops.blas import safe_recip
            return cgx_torch.JacobiPrecond(
                inv_diag=a.from_internal(safe_recip(a.diag_internal)))
        if args.precond == "poly":
            return cgx_torch.PolynomialPrecond.from_matrix(
                a, steps=args.poly_steps)
        if args.precond == "block-jacobi":
            return cgx_torch.WBellBlockJacobiPrecond.from_wbell(a)
        raise SystemExit(
            f"--format wbell supports --precond none/jacobi/poly/"
            f"block-jacobi (all internal-layout applies; got "
            f"{args.precond!r})")
    if args.precond == "jacobi":
        return cgx_torch.JacobiPrecond.from_matrix(a)
    if args.precond == "block-jacobi":
        return cgx_torch.BlockJacobiPrecond.from_matrix(a, args.blocksize)
    if args.precond == "ic0":
        return cgx_torch.IC0Precond.from_matrix(a)
    if args.precond == "ic0-sweep":
        return cgx_torch.IC0SweepPrecond.from_matrix(a, nsweeps=args.sweeps)
    if args.precond == "poly":
        return cgx_torch.PolynomialPrecond.from_matrix(a,
                                                       steps=args.poly_steps)
    raise SystemExit(f"unknown preconditioner {args.precond!r}")


def _x_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def cmd_solve(args, mesh=None):
    """``solve``; ``mesh`` is the row mesh of a distributed solve."""
    import torch

    import cgx_torch
    from cgx_torch.solve.hp import IRDF64Operator

    dev = mesh.device if mesh is not None else _device(args)
    a, b, n = _build_matrix(args, dev)
    if getattr(args, "save_operator", None) and args.accuracy != "df64":
        if not isinstance(a, cgx_torch.WBELLMatrix):
            raise SystemExit("--save-operator persists a built WBELL "
                             "operator; pass --format wbell|auto (or "
                             "--accuracy df64 for the full df64 bundle)")
        from cgx_torch.io.native_format import save_matrix
        save_matrix(args.save_operator, a, b)
        print(f"operator saved: {args.save_operator}", file=sys.stderr)
    maxiter = args.maxiter
    tol = args.tol
    if args.legacy_compat:
        tol = 0.0
        maxiter = (maxiter if maxiter is not None else 30) + 1

    if mesh is not None and args.accuracy == "df64":
        # The df64 refinement across ranks: the sharded df64 true residual
        # over K7 inners.
        from cgx_torch.dist.hp import dist_ir_df64_solve
        from cgx_torch.ops.df64 import df_to_f64
        if isinstance(a, IRDF64Operator):
            raise SystemExit("ir_df64 bundles are single-device operator "
                             "state; for --devices>1 rebuild from the "
                             "CSR source (the partition needs the raw "
                             "matrix)")
        if not hasattr(a, "indptr"):
            raise SystemExit("--accuracy df64 needs a CSR-loadable source "
                             "(Matrix Market / legacy / poisson)")
        if args.precond not in ("none", "jacobi"):
            raise SystemExit("--accuracy df64 --devices N supports "
                             "--precond none/jacobi (shard-local WBELL "
                             "inner applies)")
        t0 = time.perf_counter()
        res, info = dist_ir_df64_solve(
            a, _x_numpy(b).astype(np.float64), mesh, tol=tol,
            inner_maxiter=maxiter or 8000, inner_precond=args.precond,
            inner_chunk=2000)
        dt = time.perf_counter() - t0
        x = df_to_f64(res.x)
        print(f"df64 (distributed, {args.devices} shards) outer "
              f"cycles={info['outer']} true_relres={info['relres']:.3e}",
              file=sys.stderr)
    elif mesh is not None:
        res, dt, x = _solve_distributed(args, a, b, n, tol, maxiter, mesh)
    elif args.accuracy == "df64":
        # fp32 inner solves inside a df64 true-residual refinement: TRUE
        # relres <= tol, the reference's double-precision envelope.
        from cgx_torch.ops.df64 import df_to_f64
        from cgx_torch.solve.hp import make_ir_df64_solver
        if isinstance(a, IRDF64Operator):
            if args.precond == "jacobi":
                m = cgx_torch.JacobiPrecond(inv_diag=torch.from_numpy(
                    (1.0 / a.diag).astype(np.float32)).to(dev))
            elif args.precond == "none":
                m = None
            else:
                raise SystemExit("a prebuilt ir_df64 bundle supports "
                                 "--precond none/jacobi (WBELL inner "
                                 "surface)")
            solver = make_ir_df64_solver(
                prebuilt=a, tol=tol, inner_maxiter=maxiter or 8000,
                preconditioner=m, inner_chunk=2000)
        else:
            m = _make_precond(args, a)
            if not hasattr(a, "indptr"):
                raise SystemExit("--accuracy df64 needs a CSR-loadable "
                                 "source (Matrix Market / legacy / "
                                 "poisson) or an ir_df64 .npz bundle")
            inner_fmt = (args.format if args.format in ("wbell", "auto")
                         else "ell")
            try:
                solver = make_ir_df64_solver(
                    a, tol=tol, inner_maxiter=maxiter or 8000,
                    preconditioner=m, inner_format=inner_fmt,
                    inner_chunk=2000,
                    save_to=getattr(args, "save_operator", None),
                    device=dev)
            except ValueError as e:
                raise SystemExit(f"--accuracy df64: {e}")
            if getattr(args, "save_operator", None):
                print(f"operator saved: {args.save_operator}",
                      file=sys.stderr)
        t0 = time.perf_counter()
        res, info = solver(np.asarray(_x_numpy(b), np.float64))
        _sync(dev)
        dt = time.perf_counter() - t0
        x = df_to_f64(res.x)
        print(f"df64 outer cycles={info['outer']} "
              f"true_relres={info['relres']:.3e}", file=sys.stderr)
    else:
        m = _make_precond(args, a)
        backend = cgx_torch.select_backend(a, b, m)
        t0 = time.perf_counter()
        res = cgx_torch.auto_solve(a, b, tol=tol, maxiter=maxiter,
                                   preconditioner=m, backend=backend,
                                   mixed_precision=args.mixed_precision)
        _sync(dev)
        dt = time.perf_counter() - t0
        x = _x_numpy(res.x)

    if args.legacy_compat:
        # print_sparse's value lines: every x entry as \t%f.
        for v in x:
            sys.stdout.write("\t%f\n" % float(v))
    converged = bool(res.converged)
    print(f"iterations={int(res.iterations)} converged={converged} "
          f"residual_norm={float(res.residual_norm):.3e} wall_s={dt:.3f}",
          file=sys.stderr)
    if (not converged and not args.legacy_compat
            and getattr(args, "accuracy", "fp32") != "df64"):
        print("hint: fp32 recurrence did not reach tol — this is the "
              "--accuracy df64 use case (df64 true-residual iterative "
              "refinement over fp32 engine inners reaches TRUE relres "
              "<= tol on κ>=1e7 systems)", file=sys.stderr)
    return 0 if converged or args.legacy_compat else 2


def _solve_distributed(args, a, b, n, tol, maxiter, mesh):
    """``solve --devices N`` by ``--method``: ``auto`` takes the fused
    engines (K3) where the operator supports them, else the partitioned
    solver; ``cg``/``single_reduction``/``pipelined``/``chebyshev`` force
    the partitioned solver's method, ``fused`` the fused engines."""
    import cgx_torch
    from cgx_torch.dist import (dist_cg_solve, dist_fused_cg,
                                dist_fused_supported, gather_rows,
                                partition_csr, partition_dia, unpad_vector)

    dev = mesh.device
    method = args.method
    jacobi = args.precond == "jacobi"
    precond = _PRECONDS.get(args.precond)
    if precond is None:
        raise SystemExit(f"--devices>1 supports --precond none/jacobi/"
                         f"block-jacobi/poly/ic0-sweep (got "
                         f"{args.precond!r})")
    if method == "auto":
        method = ("fused" if dist_fused_supported(a, mesh)
                  and precond in ("none", "jacobi") else "cg")

    if method == "fused":
        if not dist_fused_supported(a, mesh):
            raise SystemExit("--method fused needs a fused-capable stencil "
                             "or wrap-free 7-point DIA (uneven nx is "
                             "padded with decoupled planes automatically)")
        t0 = time.perf_counter()
        res = dist_fused_cg(a, b, mesh, tol=tol, maxiter=maxiter,
                            jacobi=jacobi)
        x = unpad_vector(gather_rows(res.x, mesh), n)
        _sync(dev)
        return res, time.perf_counter() - t0, _x_numpy(x)

    if isinstance(a, cgx_torch.CSRMatrix) and args.format in ("wbell",
                                                              "auto") \
            and precond in ("none", "jacobi", "block_jacobi", "poly"):
        # The row-partitioned WBELL engine: K7 on each shard, the halos
        # moved as group slabs.  Only a failed build takes the CSR
        # partition under --format auto; a failed solve raises.
        from cgx_torch.dist.wbell import dist_wbell_cg_solve, partition_wbell
        try:
            t0 = time.perf_counter()
            part_w = partition_wbell(a, mesh.size)
            build_s = time.perf_counter() - t0
        except ValueError as e:
            if args.format == "wbell":
                raise SystemExit(f"--format wbell: {e}")
            print(f"format=auto: wbell unavailable ({e}); csr partition",
                  file=sys.stderr)
        else:
            print(f"format=wbell (distributed) build_s={build_s:.1f}",
                  file=sys.stderr)
            t0 = time.perf_counter()
            res = dist_wbell_cg_solve(part_w, b, mesh, tol=tol,
                                      maxiter=maxiter,
                                      preconditioner=precond,
                                      poly_steps=args.poly_steps)
            _sync(dev)
            return res, time.perf_counter() - t0, _x_numpy(res.x)

    if isinstance(a, cgx_torch.DIAMatrix):
        part = partition_dia(a, mesh.size)
    elif isinstance(a, cgx_torch.CSRMatrix):
        part = partition_csr(a, mesh.size)
    else:
        raise SystemExit(f"--devices>1 --method {method} supports csr/dia "
                         "sources (use --method fused for stencils)")
    lam = (None, None)
    if method == "chebyshev" and precond == "none":
        lam = cgx_torch.analytic_bounds(a) or (None, None)
    t0 = time.perf_counter()
    res = dist_cg_solve(part, b, mesh, tol=tol, maxiter=maxiter,
                        preconditioner=precond, blocksize=args.blocksize,
                        poly_steps=args.poly_steps, nsweeps=args.sweeps,
                        method=method, lam_min=lam[0], lam_max=lam[1])
    x = unpad_vector(gather_rows(res.x, mesh), n)
    _sync(dev)
    return res, time.perf_counter() - t0, _x_numpy(x)


def _rank_solve(mesh, argv):
    """One spawned rank of ``solve --devices N --device cpu``: the solve on
    ``mesh``, its exit code and printed text returned to the parent."""
    args = _parser().parse_args(argv)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            code = cmd_solve(args, mesh=mesh)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def _solve_on_ranks(args, argv):
    """``solve --devices N``: the torchrun group, N spawned gloo ranks on
    the CPU, or an exit that names torchrun."""
    import torch.distributed as dist

    from cgx_torch.dist import initialize, make_row_mesh, run_spmd

    n = args.devices
    _device(args)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        initialize(device=args.device)
        mesh = make_row_mesh(device=None if args.device == "cuda"
                             else "cpu")
        if mesh.size != n:
            raise SystemExit(f"--devices {n}, but the process group has "
                             f"{mesh.size} ranks")
        if mesh.rank == 0:
            return cmd_solve(args, mesh=mesh)
        with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
            return cmd_solve(args, mesh=mesh)
    if args.device != "cpu":
        raise SystemExit(
            f"--devices {n} on cuda needs a group of {n} ranks, one card "
            f"each (NCCL refuses two ranks on one card): run "
            f"`torchrun --nproc-per-node {n} -m cgx_torch solve ...`, or "
            f"pass --device cpu to spawn {n} gloo ranks")
    code, out, err = run_spmd(_rank_solve, n, argv)[0]
    sys.stdout.write(out)
    sys.stderr.write(err)
    if isinstance(code, int) or code is None:
        return code or 0
    raise SystemExit(code)


def cmd_gen(args):
    from cgx_torch.io import poisson
    dims = [int(d) for d in args.poisson.split("x")]
    if len(dims) == 2:
        a = poisson.poisson2d(*dims, device="cpu")
    elif len(dims) == 3:
        a = poisson.poisson3d(*dims, device="cpu")
    else:
        raise SystemExit("--poisson must be NXxNY or NXxNYxNZ")
    n = a.shape[0]
    b = np.random.default_rng(args.seed).standard_normal(n)
    if args.out.endswith(".mtx"):
        from cgx_torch.io.matrix_market import write_matrix_market
        write_matrix_market(args.out, a)
    else:
        from cgx_torch.io.legacy import write_legacy
        write_legacy(args.out, a, b)
    print(f"wrote {args.out}: n={n} nnz={a.nnz}", file=sys.stderr)
    return 0


def _timer(dev):
    """``timed(fn) -> seconds`` of one call: CUDA events on the card, the
    host clock (after the call returns) on the CPU."""
    import torch

    if dev.type == "cuda":
        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        return timed

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return timed


def cmd_bench(args):
    """One configuration: the solve to tol (best of ``--reps``) and the
    SpMV (median of 20 calls, each timed alone), as one JSON line."""
    import cgx_torch
    from cgx_torch.solve.hp import IRDF64Operator

    dev = _device(args)
    a, b, n = _build_matrix(args, dev)
    if isinstance(a, IRDF64Operator):
        raise SystemExit("cgx_torch bench does not take ir_df64 bundles; "
                         "use `python -m cgx_torch solve --input "
                         "bundle.npz` or python -m cgx_torch.bench.df64_rhs")
    m = _make_precond(args, a)
    backend = cgx_torch.select_backend(a, b, m)

    def solve():
        return cgx_torch.auto_solve(a, b, tol=args.tol,
                                    maxiter=args.maxiter or 2 * n,
                                    preconditioner=m, backend=backend)

    timed = _timer(dev)
    res = solve()
    _sync(dev)
    best = min(timed(solve) for _ in range(args.reps))

    # WBELL's SpMV acts on the internal layout: the transform happens once,
    # outside the timed calls, where solves pay it too.
    xl = a.to_internal(b) if isinstance(a, cgx_torch.WBELLMatrix) else b
    cgx_torch.spmv(a, xl)
    t_spmv = statistics.median(timed(lambda: cgx_torch.spmv(a, xl))
                               for _ in range(20))
    nnz = _nnz(a)
    print(json.dumps({
        "n": n, "nnz": nnz, "format": type(a).__name__,
        "path": backend,
        "dtype": args.dtype, "precond": args.precond,
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
        "solve_ms": round(best * 1e3, 3),
        "spmv_us": round(t_spmv * 1e6, 2),
        "spmv_gnnz_s": round(nnz / t_spmv / 1e9, 3),
        "device": dev.type,
    }))
    return 0


def _nnz(a) -> int:
    import cgx_torch
    from cgx_torch.sparse.stencil import GeneralStencil3D

    if isinstance(a, GeneralStencil3D):
        return sum((a.nx - abs(dx)) * (a.ny - abs(dy)) * (a.nz - abs(dz))
                   for (dx, dy, dz) in a.taps)
    if isinstance(a, cgx_torch.Stencil2D):
        return 5 * a.shape[0] - 2 * (a.nx + a.ny)
    if isinstance(a, cgx_torch.Stencil3D):
        return (7 * a.shape[0]
                - 2 * (a.nx * a.ny + a.ny * a.nz + a.nx * a.nz))
    if isinstance(a, cgx_torch.DIAMatrix):
        return int(_x_numpy(a.data.count_nonzero()))
    if isinstance(a, cgx_torch.ELLMatrix):
        return int(_x_numpy(a.values.count_nonzero()))
    if isinstance(a, cgx_torch.BSRMatrix):
        return int(a.nnzb) * a.blocksize ** 2
    return int(a.nnz)


def cmd_info(args):
    """Versions, the card's name and power limit, and the toolchain."""
    import subprocess

    import torch

    import cgx_torch
    from cgx_torch.kernels import _build

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"cgx_torch {cgx_torch.__version__}")
    if torch.cuda.is_available():
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            card = f"nvidia-smi unavailable ({e})"
        print(f"devices: {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    else:
        print("devices: no CUDA card")
    print(f"toolchain: {json.dumps(_build.probe())}")
    _device(args)
    return 0


def _add_problem_flags(p):
    p.add_argument("--input", help="input file (.mtx[.gz], .npz or legacy "
                                   "4-line)")
    p.add_argument("--poisson", default="64x64",
                   help="synthetic Poisson dims, e.g. 128x128 or 64x64x64")
    p.add_argument("--format", default=None,
                   choices=["csr", "dia", "ell", "bsr", "stencil",
                            "wbell", "auto"],
                   help="operator storage; wbell = the windowed block-ELL "
                        "engine (K7) for unstructured matrices; auto = "
                        "cgx_torch.auto_format's pick.  Default: auto for "
                        "--input files, csr for --poisson")
    p.add_argument("--stencil-backend", default="xla",
                   choices=["xla", "pallas"],
                   help="ignored: accepted only so that the JAX "
                        "package's command lines parse; a stencil SpMV on "
                        "the card always runs K1")
    p.add_argument("--blocksize", type=int, default=8)
    p.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"])
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--precond", default="none",
                   choices=["none", "jacobi", "block-jacobi", "ic0",
                            "ic0-sweep", "poly"])
    p.add_argument("--poly-steps", type=int, default=3)
    p.add_argument("--sweeps", type=int, default=1,
                   help="Neumann sweeps per triangular solve (ic0-sweep)")
    _add_device_flag(p)


def _add_device_flag(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solve runs (default cuda; without a "
                        "card it exits non-zero)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="cgx_torch",
        description="conjugate-gradient framework for NVIDIA Hopper "
                    "(PyTorch / CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="solve A x = b")
    _add_problem_flags(ps)
    ps.add_argument("--devices", type=int, default=1,
                    help="row-shard the solve over N ranks (torchrun on "
                         "cards; spawned gloo ranks with --device cpu)")
    ps.add_argument("--method", default="auto",
                    choices=["auto", "cg", "single_reduction", "pipelined",
                             "fused", "chebyshev"],
                    help="distributed solver method (with --devices>1)")
    ps.add_argument("--legacy-compat", action="store_true",
                    help="reference semantics: fixed iters, \\t%%f dump")
    ps.add_argument("--accuracy", default="fp32",
                    choices=["fp32", "df64"],
                    help="df64: double-word fp32 iterative refinement to "
                         "TRUE relres <= tol")
    ps.add_argument("--mixed-precision", action="store_true",
                    help="bf16-inner iterative refinement (fp32-accurate "
                         "result)")
    ps.add_argument("--save-operator", default=None, metavar="OP.npz",
                    help="after building a WBELL operator, persist it so "
                         "later runs (--input OP.npz) skip the host build")
    ps.set_defaults(fn=cmd_solve)

    pg = sub.add_parser("gen", help="generate a problem file")
    pg.add_argument("--poisson", default="64x64")
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--out", required=True)
    pg.set_defaults(fn=cmd_gen)

    pb = sub.add_parser("bench", help="benchmark one config (JSON line)")
    _add_problem_flags(pb)
    pb.add_argument("--reps", type=int, default=5)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="device / version info")
    _add_device_flag(pi)
    pi.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.cmd == "solve" and args.devices > 1:
        return _solve_on_ranks(args, argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Drive the cgx_torch main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero, and no result line is printed):

1. device: the card's name and power limit, the toolchain probe;
2. build: compile the CUDA kernels from ``cgx_torch/csrc`` with nvcc;
3. K1 (stencil SpMV) against its plain PyTorch version at 128³ and at a
   ragged 37×41×53;
4. the main path as a user drives it: three right-hand sides at 128³ and
   one at 224³ through ``cgx_torch.auto_solve`` (routed to the whole-solve
   kernel K2), each answer checked with ``cgx_torch.spmv`` (K1); the
   kernels' launch counters are read around this phase only.  Then each
   solve is held against K2's plain version on the same card and against
   an fp64 solve of the same system, and K2 is run twice to show it is
   bit-reproducible;
5. times (CUDA events, median of interleaved repetitions) of both kernels
   and their plain versions;
6. the Jacobi-PCG path over variable-coefficient DIA operators: DIA-7, a
   7-point D·A·D at 192³ (D ~ U[0.5, 2) from seed 0), and DIA-27,
   ``poisson3d_dia27(128, 128, 128, variable=True, seed=0)``, each with
   b = ones and a seeded random b, through ``auto_solve(a, b,
   preconditioner=JacobiPrecond.from_matrix(a))``, routed to
   ``"resident_dia"`` (K2 in planes/weight mode, one launch per solve);
7. the history path: ``track_history=True`` on DIA-7 (``"fused_dia"``)
   and on the 224³ stencil (``"fused_stencil"``), which run the two-pass
   engine K3 (kernels A and B);
8. each solve of 6 and 7 held against its plain version on the card and
   against an fp64 Jacobi-PCG solve of the same system; K2's planes mode
   and K3 run twice to show they are bit-reproducible; K3's kernels A and
   B each held against their plain versions for one step;
9. times of K2's planes mode, of K3 and of K3's two kernels, each beside
   its plain version (and K3 A beside torch's CSR product of Ã), and K2's
   constant mode beside K3 at 224³;
10. W1, the unstructured path's build: the thermal2 stand-in at full size
    (``standin("thermal2")``, 1,228,045 rows, seed 0) through
    ``auto_format``, which must choose WBELL, and its tier plan;
11. W2, the WBELL kernels K7 (k = 1 and 4), K9 (k = 1) and K8 (k = 4) on
    seeded operands, each held against its plain version, against an
    fp64 CSR product through the permutation, and against a second run;
12. W3, the path as a user drives it: ``auto_solve(op, b, tol=1e-6,
    maxiter=8000, preconditioner=...)`` with Jacobi (b = ones and a seeded
    b), none, ``PolynomialPrecond`` and ``"block_jacobi"``, each answer
    checked through K9 (``wbell_spmv(..., backend="windowed")``) and in
    fp64 through the CSR; the Jacobi b = ones solve held against the same
    solve over K7's plain version;
13. W4, multi-RHS: ``auto_solve(op, B)`` with B (n, 4) under Jacobi (K8),
    each column against a single-RHS solve of it;
14. W5, times: K7, K8 and K9 beside their plain versions and beside
    torch's CSR product of the same matrix, and µs per iteration of the
    Jacobi solve;
15. M1, the multi-RHS engine K5: kernels A and B one step each against
    their plain versions at DIA-27 160³ (``poisson3d_dia27(160, 160, 160,
    variable=True, seed=0)`` under Jacobi, 13 symmetric planes) and at the
    224³ stencil, k = 4 seeded columns; each column's q against K3 A's;
16. M2 and M3, the path as a user drives it: ``auto_solve(a, B)`` with B
    (n, 4) seeded, on DIA-27 160³ with ``JacobiPrecond`` and on the 224³
    stencil (K5 alone), each column against an fp64 solve and its
    single-RHS K3 solve, twice for reproducibility, and against the same
    solve through K5's plain versions;
17. M4, the narrow-band route: DIA-7 192³ with B (n, 4) under Jacobi runs
    K3 per column, each column equal to ``fused_dia_cg`` bit for bit;
18. M5, the batched loop below ``FUSED_MIN_ROWS`` (DIA-27 128³, B (n, 4),
    Jacobi; no kernel), each column against its own ``cg_solve``; then
    ``block_cg_solve`` on the 64³ stencil with 8 clustered right-hand
    sides against single CG;
19. M6, times: K5 per iteration beside the four sequential K3 solves of
    the same B (at DIA-27 160³, the 224³ stencil and the narrow-band DIA-7
    192³ of M4, which ``auto`` sends to K3), the profiler's device time of K5 A and B, one call of each
    beside its plain version and bound, and the PyTorch calls that compute
    K5 A's product (the CSR product of Ã, conv3d with batch 4);
20. B1, the block-ELL SpMM K11 (``cgx_torch.kernels.bell_spmm``) on the
    JAX package's block-dense record (512 block rows of 8 distinct seeded
    64×64 fp32 blocks, X (32768, k)) at k = 256 and 512, engines
    ``"auto"`` and ``"dma"``: against its plain version and a numpy fp64
    product (1e-5 · max|y|), twice for reproducibility;
21. B2, bf16 operands at 1024 block rows, k = 256 (float32 out): against
    its plain version and, within 3e-2 in the 2-norm, the fp32 product;
22. B3, ``poisson3d(128, 128, 128)`` in fp32 through ``bsr_from_csr(·,
    8)`` and ``bell_from_bsr``: ``bell_spmv`` (k = 1) and ``bell_spmm``
    (k = 4) against the CSR ``spmv``/``spmm``;
23. B4, the path as a user drives it (no kernel): ``auto_solve`` over the
    BSR and COO forms of ``poisson3d(64, 64, 64)`` (route ``"xla"``)
    against an fp64 solve and the CSR solve's count, ``cg_solve_multi``
    over the BSR with B (n, 4) against each column's solve, and the
    legacy 4-line file of ``poisson2d(256, 256)`` written, read back equal,
    and solved (``tol=0``, 50 updates, fp64) on the card against the CPU;
24. B5, times: K11 in B1–B3 beside its plain version, its bound and
    torch's BSR product (B3 also beside torch's CSR product);
25. X1, mixed precision as a user drives it: ``auto_solve(
    poisson3d_stencil(224, 224, 224), b, mixed_precision=True)`` with b =
    ones and a seeded b, routed to ``ir_cg_solve`` with K3 in bf16 vectors
    (the outer residual from fp32 K3 A, no K2); each answer held against
    the same ``ir_cg_solve`` through the plain versions and against an
    fp64 solve (forward error ≤ 1e-4; the seeded b's fp64 true relres),
    and K3 A and B in bf16 one step each against their plain versions, bit
    for bit;
26. X2, the same on DIA-27 160³ and DIA-7 192³ with ``JacobiPrecond``:
    ``bf16_plane_speedup`` chooses the plane mode (bf16 planes, fp32
    vectors), and K3 A in it equals its plain version and fp32 K3 A on the
    planes rounded through bf16, bit for bit;
27. X3, K2 with bf16 planes (``resident_dia_cg(plane_dtype=bf16)``) at
    DIA-27 128³ (to tol) and DIA-7 192³ (100 iterations: its rounded
    operator is indefinite and the solve breaks down): equal to fp32 K2 on
    the pre-rounded planes bit for bit at one grid (the smaller of the two
    instances'), and at DIA-27 to its plain version within K2's bounds;
28. X4, ``fused_dia_cg_multi(DIA-27 160³, B (n, 4), plane_dtype=bf16)``:
    each column equal to fp32 K5 on the pre-rounded planes bit for bit;
29. X5, times: each narrow mode per iteration beside its fp32 mode, its
    plain version and its bound (2 B per bf16 value), the profiler's
    device time per launch, the PyTorch calls computing the same products
    (bf16 conv3d, the CSR product of Ã with bf16-rounded values), IR per
    inner iteration beside the fp32 K3 and K2 solves, and the measured
    fp32/bf16-plane ratio beside ``bf16_plane_speedup``'s prediction (the
    TPU model) at DIA-7 192³, DIA-27 128³ and DIA-27 160³.

The launch counters are set to 0 just before each of the paths 4, 6, 7,
W3–W4, M2–M5, B1–B4 and X1–X4 and read just after it.  The line before the last
is a JSON object describing each kernel, with its bound (the larger of
its bytes, each input read once and each output written once, over 3.35
TB/s, and its operations over 67 TFLOP/s fp32, or 989 TFLOP/s on the
tensor cores for bf16 operands) and the time of one PyTorch call that
computes the same function where there is one; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; it imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
N128 = (128, 128, 128)
N224 = (224, 224, 224)
N192 = (192, 192, 192)
N160 = (160, 160, 160)
K_MULTI = 4               # right-hand sides of the multi-RHS phases
TOL = 1e-6
JAX_ITERS_ONES_128 = 300  # the JAX package's count (BENCH_r05.json)
MAXIT_HIST = 5000         # maxiter of the history solves
# The JAX package's iteration counts on the thermal2 stand-in to 1e-6 on
# the TPU (BASELINE.md:120,163): a trajectory fact, not a speed figure.
TPU_ITERS_THERMAL2 = {"none": 5543, "jacobi": 3466}
MAXIT_WBELL = 8000
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores, dense bf16 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# The block-sparse phases: the JAX package's block-dense records
# (BASELINE.md:79-80, docs/PERF_NOTES.md round 5g), bs 64 and wb 8.
BELL_BS = 64
BELL_WB = 8
BELL_ROWS = {"B1": 512, "B2": 1024}   # block rows
N64 = (64, 64, 64)                   # B4's solves
LEGACY_2D = (256, 256)               # B4's legacy file


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    """``(ms, "bytes" | "operations")``: the least time the card could
    take for the work, the larger of the two (operations at ``peak``)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip() != "",
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def event_ms(fn, inner: int = 1) -> float:
    """ms per call of ``fn`` over ``inner`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def time_pair(kernel, plain, reps: int = 7, inner: int = 1):
    """Median ms per call of ``kernel`` and ``plain``, interleaved."""
    def once(fn):
        return event_ms(fn, inner)

    kernel()
    plain()
    torch.cuda.synchronize()
    tk, tp = [], []
    for i in range(reps):
        # plain, kernel, kernel, plain, ...
        if i % 2 == 0:
            tp.append(once(plain))
            tk.append(once(kernel))
        else:
            tk.append(once(kernel))
            tp.append(once(plain))
    return statistics.median(tk), statistics.median(tp)


def rhs_set(dims, dev):
    """The right-hand sides of the main path: ones (as bench.py), a seeded
    random one, and a smooth one."""
    nx, ny, nz = dims
    n = nx * ny * nz
    rng = np.random.default_rng(SEED)
    ix = (np.arange(1, nx + 1) / (nx + 1))
    iy = (np.arange(1, ny + 1) / (ny + 1))
    iz = (np.arange(1, nz + 1) / (nz + 1))
    smooth = np.einsum("i,j,k->ijk", ix * (1 - ix), iy * (1 - iy),
                       iz * (1 - iz)).reshape(-1)
    return {
        "ones": torch.ones(n, dtype=torch.float32, device=dev),
        "random": torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).to(dev),
        "smooth": torch.from_numpy(smooth.astype(np.float32)).to(dev),
    }


def true_relres(a, b, x) -> float:
    """‖b − A·x‖/‖b‖ in fp64 with the plain operator."""
    b64, x64 = b.double(), x.double()
    r = b64 - a.matvec(x64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def rel(u, v) -> float:
    """‖u − v‖/‖v‖ (fp64)."""
    u, v = u.double(), v.double()
    return float(torch.linalg.vector_norm(u - v) / torch.linalg.vector_norm(v))


def scaled_dia7(dims, dev):
    """DIA-7: D·A·D of the 7-point Poisson DIA with D ~ U[0.5, 2) from
    SEED (the construction of tests/test_kernels.py:161-174), fp32."""
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


def hold(label, x, its, x_ref, its_ref, relres, relres_ref, fwd, fwd_ref):
    """The bounds every kernel solve is held to against its plain version
    (x_ref, its_ref, relres_ref) and an fp64 solve (fwd = forward error).
    Where the plain version itself misses the forward-error bound, the
    kernel is held to 1.5× the plain version's and a note is printed."""
    dx = rel(x, x_ref)
    print(f"{label}: iterations {its} (plain {its_ref}), true relres (fp64) "
          f"{relres:.3e} (plain {relres_ref:.3e}), |x-x_plain|/|x_plain| "
          f"{dx:.3e}, |x-x64|/|x64| {fwd:.3e} (plain {fwd_ref:.3e})")
    check(abs(its - its_ref) <= 2,
          f"{label}: {its} vs plain {its_ref} iterations")
    check(dx <= 1e-4, f"{label}: x differs from the plain version by {dx}")
    check(relres <= 1.5 * relres_ref,
          f"{label}: true relres {relres} vs plain {relres_ref}")
    bound = 1e-4
    if fwd_ref > 1e-4:
        bound = 1.5 * fwd_ref
        print(f"{label}: the plain version's forward error {fwd_ref:.3e} "
              f"exceeds 1e-4; the kernel is held to 1.5x it")
    check(fwd <= bound, f"{label}: forward error {fwd} (bound {bound})")
    return dx


def maxrel(y, ref) -> float:
    """Max-norm relative difference (fp64)."""
    y, ref = y.double(), ref.double()
    return float((y - ref).abs().max() / ref.abs().max())


def wbell_phases(dev, card):
    """W1–W5: the unstructured path at the thermal2 stand-in's full size.
    Returns the kernels' entries of the report line."""
    import cgx_torch
    from cgx_torch.io.suitesparse import standin
    from cgx_torch.kernels import wbell as kw

    # -- W1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    a = standin("thermal2", seed=SEED)
    t_standin = time.perf_counter() - t0
    n = a.shape[0]
    t0 = time.perf_counter()
    op, fmt = cgx_torch.auto_format(a)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(fmt == "wbell", f"auto_format chose {fmt!r} for thermal2")
    t0 = time.perf_counter()
    plan = kw.build_tier_plan(op)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    kept7 = int(op.resident_walk[0].numel())
    kept8 = int(plan.walk[0].numel())
    n_planes = int(op.values.shape[0])
    print(f"W1 thermal2 stand-in: {n} rows, {a.nnz} nnz, built in "
          f"{t_standin:.1f} s; auto_format -> {fmt} in {t_build:.1f} s: "
          f"{n_planes} planes ({kept7} non-zero), nt {op.nt}, ngw "
          f"{op.ngw}, span {op.span}, wbcap {op.wbcap}, "
          f"{op.outg.shape[0]} virtual tiles, fill "
          f"{op.nnz_stored / a.nnz:.2f}x, planes + lc "
          f"{n_planes * 65 * 128 * 4 / 1e6:.1f} MB; tier plan in "
          f"{t_plan:.1f} s, steps {plan.steps} x {plan.splane}")

    # -- W2. the kernels against their plain versions ----------------------
    rng = np.random.default_rng(SEED)
    xs = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)).to(
        dev)
    xi = torch.stack([op.to_internal(xs[:, c]) for c in range(4)])
    a64 = torch.sparse_csr_tensor(a.indptr, a.col_indices, a.values.double(),
                                  size=a.shape, check_invariants=False)
    y64 = a64 @ xs.double()
    cases = {
        "K7 k=1": (lambda: kw.wbell_spmm(op, xi[:1]),
                   lambda: kw.wbell_resident_reference(op, xi[:1]), 1),
        "K7 k=4": (lambda: kw.wbell_spmm(op, xi),
                   lambda: kw.wbell_resident_reference(op, xi), 4),
        "K9 k=1": (lambda: kw.wbell_spmm(op, xi[:1], backend="windowed"),
                   lambda: kw.wbell_windowed_reference(op, xi[:1]), 1),
        "K8 k=4": (lambda: kw.wbell_spmm_tiered(plan, xi),
                   lambda: kw.wbell_tiered_reference(plan, xi), 4),
    }
    errs = {}
    for label, (run, plain, k) in cases.items():
        y = run()
        torch.cuda.synchronize()
        y_ref = plain()
        again = run()
        torch.cuda.synchronize()
        e_plain = maxrel(y, y_ref)
        y_std = torch.stack([op.from_internal(y[c]) for c in range(k)], 1)
        e64 = maxrel(y_std, y64[:, :k])
        errs[label] = float((y - y_ref).abs().max())
        print(f"W2 {label}: max|y - plain| / max|plain| {e_plain:.3e} "
              f"(bitwise equal: {torch.equal(y, y_ref)}), vs fp64 CSR "
              f"{e64:.3e}, two runs bitwise equal: {torch.equal(y, again)}")
        check(e_plain <= 1e-5, f"{label} disagrees with its plain version")
        check(e64 <= 1e-5, f"{label} disagrees with the fp64 CSR product")
        check(torch.equal(y, again), f"{label}: two runs differ")

    # -- W3. the path as a user drives it -----------------------------------
    b_ones = torch.ones(n, dtype=torch.float32, device=dev)
    b_rand = torch.from_numpy(np.random.default_rng(SEED + 1)
                              .standard_normal(n).astype(np.float32)).to(dev)
    jac = cgx_torch.JacobiPrecond.from_matrix(a.astype(torch.float32))
    poly = cgx_torch.PolynomialPrecond.from_matrix(op)
    solves = [("jacobi", "ones", jac, b_ones), ("jacobi", "random", jac,
                                                 b_rand),
              ("none", "ones", None, b_ones), ("poly", "ones", poly, b_ones),
              ("block_jacobi", "ones", "block_jacobi", b_ones)]

    def relres64(b, x):
        r = b.double() - (a64 @ x.double()[:, None])[:, 0]
        return float(torch.linalg.vector_norm(r)
                     / torch.linalg.vector_norm(b.double()))

    kw.wbell_resident_launches = kw.wbell_tiered_launches = 0
    kw.wbell_windowed_launches = 0
    results = {}
    for name, bn, m, b in solves:
        route = cgx_torch.select_backend(op, b, m)
        check(route == "wbell", f"thermal2 {name} routed to {route}")
        before = kw.wbell_resident_launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = cgx_torch.auto_solve(op, b, tol=TOL, maxiter=MAXIT_WBELL,
                                   preconditioner=m)
        end.record()
        end.synchronize()
        its = int(res.iterations)
        spmvs = kw.wbell_resident_launches - before
        want = 3 * its + 2 if name == "poly" else its
        # The answer checked as a user checks it: the residual through K9.
        r32 = op.to_internal(b) - kw.wbell_spmv(op, op.to_internal(res.x),
                                                backend="windowed")
        rel32 = float(torch.linalg.vector_norm(r32)
                      / torch.linalg.vector_norm(b))
        rr64 = relres64(b, res.x)
        results[name, bn] = (res, its, rr64, start.elapsed_time(end))
        tpu = TPU_ITERS_THERMAL2.get(name)
        print(f"W3 {name} b={bn}: {its} iterations"
              + (f" (the JAX package on the TPU: {tpu})" if tpu and bn ==
                 "ones" else "")
              + f", converged {bool(res.converged)}, {spmvs} K7 launches, "
              f"true relres (fp64) {rr64:.3e}, relres via K9 (fp32) "
              f"{rel32:.3e}, {start.elapsed_time(end):.1f} ms")
        check(bool(res.converged), f"thermal2 {name} b={bn} did not converge")
        check(spmvs == want, f"{name}: {spmvs} K7 launches for {want} SpMVs")

    # The Jacobi b = ones solve over K7's plain version, on the card.
    res, its, rr64, _ = results["jacobi", "ones"]
    idi = op.to_internal(jac.inv_diag)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = cgx_torch.cg_solve(
        lambda v: kw.wbell_resident_reference(op, v[None])[0],
        op.to_internal(b_ones), tol=TOL, maxiter=MAXIT_WBELL,
        preconditioner=lambda r: r * idi)
    end.record()
    end.synchronize()
    plain_solve_ms = start.elapsed_time(end)
    its_ref = int(ref.iterations)
    x_ref = op.from_internal(ref.x)
    rr64_ref = relres64(b_ones, x_ref)
    # The fp64 Jacobi-PCG solution of the same system, for the forward
    # error (torch's fp64 CSR product as the operator).
    sol64 = cgx_torch.cg_solve(
        lambda v: (a64 @ v[:, None])[:, 0], b_ones.double(), tol=1e-10,
        maxiter=40000, track_history=True,
        preconditioner=cgx_torch.JacobiPrecond(jac.inv_diag.double()))
    x64 = sol64.x
    k64 = int(torch.nonzero(sol64.history <= TOL ** 2 * n)[0, 0])
    fwd, fwd_ref = rel(res.x, x64), rel(x_ref, x64)
    print(f"W3 jacobi b=ones against the plain version: {its} vs {its_ref} "
          f"iterations, true relres {rr64:.3e} vs {rr64_ref:.3e}, x bitwise "
          f"equal: {torch.equal(res.x, x_ref)}; |x-x64|/|x64| {fwd:.3e} "
          f"(plain {fwd_ref:.3e}); the fp64 Jacobi-PCG recurrence reaches "
          f"1e-6 at iteration {k64}")
    check(abs(its - its_ref) <= 0.03 * its_ref, "jacobi: iterations differ "
          "from the plain version's by more than 3 %")
    check(rr64 <= 2 * rr64_ref, f"jacobi: true relres {rr64} (plain "
          f"{rr64_ref})")
    # At b = ones the solution is large and smooth, and b - A·x of its fp32
    # copy cancels: the true relres sits near 0.8 for the kernel and the
    # plain version alike (0.774 on an H100).  The answer is held by
    # its forward error against the fp64 solve instead, and the 2e-3 bound
    # on the true relres by the seeded b, whose solution fp32 holds.
    check(fwd <= 1e-4, f"jacobi b=ones: forward error {fwd}")
    rr_rand = results["jacobi", "random"][2]
    check(rr_rand <= 2e-3, f"jacobi b=random: true relres {rr_rand}")

    # -- W4. multi-RHS --------------------------------------------------------
    B = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (n, 4)).astype(np.float32)).to(dev)
    before = kw.wbell_tiered_launches
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    multi = cgx_torch.auto_solve(op, B, tol=TOL, maxiter=MAXIT_WBELL,
                                 preconditioner=jac)
    end.record()
    end.synchronize()
    k8_spmms = kw.wbell_tiered_launches - before
    its_m = [int(v) for v in multi.iterations]
    print(f"W4 multi-RHS k=4 (Jacobi, K8): iterations {its_m}, {k8_spmms} "
          f"K8 launches, {start.elapsed_time(end):.1f} ms")
    check(k8_spmms == max(its_m), "W4 did not run K8 once per iteration")
    for j in range(4):
        one = cgx_torch.auto_solve(op, B[:, j].contiguous(), tol=TOL,
                                   maxiter=MAXIT_WBELL, preconditioner=jac)
        its1 = int(one.iterations)
        print(f"W4 column {j}: {its_m[j]} iterations, single-RHS {its1}, "
              f"converged {bool(multi.converged[j])}, x equal to the "
              f"single solve's: {torch.equal(one.x, multi.x[:, j])}, true "
              f"relres {relres64(B[:, j], multi.x[:, j]):.3e}")
        check(bool(multi.converged[j]), f"W4 column {j} did not converge")
        check(abs(its_m[j] - its1) <= 0.03 * its1,
              f"W4 column {j}: {its_m[j]} vs {its1} iterations")
    launches = {"k7": kw.wbell_resident_launches,
                "k8": kw.wbell_tiered_launches,
                "k9": kw.wbell_windowed_launches}
    print(f"W3-W4 launches: K7 {launches['k7']}, K8 {launches['k8']}, K9 "
          f"{launches['k9']}")
    check(min(launches.values()) > 0, f"a WBELL kernel did not run on the "
          f"path: {launches}")

    # -- W5. times ------------------------------------------------------------
    a32 = torch.sparse_csr_tensor(a.indptr, a.col_indices,
                                  a.values.float(), size=a.shape,
                                  check_invariants=False)
    x1, x4 = xs[:, 0].contiguous(), xs
    ms = {}
    for label, (run, plain, k) in cases.items():
        ms[label] = time_pair(run, plain, reps=5, inner=10)
    csr1 = time_pair(lambda: a32 @ x1, lambda: a32 @ x1, reps=5, inner=10)[0]
    csr4 = time_pair(lambda: a32 @ x4, lambda: a32 @ x4, reps=5, inner=10)[0]
    for label, (t_k, t_p) in ms.items():
        print(f"[{card}] W5 {label}: {t_k * 1e3:.1f} us (plain "
              f"{t_p * 1e3:.1f} us); torch CSR product "
              f"{(csr1 if label.endswith('1') else csr4) * 1e3:.1f} us")
    its_j = results["jacobi", "ones"][1]
    t_solve = statistics.median(
        event_ms(lambda: cgx_torch.auto_solve(
            op, b_ones, tol=TOL, maxiter=MAXIT_WBELL, preconditioner=jac))
        for _ in range(3))
    print(f"[{card}] W5 Jacobi b=ones: {t_solve:.1f} ms/solve, "
          f"{t_solve / its_j * 1e3:.1f} us/iter ({its_j} it); over the plain "
          f"version {plain_solve_ms:.1f} ms, "
          f"{plain_solve_ms / its_ref * 1e3:.1f} us/iter ({its_ref} it)")

    # Where the solve's time goes: the kernels' own device time under
    # torch.profiler (CUDA activity only: recording the host's ops slows the
    # host-bound loop several-fold), against the unprofiled solve's event
    # time above, which runs the same bitwise trajectory.
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cgx_torch.auto_solve(op, b_ones, tol=TOL, maxiter=MAXIT_WBELL,
                             preconditioner=jac)
        torch.cuda.synchronize()
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.self_device_time_total > 0}
    busy = sum(dev_us.values())
    k7_us = sum(v for k, v in dev_us.items() if "wbell" in k)
    others = sorted(((round(v / 1e3, 1), k[:40]) for k, v in dev_us.items()
                     if "wbell" not in k), reverse=True)[:6]
    if busy == 0:
        print("W5 profiler: no device time recorded (times above are from "
              "CUDA events)")
    else:
        print(f"[{card}] W5 profiler, one Jacobi b=ones solve: device busy "
              f"{busy / 1e3:.1f} ms of the {t_solve:.1f} ms solve (idle "
              f"share {1 - busy / 1e3 / t_solve:.1%}), K7 "
              f"{k7_us / 1e3:.1f} ms ({k7_us / busy:.1%} of device time, "
              f"{k7_us / its_j:.1f} us/launch); other kernels (ms) "
              f"{others}")

    def stream_bytes(kept, k):
        # Kept planes (values + lc) and their indices, x in and y out.
        return kept * (65 * 128 * 4 + 8) + 2 * k * op.nt * 1024 * 4

    entries = []
    for name, label, key, src, kept, k, csr in (
            ("wbell_resident", "K7 k=1", "k7", 105, kept7, 1, csr1),
            ("wbell_tiered", "K8 k=4", "k8", 275, kept8, 4, csr4),
            ("wbell_windowed", "K9 k=1", "k9", 46,
             int(op.wb.sum()), 1, csr1)):
        b_ms, b_by = bound(stream_bytes(kept, k), kept * 64 * 128 * 2 * k)
        entries.append({
            "name": name, "route": "cuda",
            "source": "cgx_torch/csrc/wbell.cu",
            "replaces": f"cgx/kernels/wbell.py:{src}",
            "launches": launches[key], "max_abs_err": errs[label],
            "ms": ms[label][0], "plain_ms": ms[label][1], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": csr})
    return entries


def seeded_block(n, k, seed, dev):
    """A seeded (n, k) fp32 block of right-hand sides."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, k)).astype(np.float32)).to(dev)


def multi_engine(a, m):
    """K5's engine for a stencil (``m`` None) or for a DIA operator under
    the Jacobi scaling of ``m``, and the scaling vector (None: stencil)."""
    from cgx_torch.kernels.fused_cg import stencil_taps
    from cgx_torch.kernels.fused_dia_cg import dia_prep
    from cgx_torch.kernels.fused_multi import FusedCGMulti

    if m is None:
        nx, ny, nz, taps, coeffs = stencil_taps(a)
        return FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs), None
    nx, ny, nz, taps, coeffs, planes, e, w, sym = dia_prep(
        a, torch.float32, inv_diag=m.inv_diag)
    return FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                        weight=w, sym=sym), e


def scaled_csr(a, e):
    """Ã = E·A·E of a DIA operator as a torch CSR tensor on its device,
    each value rounded as the DIA preparation rounds it."""
    n = a.shape[0]
    dev = a.data.device
    rows = torch.arange(n, device=dev)
    cols = rows[:, None] + torch.tensor(a.offsets, device=dev)[None, :]
    vals = a.data.T * e[:, None] * e[cols.clamp(0, n - 1)]
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, cols[keep], vals[keep], size=(n, n),
                                   check_invariants=False)


def multi_phases(dev, card, dias):
    """M1–M6: the multi-RHS path over stencils and DIA.  Returns K5's
    entries of the report line."""
    import cgx_torch
    from cgx_torch.io.poisson import poisson3d_dia27
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_multi as k5
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels.fused_cg import fused_stencil_cg
    from cgx_torch.kernels.fused_dia_cg import fused_dia_cg
    from cgx_torch.solve.block import _multi_route

    k = K_MULTI
    t0 = time.perf_counter()
    d160 = poisson3d_dia27(*N160, variable=True, seed=SEED, device=dev)
    dias["DIA-27 160^3"] = d160          # the mixed-precision phases' too
    cells = {"DIA-27 160^3": (d160, cgx_torch.JacobiPrecond.from_matrix(
                 d160)),
             "stencil 224^3": (cgx_torch.poisson3d_stencil(*N224), None)}
    print(f"M DIA-27 160^3 built in {time.perf_counter() - t0:.1f} s")

    def zero():
        k5.multi_a_launches = k5.multi_b_launches = 0
        k3.fused_a_launches = k3.fused_b_launches = 0
        k2.resident_cg_launches = k2.resident_dia_launches = 0

    def counts():
        return {"k5_a": k5.multi_a_launches, "k5_b": k5.multi_b_launches,
                "k3_a": k3.fused_a_launches, "k3_b": k3.fused_b_launches,
                "k2": k2.resident_cg_launches + k2.resident_dia_launches}

    def relmax(g, r):
        return float(((g - r).abs() / r.abs()).max())

    # -- M1. K5's kernels one step each, at both cells' full shapes ----------
    errs = {"a": 0.0, "b": 0.0}
    steps = {}
    for label, (a, m) in cells.items():
        eng, e = multi_engine(a, m)
        one = k3.FusedCG(eng.nx, eng.ny, eng.nz, eng.taps, coeffs=eng.coeffs,
                         planes=eng.planes, weight=eng.weight, sym=eng.sym)
        p = seeded_block(eng.n, k, SEED + 3, dev).T.contiguous()   # (k, n)
        q, pq, qq = eng.kernel_a(p)
        torch.cuda.synchronize()
        q_ref, pq_ref, qq_ref = eng.kernel_a_reference(p)
        as_k3 = all(torch.equal(q[j], one.kernel_a(p[j])[0])
                    for j in range(k))
        rel_a = maxrel(q, q_ref)
        rel_as = max(relmax(pq, pq_ref), relmax(qq, qq_ref))
        rz = torch.sum(p.double() ** 2, dim=1).float()
        z = torch.zeros_like(p)
        out = eng.kernel_b(rz, pq_ref, qq_ref, z, p, p, q_ref)
        torch.cuda.synchronize()
        out_ref = eng.kernel_b_reference(rz, pq_ref, qq_ref, z, p, p, q_ref)
        rel_b = max(maxrel(g, r) for g, r in zip(out[:3], out_ref[:3]))
        rel_bs = max(relmax(g, r) for g, r in zip(out[3:], out_ref[3:]))
        n_pl = 0 if eng.planes is None else eng.planes.shape[0]
        print(f"M1 {label} (k={k}, {len(eng.taps)} taps, {n_pl} planes, sym "
              f"{eng.sym}): A max|q-plain|/max|plain| {rel_a:.3e} (bitwise "
              f"{torch.equal(q, q_ref)}), sums {rel_as:.3e}, each column's q "
              f"equal to K3 A's: {as_k3}; B max|x,r,p-plain|/max|plain| "
              f"{rel_b:.3e}, sums {rel_bs:.3e}")
        check(rel_a <= 1e-6 and rel_as <= 1e-5 and as_k3,
              f"M1 {label}: K5 A disagrees")
        check(rel_b <= 1e-6 and rel_bs <= 1e-5, f"M1 {label}: K5 B disagrees")
        errs["a"] = max(errs["a"], float((q - q_ref).abs().max()))
        errs["b"] = max(errs["b"], max(float((g - r).abs().max())
                                       for g, r in zip(out[:3], out_ref[:3])))
        steps[label] = (eng, e, one, p, q_ref, pq_ref, qq_ref, rz)

    # -- M2, M3. The path as a user drives it -------------------------------
    launches = {"a": 0, "b": 0}
    main_runs = {}
    for tag, (label, (a, m)) in zip(("M2", "M3"), cells.items()):
        n = a.shape[0]
        B = seeded_block(n, k, SEED + 4, dev)
        route = _multi_route(a, B, m, "auto")[0]
        check(route == "fused", f"{tag} {label} routed to {route}")
        zero()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = cgx_torch.auto_solve(a, B, tol=TOL, preconditioner=m)
        end.record()
        end.synchronize()
        c = counts()
        print(f"{tag} {label} launches: K5 A {c['k5_a']}, K5 B {c['k5_b']}, "
              f"K3 A {c['k3_a']}, K3 B {c['k3_b']}, K2 {c['k2']}")
        check(c["k5_a"] > 0 and c["k5_b"] > 0 and c["k3_a"] == 0
              and c["k3_b"] == 0 and c["k2"] == 0,
              f"{tag}: the path did not run through K5 alone: {c}")
        launches["a"] += c["k5_a"]
        launches["b"] += c["k5_b"]
        its_all = res.iterations.tolist()
        its = its_all[0]
        check(len(set(its_all)) == 1, f"{tag}: iterations {its_all}")
        check(bool(res.converged.all()), f"{tag}: not every column converged")
        # The fp64 (Jacobi-)PCG solution of each column, for the forward
        # error: the batched loop in fp64.
        a64 = a if m is None else a.astype(torch.float64)
        m64 = None if m is None else cgx_torch.JacobiPrecond.from_matrix(a64)
        x64 = cgx_torch.cg_solve_multi(a64, B.double(), tol=1e-10,
                                       maxiter=20000, preconditioner=m64,
                                       backend="xla").x
        fwd = [rel(res.x[:, j], x64[:, j]) for j in range(k)]
        # Each column alone through K3, with the multi solve's cap.
        singles = [(fused_stencil_cg(a, B[:, j].contiguous(), tol=TOL,
                                     maxiter=n) if m is None else
                    fused_dia_cg(a, B[:, j].contiguous(), tol=TOL, maxiter=n,
                                 inv_diag=m.inv_diag)) for j in range(k)]
        its1 = [int(s.iterations) for s in singles]
        last = its1.index(max(its1))
        last_equal = torch.equal(res.x[:, last], singles[last].x)
        dev_last = rel(res.x[:, last], singles[last].x)
        again = cgx_torch.auto_solve(a, B, tol=TOL, preconditioner=m)
        same = (torch.equal(again.x, res.x)
                and torch.equal(again.iterations, res.iterations))
        eng, e = multi_engine(a, m)
        b2 = B.T if e is None else B.T * e[None]
        ref = eng.solve_reference(b2, tol=TOL, maxiter=n)
        x_ref = ref.x if e is None else ref.x * e[:, None]
        its_ref = int(ref.iterations[0])
        dx = rel(res.x, x_ref)
        print(f"{tag} {label}, B ({n}, {k}): {its} iterations shared, "
              f"{start.elapsed_time(end):.1f} ms; single-RHS K3 counts "
              f"{its1}; column {last} (exits last) equal to its single "
              f"solve bit for bit: {last_equal} (|dx|/|x| {dev_last:.3e}); "
              f"|x-x64|/|x64| per column "
              f"{[float(f'{v:.3e}') for v in fwd]}; reproducible: {same}; "
              f"plain version {its_ref} iterations, |x-x_plain|/|x_plain| "
              f"{dx:.3e} (bitwise {torch.equal(res.x, x_ref)})")
        check(max(fwd) <= 1e-4, f"{tag}: forward error {max(fwd)}")
        check(abs(its - max(its1)) <= 2,
              f"{tag}: {its} shared vs single counts {its1}")
        check(same, f"{tag}: two runs differ")
        check(its_ref == its, f"{tag}: {its} vs plain {its_ref} iterations")
        check(dx <= 1e-5, f"{tag}: x differs from the plain version by {dx}")
        main_runs[label] = (B, its, its1, start.elapsed_time(end))

    # -- M4. The narrow-band route: K3 per column ---------------------------
    a7 = dias["DIA-7 192^3"]
    m7 = cgx_torch.JacobiPrecond.from_matrix(a7)
    n7 = a7.shape[0]
    B7 = seeded_block(n7, k, SEED + 5, dev)
    route = _multi_route(a7, B7, m7, "auto")[0]
    check(route == "sequential", f"M4 DIA-7 routed to {route}")
    zero()
    res7 = cgx_torch.auto_solve(a7, B7, tol=TOL, preconditioner=m7)
    torch.cuda.synchronize()
    c = counts()
    print(f"M4 DIA-7 192^3 launches: K3 A {c['k3_a']}, K3 B {c['k3_b']}, "
          f"K5 A {c['k5_a']}, K5 B {c['k5_b']}, K2 {c['k2']}")
    check(c["k3_a"] > 0 and c["k3_b"] > 0 and c["k5_a"] == 0
          and c["k5_b"] == 0 and c["k2"] == 0,
          f"M4: the narrow-band route did not run K3 alone: {c}")
    for j in range(k):
        one = fused_dia_cg(a7, B7[:, j].contiguous(), tol=TOL, maxiter=n7,
                           inv_diag=m7.inv_diag)
        eq = (int(one.iterations) == int(res7.iterations[j])
              and torch.equal(one.x, res7.x[:, j]))
        print(f"M4 column {j}: {int(res7.iterations[j])} iterations, "
              f"converged {bool(res7.converged[j])}, equal to fused_dia_cg "
              f"bit for bit: {eq}")
        check(eq and bool(res7.converged[j]), f"M4 column {j} differs")

    # -- M5. The batched loop below FUSED_MIN_ROWS; block CG ----------------
    a27 = dias["DIA-27 128^3"]
    m27 = cgx_torch.JacobiPrecond.from_matrix(a27)
    B27 = seeded_block(a27.shape[0], k, SEED + 6, dev)
    route = _multi_route(a27, B27, m27, "auto")[0]
    check(route == "xla", f"M5 DIA-27 128^3 routed to {route}")
    zero()
    t0 = time.perf_counter()
    res27 = cgx_torch.auto_solve(a27, B27, tol=TOL, preconditioner=m27)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    c = counts()
    check(sum(c.values()) == 0, f"M5: the loop launched a kernel: {c}")
    for j in range(k):
        one = cgx_torch.cg_solve(a27, B27[:, j].contiguous(), tol=TOL,
                                 preconditioner=m27)
        dxj = rel(res27.x[:, j], one.x)
        print(f"M5 column {j}: {int(res27.iterations[j])} iterations (its "
              f"own cg_solve {int(one.iterations)}), |dx|/|x| {dxj:.3e} "
              f"(bitwise {torch.equal(res27.x[:, j], one.x)})")
        check(int(one.iterations) == int(res27.iterations[j]) and dxj <= 1e-5
              and bool(res27.converged[j]), f"M5 column {j} differs")
    print(f"M5 batched loop DIA-27 128^3, k={k}: {t_loop:.2f} s (host "
          f"clock), no K2, K3 or K5 launch")
    s64 = cgx_torch.poisson3d_stencil(64, 64, 64)
    rng = np.random.default_rng(SEED + 7)
    base = rng.standard_normal(s64.shape[0])
    b8 = torch.from_numpy(np.stack(
        [base + 0.05 * rng.standard_normal(s64.shape[0]) for _ in range(8)],
        axis=1).astype(np.float32)).to(dev)
    blk = cgx_torch.block_cg_solve(s64, b8, tol=1e-5)
    single = cgx_torch.cg_solve(s64, b8[:, 0].contiguous(), tol=1e-5)
    its_blk = int(blk.iterations[0])
    print(f"M5 block_cg_solve 64^3, 8 clustered right-hand sides: {its_blk} "
          f"iterations, converged {blk.converged.tolist()}; single CG on "
          f"column 0: {int(single.iterations)}")
    check(bool(blk.converged.all()) and its_blk < int(single.iterations),
          "M5: block CG did not beat single CG")

    # -- M6. Times -----------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    def versus_k3(label, eng, one, b2, its, its1):
        """K5 against the four sequential K3 solves of the same block, in
        turns; returns K5's ms per solve."""
        n = eng.n
        cols = [b2[j] for j in range(k)]
        t5, t3 = time_pair(
            lambda: eng.solve(b2, tol=TOL, maxiter=n),
            lambda: [one.solve(c, tol=TOL, maxiter=n) for c in cols],
            reps=3)
        print(f"[{card}] M6 {label}, k={k}: K5 {t5:.2f} ms/solve, "
              f"{t5 / its * 1e3:.2f} us/iter ({its} it), "
              f"{t5 / its / k * 1e3:.2f} us per column and iteration; four "
              f"sequential K3 solves {t3:.2f} ms, "
              f"{t3 / sum(its1) * 1e3:.2f} us per column and iteration "
              f"({sum(its1)} column-iterations); K5 / K3 "
              f"{(t5 / (its * k)) / (t3 / sum(its1)):.3f}")
        return t5

    dev_ms, per_call, bounds = {}, {}, {}
    for label, (a, m) in cells.items():
        eng, e, one, p, q_ref, pq_ref, qq_ref, rz = steps[label]
        B, its, its1, _ = main_runs[label]
        n = eng.n
        b2 = (B.T if e is None else B.T * e[None]).contiguous()
        cols = [b2[j] for j in range(k)]
        t5 = versus_k3(label, eng, one, b2, its, its1)
        # The kernels' own device time over one solve (CUDA activity only).
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.solve(b2, tol=TOL, maxiter=n)
            torch.cuda.synchronize()
        us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
              if ev.self_device_time_total > 0}
        busy = sum(us.values())
        ka = sum(v for kk, v in us.items() if "multi_a" in kk)
        kb = sum(v for kk, v in us.items() if "multi_b" in kk)
        if ka == 0 or kb == 0:
            print("M6 profiler: no device time for K5 recorded; per-call "
                  "times below are one call from Python")
        else:
            dev_ms[label] = (ka / its / 1e3, kb / its / 1e3)
            print(f"[{card}] M6 profiler, one K5 solve {label}: device busy "
                  f"{busy / 1e3:.2f} ms of {t5:.2f} (idle share "
                  f"{1 - busy / 1e3 / t5:.1%}); K5 A {ka / its:.2f} us and "
                  f"K5 B {kb / its:.2f} us of device time per iteration "
                  f"({(ka + kb) / busy:.1%} of the device time)")
        # K3's kernels over one column's solve, to set K5's per-column
        # cost beside them.
        j = its1.index(max(its1))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one.solve(cols[j], tol=TOL, maxiter=n)
            torch.cuda.synchronize()
        us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()}
        k3a = sum(v for kk, v in us.items() if "kernel_a<" in kk)
        k3b = sum(v for kk, v in us.items() if "kernel_b<" in kk)
        if k3a and k3b:
            print(f"[{card}] M6 profiler, K3 on column {j} of {label}: A "
                  f"{k3a / its1[j]:.2f} us and B {k3b / its1[j]:.2f} us of "
                  f"device time per iteration; K5 A / K3 A "
                  f"{ka / its / (k3a / its1[j]):.2f}, K5 B / K3 B "
                  f"{kb / its / (k3b / its1[j]):.2f} at k = {k}")
        # One call each from Python beside its plain version.
        z = torch.zeros_like(p)
        t_a, t_ap = time_pair(lambda: eng.kernel_a(p),
                              lambda: eng.kernel_a_reference(p), inner=10)
        t_b, t_bp = time_pair(
            lambda: eng.kernel_b(rz, pq_ref, qq_ref, z, p, p, q_ref),
            lambda: eng.kernel_b_reference(rz, pq_ref, qq_ref, z, p, p,
                                           q_ref), inner=10)
        per_call[label] = (t_a, t_ap, t_b, t_bp)
        # Bounds: A reads the planes and P and writes Q (2 flops per tap
        # and mirror, 4 for the sums); B reads X, R, P, Q and w and writes
        # X, R, P (12 flops per entry).
        n_pl = 0 if eng.planes is None else eng.planes.shape[0]
        terms = sum(2 if (c is None and eng.sym and tap != (0, 0, 0)) else 1
                    for tap, c in zip(eng.taps, eng.coeffs))
        bounds[label] = (
            bound((n_pl + 2 * k) * 4 * n, k * n * (2 * terms + 4)),
            bound((7 * k + (eng.weight is not None)) * 4 * n, 12 * k * n))
        print(f"[{card}] M6 {label} one call from Python: K5 A "
              f"{t_a * 1e3:.2f} us (plain {t_ap * 1e3:.2f} us, bound "
              f"{bounds[label][0][0] * 1e3:.2f} us, {bounds[label][0][1]}), "
              f"K5 B {t_b * 1e3:.2f} us (plain {t_bp * 1e3:.2f} us, bound "
              f"{bounds[label][1][0] * 1e3:.2f} us, {bounds[label][1][1]}; "
              f"the call copies X, R, P first)")

    # The narrow-band DIA-7 of M4, which auto sends to K3 per column by the
    # JAX package's plane count (_narrow_band): K5 on the same B, checked
    # and timed against the four K3 solves.
    eng7, e7 = multi_engine(a7, m7)
    one7 = k3.FusedCG(eng7.nx, eng7.ny, eng7.nz, eng7.taps,
                      coeffs=eng7.coeffs, planes=eng7.planes,
                      weight=eng7.weight, sym=eng7.sym)
    b7 = (B7.T * e7[None]).contiguous()
    r5 = eng7.solve(b7, tol=TOL, maxiter=n7)
    its5, its7 = int(r5.iterations[0]), res7.iterations.tolist()
    print(f"M6 DIA-7 192^3 through K5: {its5} iterations shared (K3 per "
          f"column {its7}), converged {r5.converged.tolist()}")
    check(bool(r5.converged.all()) and abs(its5 - max(its7)) <= 2,
          f"M6: K5 on DIA-7 took {its5} iterations vs K3's {its7}")
    versus_k3("DIA-7 192^3", eng7, one7, b7, its5, its7)
    del eng7, one7, b7, r5

    # PyTorch calls that compute K5 A's product (without its sums): the CSR
    # product of Ã at DIA-27 160^3 and conv3d with batch k at 224^3 (fp32,
    # cuDNN's TF32 off).
    d_label = "DIA-27 160^3"
    eng, e, _, p, q_ref = steps[d_label][:5]
    csr = scaled_csr(d160, e)
    pn = p.T.contiguous()
    check(maxrel(csr @ pn, q_ref.T) <= 1e-5,
          "the CSR product does not compute K5 A's product")
    t_csr = statistics.median(event_ms(lambda: csr @ pn, inner=10)
                              for _ in range(5))
    del csr
    s_label = "stencil 224^3"
    p224, q224 = steps[s_label][3], steps[s_label][4]
    torch.backends.cudnn.allow_tf32 = False
    wk = torch.zeros((1, 1, 3, 3, 3), device=dev)
    wk[0, 0, 1, 1, 1] = 6.0
    for tap in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        wk[(0, 0) + tap] = -1.0
    xv = p224.view(k, 1, *N224)

    def conv():
        return torch.nn.functional.conv3d(xv, wk, padding=1)

    check(maxrel(conv().reshape(k, -1), q224) <= 1e-6,
          "conv3d does not compute K5 A's product")
    conv()
    t_conv = statistics.median(event_ms(conv, inner=10) for _ in range(5))
    print(f"[{card}] M6 PyTorch calls of K5 A's product alone: CSR product "
          f"of Ã at {d_label} {t_csr * 1e3:.2f} us (K5 A one call "
          f"{per_call[d_label][0] * 1e3:.2f} us); conv3d batch {k} at "
          f"{s_label} {t_conv * 1e3:.2f} us (K5 A one call "
          f"{per_call[s_label][0] * 1e3:.2f} us)")

    t_a, t_ap, t_b, t_bp = per_call[d_label]
    ms_a, ms_b = dev_ms.get(d_label, (t_a, t_b))
    return [
        {"name": "fused_multi_a", "route": "cuda",
         "source": "cgx_torch/csrc/fused_multi.cu",
         "replaces": "cgx/kernels/fused_multi.py:64",
         "launches": launches["a"], "max_abs_err": errs["a"], "ms": ms_a,
         "plain_ms": t_ap, "bound_ms": bounds[d_label][0][0],
         "bound_by": bounds[d_label][0][1], "library_ms": t_csr},
        {"name": "fused_multi_b", "route": "cuda",
         "source": "cgx_torch/csrc/fused_multi.cu",
         "replaces": "cgx/kernels/fused_multi.py:204",
         "launches": launches["b"], "max_abs_err": errs["b"], "ms": ms_b,
         "plain_ms": t_bp, "bound_ms": bounds[d_label][1][0],
         "bound_by": bounds[d_label][1][1], "library_ms": None},
    ]


def random_bell(nbr, seed, dev):
    """The records' block-dense operator: ``nbr`` block rows of BELL_WB
    distinct sorted block columns each (numpy, ``seed``), values standard
    normal fp32, as a BlockELL on ``dev`` and as the CSR-of-blocks arrays
    ``(crow, col, values)`` of the same matrix for torch's BSR product.
    (experiments/bell_pair_proto.py:65 drew columns with repeats; distinct
    columns make the same matrix a valid BSR.)"""
    from cgx_torch.kernels.bsr import BlockELL

    rng = np.random.default_rng(seed)
    cols = np.sort(np.stack([rng.choice(nbr, BELL_WB, replace=False)
                             for _ in range(nbr)]), axis=1).astype(np.int32)
    vals = torch.from_numpy(rng.standard_normal(
        (nbr, BELL_WB, BELL_BS, BELL_BS), dtype=np.float32)).to(dev)
    a = BlockELL(values=vals, block_cols=torch.from_numpy(cols).to(dev),
                 shape=(nbr * BELL_BS, nbr * BELL_BS))
    crow = torch.arange(0, nbr * BELL_WB + 1, BELL_WB, device=dev)
    return a, (crow, a.block_cols.reshape(-1).long(),
               vals.reshape(-1, BELL_BS, BELL_BS))


def product64(a, x) -> np.ndarray:
    """``A @ X`` of a BlockELL in numpy fp64, slot by slot."""
    vals = a.values.double().cpu().numpy()
    cols = a.block_cols.long().cpu().numpy()
    nbr, wb, bs, _ = vals.shape
    xb = x.double().cpu().numpy().reshape(-1, bs, x.shape[1])
    y = np.zeros((nbr, bs, x.shape[1]))
    for j in range(wb):
        y += np.matmul(vals[:, j], xb[cols[:, j]])
    return y.reshape(nbr * bs, -1)


def other_launches() -> dict:
    """The launch counters of every kernel but K11, by (module, name)."""
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_multi as k5
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels import stencil as k1
    from cgx_torch.kernels import wbell as kw

    names = ((k1, "stencil3d_spmv_launches"), (k2, "resident_cg_launches"),
             (k2, "resident_dia_launches"), (k3, "fused_a_launches"),
             (k3, "fused_b_launches"), (k5, "multi_a_launches"),
             (k5, "multi_b_launches"), (kw, "wbell_resident_launches"),
             (kw, "wbell_tiered_launches"), (kw, "wbell_windowed_launches"))
    return {(m, nm): getattr(m, nm) for m, nm in names}


def bsr_phases(dev, card):
    """B1–B5: the block-sparse path (K11, BSR/COO, the CSR builders, the
    legacy format).  Returns K11's entry of the report line."""
    import cgx_torch
    from cgx_torch.io.legacy import read_legacy, write_legacy
    from cgx_torch.io.poisson import poisson2d, poisson3d
    from cgx_torch.kernels import bsr as kb

    # The plain versions' fp32 matmuls must run in full fp32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on for fp32 matmuls")
    for (m, nm) in other_launches():
        setattr(m, nm, 0)
    kb.bell_spmm_launches = 0
    phase_launches = {}

    def held(label, run, plain, y64=None):
        """Run K11 once (one launch), hold it to its plain version (and to
        an fp64 product), and once more for bitwise reproducibility."""
        before = kb.bell_spmm_launches
        y = run()
        torch.cuda.synchronize()
        check(kb.bell_spmm_launches == before + 1,
              f"{label}: the launch counter moved by "
              f"{kb.bell_spmm_launches - before}")
        y_ref = plain()
        scale = float(y_ref.abs().max())
        err = float((y - y_ref).abs().max())
        line = (f"{label}: max|y - plain| {err:.3e} (bound 1e-5 * "
                f"{scale:.3e})")
        check(y.dtype == torch.float32, f"{label}: output {y.dtype}")
        check(err <= 1e-5 * scale, f"{label} disagrees with its plain "
              f"version: {err}")
        if y64 is not None:
            e64 = float(np.abs(y.double().cpu().numpy() - y64).max())
            line += f", max|y - fp64| {e64:.3e}"
            check(e64 <= 1e-5 * float(np.abs(y64).max()),
                  f"{label} disagrees with the fp64 product: {e64}")
        same = torch.equal(run(), y)
        print(line + f", two runs bitwise equal: {same}")
        check(same, f"{label}: two runs differ")
        return y, err

    # -- B1. fp32, 512 block rows, k = 256 and 512 ---------------------------
    t0 = time.perf_counter()
    a1, bsr1 = random_bell(BELL_ROWS["B1"], SEED, dev)
    rng = np.random.default_rng(SEED + 10)
    xs1 = {k: torch.from_numpy(rng.standard_normal(
        (a1.shape[1], k), dtype=np.float32)).to(dev) for k in (256, 512)}
    print(f"B1 block-ELL {BELL_ROWS['B1']} block rows, bs {BELL_BS}, wb "
          f"{BELL_WB}: "
          f"{a1.values.numel()} stored values, built in "
          f"{time.perf_counter() - t0:.1f} s")
    errs = {}
    for k, x in xs1.items():
        y64 = product64(a1, x)
        for engine in ("auto", "dma"):
            _, errs["B1", k, engine] = held(
                f"B1 fp32 k={k} engine={engine}",
                lambda: kb.bell_spmm(a1, x, engine=engine),
                lambda: kb.bell_spmm_reference(a1, x), y64)
    phase_launches["B1"] = kb.bell_spmm_launches

    # -- B2. bf16 operands, 1024 block rows, k = 256 -------------------------
    a2, bsr2 = random_bell(BELL_ROWS["B2"], SEED + 1, dev)
    x2 = torch.from_numpy(np.random.default_rng(SEED + 11).standard_normal(
        (a2.shape[1], 256), dtype=np.float32)).to(dev)
    a2h, x2h = a2.astype(torch.bfloat16), x2.to(torch.bfloat16)
    y2, errs["B2"] = held("B2 bf16 k=256", lambda: kb.bell_spmm(a2h, x2h),
                          lambda: kb.bell_spmm_reference(a2h, x2h))
    y2_32 = kb.bell_spmm_reference(a2, x2)
    rel2 = float(torch.linalg.vector_norm(y2 - y2_32)
                 / torch.linalg.vector_norm(y2_32))
    print(f"B2 bf16: {a2h.values.numel()} stored values, output "
          f"{y2.dtype}; |y - y_fp32| / |y_fp32| {rel2:.3e} (bound 3e-2)")
    check(rel2 <= 3e-2, f"B2: bf16 product {rel2} from the fp32 one")
    del y2, y2_32
    phase_launches["B2"] = kb.bell_spmm_launches - phase_launches["B1"]

    # -- B3. poisson3d(128, 128, 128) through BSR (bs 8) and block-ELL ------
    t0 = time.perf_counter()
    a3c = poisson3d(*N128, dtype=np.float32, device=dev)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    b3 = cgx_torch.bsr_from_csr(a3c, 8)
    a3 = kb.bell_from_bsr(b3)
    torch.cuda.synchronize()
    n_pad = a3.values.shape[0] * a3.wb - b3.nnzb
    print(f"B3 poisson3d 128^3: {a3c.shape[0]} rows, {a3c.nnz} nnz (CSR "
          f"built in {t_csr:.1f} s); BSR bs 8 and block-ELL in "
          f"{time.perf_counter() - t0:.1f} s: {b3.nnzb} blocks, wb "
          f"{a3.wb}, {n_pad} padding blocks")
    x3 = torch.from_numpy(np.random.default_rng(SEED + 12).standard_normal(
        (a3c.shape[0], 4), dtype=np.float32)).to(dev)
    x31 = x3[:, 0].contiguous()
    held("B3 bell_spmv k=1", lambda: kb.bell_spmv(a3, x31),
         lambda: cgx_torch.spmv(a3c, x31))
    held("B3 bell_spmm k=4", lambda: kb.bell_spmm(a3, x3),
         lambda: cgx_torch.spmm(a3c, x3))
    phase_launches["B3"] = (kb.bell_spmm_launches - phase_launches["B1"]
                            - phase_launches["B2"])
    k11_launches = kb.bell_spmm_launches

    # -- B4. the path as a user drives it: BSR/COO solves, the legacy file ---
    a4c = poisson3d(*N64, dtype=np.float32, device=dev)
    n4 = a4c.shape[0]
    b4 = torch.from_numpy(np.random.default_rng(SEED + 13).standard_normal(
        n4).astype(np.float32)).to(dev)
    its_csr = int(cgx_torch.auto_solve(a4c, b4, tol=TOL).iterations)
    x64 = cgx_torch.cg_solve(a4c.astype(torch.float64), b4.double(),
                             tol=1e-10, maxiter=20000).x
    bsr4 = cgx_torch.bsr_from_csr(a4c, 8)
    for label, op in (("BSR", bsr4), ("COO", a4c.to_coo())):
        route = cgx_torch.select_backend(op, b4)
        check(route == "xla", f"B4 {label} routed to {route}")
        t0 = time.perf_counter()
        res = cgx_torch.auto_solve(op, b4, tol=TOL)
        torch.cuda.synchronize()
        its = int(res.iterations)
        fwd = rel(res.x, x64)
        print(f"B4 auto_solve over {label} 64^3 (route {route}): {its} "
              f"iterations (CSR {its_csr}), converged "
              f"{bool(res.converged)}, |x-x64|/|x64| {fwd:.3e}, "
              f"{time.perf_counter() - t0:.2f} s (host clock)")
        check(bool(res.converged), f"B4 {label} did not converge")
        check(abs(its - its_csr) <= 0.02 * its_csr,
              f"B4 {label}: {its} vs CSR {its_csr} iterations")
        check(fwd <= 1e-4, f"B4 {label}: forward error {fwd}")
    B4 = seeded_block(n4, K_MULTI, SEED + 14, dev)
    multi = cgx_torch.cg_solve_multi(bsr4, B4, tol=TOL)
    for j in range(K_MULTI):
        one = cgx_torch.cg_solve(bsr4, B4[:, j].contiguous(), tol=TOL)
        its_m, its1 = int(multi.iterations[j]), int(one.iterations)
        dxj = rel(multi.x[:, j], one.x)
        print(f"B4 cg_solve_multi over BSR, column {j}: {its_m} iterations "
              f"(single {its1}), |dx|/|x| {dxj:.3e}")
        check(bool(multi.converged[j]) and abs(its_m - its1) <= max(
            2, 0.02 * its1) and dxj <= 1e-4, f"B4 column {j} differs")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "legacy_poisson2d_256.txt")
    a5 = poisson2d(*LEGACY_2D, device=dev)
    b5 = torch.from_numpy(np.random.default_rng(SEED + 15).standard_normal(
        a5.shape[0])).to(dev)
    write_legacy(path, a5, b5)
    ra, rb = read_legacy(path, device=dev)
    same = all(torch.equal(getattr(ra, f), getattr(a5, f))
               for f in ("values", "col_indices", "indptr")) \
        and torch.equal(rb, b5)
    rc, rcb = read_legacy(path, device="cpu")
    xg = cgx_torch.cg_solve(ra, rb, tol=0.0, maxiter=50).x
    xc = cgx_torch.cg_solve(rc, rcb, tol=0.0, maxiter=50).x
    dleg = rel(xg.cpu(), xc)
    print(f"B4 legacy 4-line file of poisson2d(256, 256) "
          f"({os.path.getsize(path)} bytes): read back equal: {same}; "
          f"cg_solve(tol=0, maxiter=50) fp64 on the card vs the CPU: "
          f"|dx|/|x| {dleg:.3e} (bound 1e-12)")
    check(same, "B4: the legacy file did not read back equal")
    check(dleg <= 1e-12, f"B4: the legacy solve differs by {dleg}")
    others = {nm: v for (_, nm), v in other_launches().items() if v}
    print(f"B1-B4 launches: K11 {k11_launches} (B1 {phase_launches['B1']}, "
          f"B2 {phase_launches['B2']}, B3 {phase_launches['B3']}, B4 "
          f"{kb.bell_spmm_launches - k11_launches}); other kernels "
          f"{others or 'none'}")
    check(min(phase_launches.values()) > 0, f"K11 did not run in every "
          f"phase: {phase_launches}")
    check(kb.bell_spmm_launches == k11_launches and not others,
          "B4 launched a kernel")

    # -- B5. times -------------------------------------------------------------
    def library(label, bsr_arrays, size, x, ref):
        """ms of torch's BSR product of the same matrix, or None where it
        raises for the dtype."""
        crow, col, vals = bsr_arrays
        try:
            m = torch.sparse_bsr_tensor(crow, col, vals, size=size,
                                        check_invariants=False)
            y = m @ x
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, ValueError) as exc:
            print(f"B5 {label}: torch's BSR product raised "
                  f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}")
            return None
        dev_ = maxrel(y.float(), ref)
        print(f"B5 {label}: torch's BSR product within {dev_:.3e} of the "
              f"plain version")
        check(dev_ <= (1e-5 if x.dtype == torch.float32 else 2e-2),
              f"B5 {label}: torch's BSR product does not compute K11's "
              f"function")
        return statistics.median(event_ms(lambda: m @ x, inner=5)
                                 for _ in range(5))

    def work(nblocks, bs, k, elem, nbc, nbr, peak):
        """Each input read once (the real blocks, their column ids, X), Y
        written once in fp32; 2 bs² k operations per real block."""
        nbytes = (nblocks * (bs * bs * elem + 4) + nbc * bs * k * elem
                  + nbr * bs * k * 4)
        return bound(nbytes, 2.0 * nblocks * bs * bs * k, peak)

    b3_arrays = (b3.indptr, b3.col_indices, b3.values)
    timed = {
        "B1 fp32 k=256": (a1, xs1[256], bsr1, FP32_FLOPS),
        "B1 fp32 k=512": (a1, xs1[512], bsr1, FP32_FLOPS),
        "B2 bf16 k=256": (a2h, x2h, (bsr2[0], bsr2[1],
                                     bsr2[2].to(torch.bfloat16)),
                          BF16_TC_FLOPS),
        "B3 poisson3d 128^3 k=1": (a3, x3[:, :1].contiguous(), b3_arrays,
                                   FP32_FLOPS),
        "B3 poisson3d 128^3 k=4": (a3, x3, b3_arrays, FP32_FLOPS),
    }
    csr3 = torch.sparse_csr_tensor(a3c.indptr, a3c.col_indices, a3c.values,
                                   size=a3c.shape, check_invariants=False)
    times = {}
    for label, (a, x, arrays, peak) in timed.items():
        t_k, t_p = time_pair(lambda: kb.bell_spmm(a, x),
                             lambda: kb.bell_spmm_reference(a, x), reps=5,
                             inner=5)
        nbr, _, bs, _ = a.values.shape
        nblocks = b3.nnzb if label.startswith("B3") else nbr * a.wb
        b_ms, b_by = work(nblocks, bs, x.shape[1], x.element_size(),
                          a.shape[1] // bs, nbr, peak)
        lib = library(label, arrays, a.shape, x,
                      kb.bell_spmm_reference(a, x))
        extra = ""
        if label.startswith("B3"):
            t_csr3 = statistics.median(event_ms(lambda: csr3 @ x, inner=5)
                                       for _ in range(5))
            extra = f"; torch CSR product {t_csr3 * 1e3:.1f} us"
        flops = 2.0 * nblocks * bs * bs * x.shape[1]
        times[label] = (t_k, t_p, b_ms, b_by, lib)
        print(f"[{card}] B5 {label}: K11 {t_k * 1e3:.1f} us "
              f"({flops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s), plain "
              f"{t_p * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), "
              f"share of bound {b_ms / t_k:.1%}; torch BSR product "
              + (f"{lib * 1e3:.1f} us" if lib is not None else "n/a")
              + extra)

    t_k, t_p, b_ms, b_by, lib = times["B1 fp32 k=256"]
    return [{"name": "bell_spmm", "route": "cuda",
             "source": "cgx_torch/csrc/bsr.cu",
             "replaces": "cgx/kernels/bsr.py:93,151",
             "launches": k11_launches,
             "max_abs_err": errs["B1", 256, "auto"], "ms": t_k,
             "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib}]


def seeded_rhs(n, dev):
    """The seeded right-hand side of the DIA phases: standard normal from
    SEED, fp32."""
    return torch.from_numpy(np.random.default_rng(SEED).standard_normal(n)
                            .astype(np.float32)).to(dev)


def device_us(prof, pick):
    """(µs of device time, launches) of the kernels whose profiler key
    satisfies ``pick``."""
    evs = [ev for ev in prof.key_averages()
           if ev.self_device_time_total > 0 and pick(ev.key)]
    return (sum(ev.self_device_time_total for ev in evs),
            sum(ev.count for ev in evs))


def mixed_phases(dev, card, dias, fp64_solution, relres_of):
    """X1–X5: mixed precision.  ``auto_solve(..., mixed_precision=True)``
    (``ir_cg_solve`` over K3's narrow modes), K2's and K5's bf16 planes,
    and their times.  ``dias`` holds DIA-7 192³, DIA-27 128³ and DIA-27
    160³; ``fp64_solution(label, rhs name, a, b)`` and ``relres_of(a, b,
    x)`` are the main phases' fp64 yardsticks.  Returns the report line's
    entries of the narrow modes."""
    import cgx_torch
    from cgx_torch.kernels import fused_dia_cg as fdia
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels import fused_multi as k5
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels.fused_cg import build_fused
    from cgx_torch.solve.auto import BF16_PLANE_MIN_SPEEDUP
    from cgx_torch.solve.ir import ir_cg_solve_reference
    from torch.profiler import ProfilerActivity, profile

    bf16 = torch.bfloat16

    def zero():
        k3.fused_a_launches = k3.fused_b_launches = 0
        k3.fused_a_bf16_launches = k3.fused_b_bf16_launches = 0
        k3.fused_a_bf16_planes_launches = 0
        k2.resident_cg_launches = k2.resident_dia_launches = 0
        k2.resident_dia_bf16_launches = 0
        k5.multi_a_launches = k5.multi_b_launches = 0
        k5.multi_a_bf16_launches = 0

    def counts():
        return {"k3_a": k3.fused_a_launches, "k3_b": k3.fused_b_launches,
                "k3_a_bf16": k3.fused_a_bf16_launches,
                "k3_b_bf16": k3.fused_b_bf16_launches,
                "k3_a_planes": k3.fused_a_bf16_planes_launches,
                "k2": k2.resident_cg_launches + k2.resident_dia_launches,
                "k2_bf16": k2.resident_dia_bf16_launches,
                "k5_a": k5.multi_a_launches, "k5_b": k5.multi_b_launches,
                "k5_a_bf16": k5.multi_a_bf16_launches}

    a224 = cgx_torch.poisson3d_stencil(*N224)
    cells = {"stencil 224^3": (a224, None)}
    for label in ("DIA-27 160^3", "DIA-7 192^3"):
        cells[label] = (dias[label], cgx_torch.JacobiPrecond.from_matrix(
            dias[label]))
    launches = {"a_bf16": 0, "b_bf16": 0, "a_planes": 0, "k2_bf16": 0,
                "k5_a_bf16": 0}
    errs = {}
    its_fixed = 100           # the fixed-count runs of X3 and X5

    # -- X1, X2. auto_solve(mixed_precision=True), as a user drives it -----
    ir_runs = {}
    for label, (a, m) in cells.items():
        n = a.shape[0]
        tag = "X1" if m is None else "X2"
        planes = m is not None
        if planes:
            sp = fdia.bf16_plane_speedup(a, n, 4)
            print(f"{tag} {label}: bf16_plane_speedup (the TPU model) "
                  f"{sp:.4f}, cut {BF16_PLANE_MIN_SPEEDUP}")
            check(sp >= BF16_PLANE_MIN_SPEEDUP,
                  f"{tag} {label}: the model does not choose the plane mode")
        kw = (dict(inner_dtype=torch.float32, inner_plane_dtype=bf16,
                   inner_tol=5e-3) if planes else {})
        for nm, b in (("ones", torch.ones(n, dtype=torch.float32,
                                          device=dev)),
                      ("random", seeded_rhs(n, dev))):
            zero()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = cgx_torch.auto_solve(a, b, tol=TOL, preconditioner=m,
                                       mixed_precision=True)
            end.record()
            end.synchronize()
            c = counts()
            fp32_a = c["k3_a"] - c["k3_a_bf16"] - c["k3_a_planes"]
            print(f"{tag} {label} b={nm} launches: K3 A bf16 vectors "
                  f"{c['k3_a_bf16']}, K3 B bf16 vectors {c['k3_b_bf16']}, "
                  f"K3 A bf16 planes {c['k3_a_planes']}, K3 A fp32 "
                  f"{fp32_a}, K3 B fp32 {c['k3_b'] - c['k3_b_bf16']}, K2 "
                  f"{c['k2']}, K5 A {c['k5_a']}")
            if planes:
                ok = (c["k3_a_planes"] > 0 and c["k3_a_bf16"] == 0
                      and c["k3_b_bf16"] == 0 and c["k3_b"] > 0)
                launches["a_planes"] += c["k3_a_planes"]
            else:
                ok = (c["k3_a_bf16"] > 0 and c["k3_b_bf16"] > 0
                      and c["k3_a_planes"] == 0)
                launches["a_bf16"] += c["k3_a_bf16"]
                launches["b_bf16"] += c["k3_b_bf16"]
            check(ok and fp32_a > 0 and c["k2"] == 0 and c["k5_a"] == 0,
                  f"{tag} {label} b={nm}: not the IR route's kernels: {c}")
            check(bool(res.converged), f"{tag} {label} b={nm}: not converged")
            its = int(res.iterations)
            ms = start.elapsed_time(end)
            ref = ir_cg_solve_reference(a, b, tol=TOL, maxiter=n,
                                        preconditioner=m, **kw)
            its_ref = int(ref.iterations)
            x64 = fp64_solution(label, nm, a, b)
            relres, relres_ref = relres_of(a, b, res.x), relres_of(a, b,
                                                                  ref.x)
            fwd, fwd_ref = rel(res.x, x64), rel(ref.x, x64)
            dx = rel(res.x, ref.x)
            print(f"{tag} {label} b={nm}: {its} inner iterations in "
                  f"{ms:.1f} ms (plain version {its_ref}), |x-x_plain|/"
                  f"|x_plain| {dx:.3e} (bitwise {torch.equal(res.x, ref.x)}),"
                  f" |x-x64|/|x64| {fwd:.3e} (plain {fwd_ref:.3e}), true "
                  f"relres (fp64) {relres:.3e} (plain {relres_ref:.3e})")
            # At b = ones the fp32 true residual has a floor above tol, so
            # the two-strikes guard ends the refinement on fp32 noise and
            # the fp32 finish follows: the count is held to 10 % there.
            slack = 2 if nm == "random" else max(2, its_ref // 10)
            check(abs(its - its_ref) <= slack,
                  f"{tag} {label} b={nm}: {its} vs plain {its_ref}")
            check(dx <= 1e-4, f"{tag} {label} b={nm}: x differs by {dx}")
            check(fwd <= 1e-4, f"{tag} {label} b={nm}: forward error {fwd}")
            if nm == "random":
                # b = ones: the fp32 x cannot hold 1e-6 (PERF.md §6).
                check(relres <= max(1.1e-6, 1.5 * relres_ref),
                      f"{tag} {label} b={nm}: true relres {relres}")
            ir_runs[label, nm] = (its, ms)

    # K3's narrow modes one step each at the path's shapes, bitwise.
    steps = {}
    b224 = torch.ones(a224.shape[0], dtype=torch.float32, device=dev)
    eng16 = build_fused(a224, bf16)
    p16 = seeded_rhs(a224.shape[0], dev).to(bf16)
    q, pq, qq = eng16.kernel_a(p16)
    torch.cuda.synchronize()
    q_ref, pq_ref, qq_ref = eng16.kernel_a_reference(p16)
    rz16 = torch.sum(p16.double() ** 2).float()
    x16 = (0.5 * p16.float()).to(bf16)
    out = eng16.kernel_b(rz16, pq_ref, qq_ref, x16, p16, p16, q_ref)
    torch.cuda.synchronize()
    out_ref = eng16.kernel_b_reference(rz16, pq_ref, qq_ref, x16, p16, p16,
                                       q_ref)
    errs["a_bf16"] = float((q.float() - q_ref.float()).abs().max())
    errs["b_bf16"] = max(float((g.float() - r.float()).abs().max())
                         for g, r in zip(out[:3], out_ref[:3]))
    sums = max(abs(float(g) - float(r)) / abs(float(r)) for g, r in
               ((pq, pq_ref), (qq, qq_ref)) + tuple(zip(out[3:],
                                                        out_ref[3:])))
    print(f"X1 K3 bf16 vectors one step at 224^3: A bitwise "
          f"{torch.equal(q, q_ref)}, B bitwise "
          f"{all(torch.equal(g, r) for g, r in zip(out[:3], out_ref[:3]))},"
          f" sums within {sums:.3e}")
    check(errs["a_bf16"] == 0 and errs["b_bf16"] == 0 and sums <= 1e-6,
          "X1: K3 in bf16 vectors differs from its plain version")
    steps["stencil 224^3"] = (eng16, build_fused(a224, torch.float32),
                              b224, p16, (rz16, pq_ref, qq_ref, x16, q_ref))
    errs["a_planes"] = 0.0
    for label in ("DIA-27 160^3", "DIA-7 192^3", "DIA-27 128^3"):
        a = dias[label]
        m = cgx_torch.JacobiPrecond.from_matrix(a)
        engp, e, _ = fdia.build_fused_dia(a, torch.float32,
                                          inv_diag=m.inv_diag,
                                          plane_dtype=bf16)
        eng32 = k3.FusedCG(engp.nx, engp.ny, engp.nz, engp.taps,
                           coeffs=engp.coeffs, planes=engp.planes.float(),
                           weight=engp.weight, sym=engp.sym)
        p = seeded_rhs(a.shape[0], dev)
        q, _, _ = engp.kernel_a(p)
        q32, _, _ = eng32.kernel_a(p)
        torch.cuda.synchronize()
        q_ref = engp.kernel_a_reference(p)[0]
        err = float((q - q_ref).abs().max())
        print(f"X2 K3 A bf16 planes one step at {label}: bitwise against "
              f"the plain version {torch.equal(q, q_ref)}, against fp32 on "
              f"the pre-rounded planes {torch.equal(q, q32)}")
        check(torch.equal(q, q_ref) and torch.equal(q, q32),
              f"X2 {label}: K3 A in bf16 planes differs")
        errs["a_planes"] = max(errs["a_planes"], err)
        fp32_eng, _, _ = fdia.build_fused_dia(a, torch.float32,
                                              inv_diag=m.inv_diag)
        steps[label] = (engp, fp32_eng, e * torch.ones(
            a.shape[0], dtype=torch.float32, device=dev), p, a)

    # -- X3. K2 with bf16 planes ---------------------------------------------
    # At DIA-7 the rounded operator is indefinite (cgx_torch/solve/ir.py's
    # note): K2 in bf16 planes breaks down there, as the JAX package's
    # would, so it is held over a fixed 100 iterations; DIA-27 converges.
    k2_runs = {}
    errs["k2_bf16"] = 0.0
    for label in ("DIA-27 128^3", "DIA-7 192^3"):
        a = dias[label]
        n = a.shape[0]
        m = cgx_torch.JacobiPrecond.from_matrix(a)
        b = torch.ones(n, dtype=torch.float32, device=dev)
        fixed = label.startswith("DIA-7")
        run = (dict(tol=0.0, maxiter=its_fixed) if fixed
               else dict(tol=TOL, maxiter=n))
        zero()
        res = k2.resident_dia_cg(a, b, inv_diag=m.inv_diag, plane_dtype=bf16,
                                 **run)
        torch.cuda.synchronize()
        c = counts()
        check(c["k2_bf16"] == 1 and c["k2"] == 1 and c["k3_a"] == 0,
              f"X3 {label}: resident_dia_cg(plane_dtype=bf16) launches {c}")
        check(bool(torch.isfinite(res.x).all())
              and (fixed or bool(res.converged)),
              f"X3 {label}: not converged")
        launches["k2_bf16"] += c["k2_bf16"]
        nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)
        spec = (nx, ny, nz, taps, coeffs)
        pl16 = planes.to(bf16)
        g16 = k2.resident_grid(spec, dev, planes=pl16, weight=w, sym=sym)
        g32 = k2.resident_grid(spec, dev, planes=planes, weight=w, sym=sym)
        grid = min(g16, g32)
        kw = dict(weight=w, sym=sym, **run)
        b_s = e * b
        x16, _, _, k16, rz16_, _ = k2.resident_cg_call(spec, b_s, planes=pl16,
                                                       grid=grid, **kw)
        x32, _, _, k32, rz32_, _ = k2.resident_cg_call(
            spec, b_s, planes=pl16.float(), grid=grid, **kw)
        xd = k2.resident_cg_call(spec, b_s, planes=pl16, **kw)[0]
        torch.cuda.synchronize()
        x_ref, _, _, k_ref, _, _ = k2.resident_cg_reference(
            spec, b_s, planes=pl16, **kw)
        same = (int(k16) == int(k32) and torch.equal(x16, x32)
                and torch.equal(rz16_, rz32_))
        dx = rel(x16, x_ref)
        fwd = ("not held (fixed iterations)" if fixed else
               f"{rel(e * x16, fp64_solution(label, 'ones', a, b)):.3e} "
               f"(the rounded operator's solution)")
        print(f"X3 K2 bf16 planes {label} b=ones: grids {g16} (bf16) and "
              f"{g32} (fp32), run at {grid}: {int(k16)} iterations, equal "
              f"to fp32 K2 on the pre-rounded planes bit for bit: {same}; "
              f"plain version {int(k_ref)} iterations, |x-x_plain|/"
              f"|x_plain| {dx:.3e}; the entry's solve at its own grid equal "
              f"to the call at {g16}: {torch.equal(res.x, e * xd)}; "
              f"|x-x64|/|x64| {fwd}")
        check(same, f"X3 {label}: bf16 K2 differs from fp32 K2 on the "
              f"pre-rounded planes")
        # On DIA-7's indefinite operator p·q nears 0 and K2's block sums,
        # in another order than the plain version's, set the trajectory:
        # there only the bitwise check against fp32 K2 holds.
        check(fixed or (abs(int(k16) - int(k_ref)) <= 2 and dx <= 1e-4),
              f"X3 {label}: K2 bf16 against its plain version")
        if not fixed:
            errs["k2_bf16"] = float((x16 - x_ref).abs().max())
        k2_runs[label] = (spec, b_s, pl16, planes, kw, int(k16), g16, g32)

    # -- X4. K5 with bf16 planes ---------------------------------------------
    d160 = dias["DIA-27 160^3"]
    n = d160.shape[0]
    m = cgx_torch.JacobiPrecond.from_matrix(d160)
    B = seeded_block(n, K_MULTI, SEED + 4, dev)
    zero()
    res = k5.fused_dia_cg_multi(d160, B, tol=TOL, maxiter=n,
                                inv_diag=m.inv_diag, plane_dtype=bf16)
    torch.cuda.synchronize()
    c = counts()
    check(c["k5_a_bf16"] > 0 and c["k5_a_bf16"] == c["k5_a"]
          and c["k5_b"] > 0 and c["k3_a"] == 0 and c["k2"] == 0,
          f"X4: fused_dia_cg_multi(plane_dtype=bf16) launches {c}")
    launches["k5_a_bf16"] = c["k5_a_bf16"]
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        d160, torch.float32, inv_diag=m.inv_diag)
    e160 = e
    eng5 = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                           weight=w, sym=sym, plane_dtype=bf16)
    pre = k5.FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs,
                          planes=eng5.planes.float(), weight=w, sym=sym)
    r_pre = pre.solve((B.T * e[None]).contiguous(), tol=TOL, maxiter=n)
    x_pre = r_pre.x * e[:, None]
    cols = [torch.equal(res.x[:, j], x_pre[:, j]) for j in range(K_MULTI)]
    P = seeded_block(n, K_MULTI, SEED + 3, dev).T.contiguous()
    q5, _, _ = eng5.kernel_a(P)
    torch.cuda.synchronize()
    q5_ref = eng5.kernel_a_reference(P)[0]
    errs["k5_a_bf16"] = float((q5 - q5_ref).abs().max())
    print(f"X4 K5 bf16 planes DIA-27 160^3, B ({n}, {K_MULTI}): "
          f"{int(res.iterations[0])} iterations shared (fp32 on the "
          f"pre-rounded planes {int(r_pre.iterations[0])}), each column "
          f"equal to it bit for bit: {cols}; converged "
          f"{res.converged.tolist()}; one step of K5 A against its plain "
          f"version bitwise: {torch.equal(q5, q5_ref)}")
    check(all(cols) and torch.equal(res.iterations, r_pre.iterations),
          "X4: K5 bf16 differs from fp32 K5 on the pre-rounded planes")
    check(torch.equal(q5, q5_ref), "X4: K5 A bf16 differs from its plain "
          "version")

    # -- X5. Times -------------------------------------------------------------
    per_iter, dev_us = {}, {}
    for label, (eng_n, eng_f, b_s, p, *_rest) in steps.items():
        b_n = b_s.to(eng_n.dtype)
        its_n = int(eng_n.solve(b_n, tol=0.0, maxiter=its_fixed).iterations)
        its_f = int(eng_f.solve(b_s, tol=0.0, maxiter=its_fixed).iterations)
        check(its_n == its_f == its_fixed,
              f"X5 {label}: {its_n} and {its_f} of {its_fixed} iterations")
        t_n, t_f = time_pair(
            lambda: eng_n.solve(b_n, tol=0.0, maxiter=its_fixed),
            lambda: eng_f.solve(b_s, tol=0.0, maxiter=its_fixed), reps=3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng_n.solve(b_n, tol=0.0, maxiter=its_fixed)
            torch.cuda.synchronize()
        ua, na = device_us(prof, lambda kk: "kernel_a<" in kk
                           and "bfloat16" in kk)
        ub, nb = device_us(prof, lambda kk: "kernel_b<" in kk)
        dev_us[label] = (ua / max(na, 1), ub / max(nb, 1))
        per_iter[label] = (t_n / its_fixed * 1e3, t_f / its_fixed * 1e3)
        pred = ("" if label.startswith("stencil") else
                f"; bf16_plane_speedup (TPU model) "
                f"{fdia.bf16_plane_speedup(_rest[-1], eng_n.n, 4):.3f}")
        mode = ("bf16 vectors" if eng_n.dtype == bf16 else
                "bf16 planes, fp32 vectors")
        print(f"[{card}] X5 K3 {label}, {its_fixed} iterations: {mode} "
              f"{per_iter[label][0]:.2f} us/iter, fp32 "
              f"{per_iter[label][1]:.2f} us/iter, measured fp32/narrow "
              f"{t_f / t_n:.3f}{pred}; device time per launch (profiler, "
              f"narrow): A {dev_us[label][0]:.2f} us, B "
              f"{dev_us[label][1]:.2f} us")

    # The probe ir_cg_solve takes before refining: the smoothest grid
    # mode's Rayleigh quotient under the bf16-plane and the fp32 engine.
    for label, (engp, eng32, *_rest) in steps.items():
        if engp.dtype == bf16:
            continue
        axes = [torch.sin(torch.pi * torch.arange(
            1, m_ + 1, dtype=torch.float64, device=dev) / (m_ + 1))
            for m_ in (engp.nx, engp.ny, engp.nz)]
        v = torch.einsum("i,j,k->ijk", *axes).reshape(-1).float()
        rq16, rq32 = (float(v.double() @ e_.kernel_a(v)[0].double())
                      / float(v.double() @ v.double())
                      for e_ in (engp, eng32))
        print(f"X5 smoothest-mode Rayleigh quotient at {label}: bf16 "
              f"planes {rq16:.4e}, fp32 {rq32:.4e}, ratio "
              f"{rq16 / rq32:.3f} (IR refines only at >= 0.5)")

    # Fault C2: torch's index_add_ (the CSR product before the port's
    # row-ordered sum) against row_sum, ten runs each, at poisson3d 128^3.
    from cgx_torch.io.poisson import poisson3d
    from cgx_torch.ops.spmv import row_sum

    a3 = poisson3d(*N128, dtype=np.float32, device=dev)
    prods = a3.values * seeded_rhs(a3.shape[0], dev)[a3.col_indices]

    def by_index_add():
        return torch.zeros(a3.shape[0], device=dev).index_add_(
            0, a3.row_indices, prods)

    def by_row_sum():
        return row_sum(a3.row_indices, prods, a3.shape[0], True)

    outs = {name: {fn().cpu().numpy().tobytes() for _ in range(10)}
            for name, fn in (("index_add_", by_index_add),
                             ("row_sum", by_row_sum))}
    t_rs, t_ia = time_pair(by_row_sum, by_index_add, inner=5)
    print(f"[{card}] X5 CSR product of poisson3d 128^3: index_add_ "
          f"{len(outs['index_add_'])} distinct results in 10 runs, "
          f"{t_ia * 1e3:.1f} us; row_sum {len(outs['row_sum'])}, "
          f"{t_rs * 1e3:.1f} us")
    check(len(outs["row_sum"]) == 1, "row_sum is not reproducible")
    del a3, prods

    # One call of each narrow kernel beside its plain version.
    eng16, _, _, p16, (rz16, pq_ref, qq_ref, x16, q_ref) = steps[
        "stencil 224^3"]
    t_a16, t_a16p = time_pair(lambda: eng16.kernel_a(p16),
                              lambda: eng16.kernel_a_reference(p16), inner=10)
    t_b16, t_b16p = time_pair(
        lambda: eng16.kernel_b(rz16, pq_ref, qq_ref, x16, p16, p16, q_ref),
        lambda: eng16.kernel_b_reference(rz16, pq_ref, qq_ref, x16, p16, p16,
                                         q_ref), inner=10)
    engp, _, _, pp, _ = steps["DIA-27 160^3"]
    t_ap, t_app = time_pair(lambda: engp.kernel_a(pp),
                            lambda: engp.kernel_a_reference(pp), inner=10)
    t_5, t_5p = time_pair(lambda: eng5.kernel_a(P),
                          lambda: eng5.kernel_a_reference(P), inner=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            eng5.kernel_a(P)
        torch.cuda.synchronize()
    u5, c5 = device_us(prof, lambda kk: "multi_a<" in kk)
    dev_k5 = u5 / max(c5, 1)
    print(f"[{card}] X5 one call from Python: K3 A bf16 vectors 224^3 "
          f"{t_a16 * 1e3:.2f} us (plain {t_a16p * 1e3:.2f}), K3 B bf16 "
          f"vectors {t_b16 * 1e3:.2f} us (plain {t_b16p * 1e3:.2f}; the "
          f"call copies x, r, p first), K3 A bf16 planes DIA-27 160^3 "
          f"{t_ap * 1e3:.2f} us (plain {t_app * 1e3:.2f}), K5 A bf16 "
          f"planes DIA-27 160^3 k={K_MULTI} {t_5 * 1e3:.2f} us (plain "
          f"{t_5p * 1e3:.2f}; device {dev_k5:.2f} us per launch)")

    # K2: 100 iterations (tol 0) in bf16 planes beside fp32, each at its
    # own grid, and the plain version of the same run.
    k2_ms = {}
    for label, (spec, b_s, pl16, planes, kw, its16, g16, g32) in \
            k2_runs.items():
        kf = dict(kw, tol=0.0, maxiter=its_fixed)
        t16, t32 = time_pair(
            lambda: k2.resident_cg_call(spec, b_s, planes=pl16, **kf),
            lambda: k2.resident_cg_call(spec, b_s, planes=planes, **kf),
            reps=3)
        tp = event_ms(lambda: k2.resident_cg_reference(spec, b_s,
                                                       planes=pl16, **kf))
        k2_ms[label] = (t16, tp)
        print(f"[{card}] X5 K2 {label} b=ones, {its_fixed} iterations: bf16 "
              f"planes {t16:.3f} ms, {t16 / its_fixed * 1e3:.2f} us/iter "
              f"(grid {g16}); fp32 {t32:.3f} ms, "
              f"{t32 / its_fixed * 1e3:.2f} us/iter (grid {g32}); fp32/bf16 "
              f"{t32 / t16:.3f}; plain {tp:.1f} ms")

    # IR per inner iteration beside the fp32 solves (K3 and K2), b = ones.
    for label, (a, m) in cells.items():
        n = a.shape[0]
        b = torch.ones(n, dtype=torch.float32, device=dev)
        its_ir = ir_runs[label, "ones"][0]
        eng32 = steps[label][1]
        e = (None if m is None else fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)[6])
        b_s = b if e is None else e * b
        its32 = int(eng32.solve(b_s, tol=TOL, maxiter=n).iterations)
        its_k2 = int(cgx_torch.auto_solve(a, b, tol=TOL,
                                          preconditioner=m).iterations)
        t_ir, t_32 = time_pair(
            lambda: cgx_torch.auto_solve(a, b, tol=TOL, preconditioner=m,
                                         mixed_precision=True),
            lambda: eng32.solve(b_s, tol=TOL, maxiter=n), reps=3)
        t_k2 = statistics.median(event_ms(lambda: cgx_torch.auto_solve(
            a, b, tol=TOL, preconditioner=m)) for _ in range(3))
        print(f"[{card}] X5 IR {label} b=ones: {t_ir:.2f} ms, {its_ir} inner "
              f"iterations, {t_ir / its_ir * 1e3:.2f} us per inner "
              f"iteration; fp32 K3 {t_32:.2f} ms, {its32} iterations, "
              f"{t_32 / its32 * 1e3:.2f} us/iter; fp32 K2 (auto_solve "
              f"without mixed_precision) {t_k2:.2f} ms, {its_k2} iterations;"
              f" IR / K3 {t_ir / t_32:.3f}, IR / K2 {t_ir / t_k2:.3f}")

    # PyTorch calls computing the same functions: conv3d in bf16 (K3 A's
    # stencil product) and the CSR product of Ã with its values rounded
    # through bf16 (K3 A's and K5 A's plane-mode products).
    wk = torch.zeros((1, 1, 3, 3, 3), device=dev, dtype=bf16)
    wk[0, 0, 1, 1, 1] = 6.0
    for tap in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        wk[(0, 0) + tap] = -1.0
    xv = p16.view(1, 1, *N224)

    def conv():
        return torch.nn.functional.conv3d(xv, wk, padding=1)

    q16 = eng16.kernel_a_reference(p16)[0]
    check(maxrel(conv().reshape(-1), q16) <= 2.0 ** -6,
          "bf16 conv3d does not compute K3 A's bf16 product")
    conv()
    t_conv = statistics.median(event_ms(conv, inner=10) for _ in range(5))
    csr = scaled_csr(d160, e160)
    csr16 = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                    csr.values().to(bf16).float(),
                                    size=csr.shape)
    del csr
    qp = engp.kernel_a_reference(pp)[0]
    pc = pp[:, None]
    # The CSR takes each value from its own triangle, the symmetric engine
    # mirrors the upper one: fp32 values an ulp apart can round a bf16 ulp
    # apart, so the same function is held to 2⁻⁸ here.
    check(maxrel((csr16 @ pc)[:, 0], qp) <= 2.0 ** -8,
          "the CSR product does not compute K3 A's bf16-plane product")
    t_csr = statistics.median(event_ms(lambda: csr16 @ pc, inner=10)
                              for _ in range(5))
    pn = P.T.contiguous()
    t_csr5 = statistics.median(event_ms(lambda: csr16 @ pn, inner=5)
                               for _ in range(3))
    del csr16
    print(f"[{card}] X5 PyTorch calls: conv3d bf16 at 224^3 "
          f"{t_conv * 1e3:.2f} us; CSR product of Ã (bf16-rounded values) "
          f"at DIA-27 160^3, k=1 {t_csr * 1e3:.2f} us, k={K_MULTI} "
          f"{t_csr5 * 1e3:.2f} us")

    # Bounds: each input read once and each output written once, 2 B per
    # bf16 value and 4 B per fp32 one, against the fp32 operations.
    n224 = a224.shape[0]
    n_pl = engp.planes.shape[0]
    n160 = engp.n
    terms = sum(2 if (c is None and engp.sym and tap != (0, 0, 0)) else 1
                for tap, c in zip(engp.taps, engp.coeffs))
    b_a16 = bound(4 * n224, n224 * (2 * 7 + 4))
    b_b16 = bound(14 * n224, 12 * n224)
    b_ap = bound((2 * n_pl + 8) * n160, n160 * (2 * terms + 4))
    b_5 = bound((2 * n_pl + 8 * K_MULTI) * n160,
                K_MULTI * n160 * (2 * terms + 4))
    spec27, _, pl27, _, _, _, _, _ = k2_runs["DIA-27 128^3"]
    n128 = N128[0] * N128[1] * N128[2]
    b_k2 = bound((2 * pl27.shape[0] + 12) * n128,
                 its_fixed * n128 * (2 * len(spec27[3]) + 12))
    print(f"X5 bounds: K3 A bf16 {b_a16[0] * 1e3:.2f} us ({b_a16[1]}), K3 B "
          f"bf16 {b_b16[0] * 1e3:.2f} us, K3 A bf16 planes DIA-27 160^3 "
          f"{b_ap[0] * 1e3:.2f} us, K5 A bf16 planes {b_5[0] * 1e3:.2f} us,"
          f" K2 bf16 planes DIA-27 128^3 {b_k2[0]:.3f} ms per "
          f"{its_fixed} iterations ({b_k2[1]})")

    def entry(name, source, replaces, nl, err, ms, plain_ms, b, lib):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": nl, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib}

    eng_src = "cgx_torch/csrc/fused_engine.cu"
    return [
        entry("fused_kernel_a_bf16", eng_src,
              "cgx/kernels/fused_engine.py:272", launches["a_bf16"],
              errs["a_bf16"], dev_us["stencil 224^3"][0] / 1e3, t_a16p,
              b_a16, t_conv),
        entry("fused_kernel_b_bf16", eng_src,
              "cgx/kernels/fused_engine.py:411", launches["b_bf16"],
              errs["b_bf16"], dev_us["stencil 224^3"][1] / 1e3, t_b16p,
              b_b16, None),
        entry("fused_kernel_a_bf16_planes", eng_src,
              "cgx/kernels/fused_engine.py:272", launches["a_planes"],
              errs["a_planes"], dev_us["DIA-27 160^3"][0] / 1e3, t_app,
              b_ap, t_csr),
        entry("resident_cg_planes_bf16", "cgx_torch/csrc/resident_cg.cu",
              "cgx/kernels/fused_resident.py:115", launches["k2_bf16"],
              errs["k2_bf16"], k2_ms["DIA-27 128^3"][0],
              k2_ms["DIA-27 128^3"][1], b_k2, None),
        entry("fused_multi_a_bf16_planes", "cgx_torch/csrc/fused_multi.cu",
              "cgx/kernels/fused_multi.py:64", launches["k5_a_bf16"],
              errs["k5_a_bf16"], dev_k5 / 1e3, t_5p, b_5, t_csr5),
    ]


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        sys.exit(2)

    import cgx_torch
    from cgx_torch.kernels import _build
    from cgx_torch.kernels import fused_resident as k2
    from cgx_torch.kernels import stencil as k1
    from cgx_torch.kernels.fused_cg import stencil_taps

    check("jax" not in sys.modules and "cgx" not in sys.modules,
          "the port imported JAX or the JAX package")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = card_line()

    # -- 1. device --------------------------------------------------------
    print(f"device: {name}")
    print(f"nvidia-smi: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"toolchain: {json.dumps(_build.probe())}")

    # -- 2. build ---------------------------------------------------------
    so, secs = _build.build()
    _build.library()
    print(f"build: {so.name} in {secs:.1f} s")

    # -- 3. K1 against its plain version ------------------------------------
    rng = np.random.default_rng(SEED)
    k1_err = {}
    for dims in (N128, (37, 41, 53)):
        nx, ny, nz = dims
        x = torch.from_numpy(
            rng.standard_normal(nx * ny * nz).astype(np.float32)).to(dev)
        before = k1.stencil3d_spmv_launches
        y = k1.stencil3d_spmv(x, nx=nx, ny=ny, nz=nz)
        torch.cuda.synchronize()
        y_ref = k1.stencil3d_spmv_reference(x, nx, ny, nz)
        err = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max())
        print(f"K1 {nx}x{ny}x{nz}: max|y-y_ref| = {err:.3e} "
              f"(bound 1e-6 * {scale:.3e})")
        check(k1.stencil3d_spmv_launches == before + 1,
              "K1 launch counter did not move")
        check(err <= 1e-6 * scale, f"K1 disagrees at {dims}: {err}")
        k1_err[dims] = err

    # -- 4. the main path, as users drive it --------------------------------
    a128 = cgx_torch.poisson3d_stencil(*N128)
    a224 = cgx_torch.poisson3d_stencil(*N224)
    cases = [(a128, nm, b) for nm, b in rhs_set(N128, dev).items()]
    n224 = a224.shape[0]
    cases.append((a224, "ones", torch.ones(n224, dtype=torch.float32,
                                           device=dev)))
    for a, _, b in cases:
        check(cgx_torch.select_backend(a, b) == "resident_stencil",
              f"{a.nx}^3 routed to {cgx_torch.select_backend(a, b)}")

    k1.stencil3d_spmv_launches = 0
    k2.resident_cg_launches = 0
    results = []
    for a, nm, b in cases:
        before = k2.resident_cg_launches
        res = cgx_torch.auto_solve(a, b, tol=TOL)
        r32 = b - cgx_torch.spmv(a, res.x)
        torch.cuda.synchronize()
        check(k2.resident_cg_launches == before + 1,
              "auto_solve did not launch K2 exactly once")
        results.append((a, nm, b, res, r32))
    launches = {"k1": k1.stencil3d_spmv_launches,
                "k2": k2.resident_cg_launches}
    print(f"main path launches: K1 {launches['k1']}, K2 {launches['k2']}")
    check(launches["k1"] >= len(cases) and launches["k2"] == len(cases),
          f"main path did not run through both kernels: {launches}")

    k2_err = 0.0
    for a, nm, b, res, r32 in results:
        its = int(res.iterations)
        x_ref, _, _, k_ref, _, _ = k2.resident_cg_reference(
            stencil_taps(a), b, tol=TOL, maxiter=a.shape[0])
        its_ref = int(k_ref)
        # The fp64 solution of the same system, for the forward error.
        x64 = cgx_torch.cg_solve(a.matvec, b.double(), tol=1e-10,
                                 maxiter=5000).x
        relres, relres_ref = true_relres(a, b, res.x), true_relres(a, b, x_ref)
        relres32 = float(torch.linalg.vector_norm(r32)
                         / torch.linalg.vector_norm(b))
        dx = float(torch.linalg.vector_norm(res.x - x_ref)
                   / torch.linalg.vector_norm(x_ref))
        fwd = float(torch.linalg.vector_norm(res.x.double() - x64)
                    / torch.linalg.vector_norm(x64))
        if a is a128:
            k2_err = max(k2_err, float((res.x - x_ref).abs().max()))
        print(f"K2 {a.nx}^3 b={nm}: iterations {its} (plain {its_ref}), "
              f"converged {bool(res.converged)}, true relres (fp64) "
              f"{relres:.3e} (plain {relres_ref:.3e}), relres via spmv "
              f"(fp32) {relres32:.3e}, |x-x_ref|/|x_ref| {dx:.3e}, "
              f"|x-x64|/|x64| {fwd:.3e}")
        check(bool(res.converged), f"{a.nx}^3 b={nm} did not converge")
        # The fp32 recurrence drifts from the true residual (x is summed in
        # fp32 over hundreds of updates); the kernel must drift no more
        # than its plain version does on the same input.
        check(relres <= 1.5 * relres_ref,
              f"{a.nx}^3 b={nm}: true relres {relres} vs plain {relres_ref}")
        check(abs(its - its_ref) <= 2,
              f"{a.nx}^3 b={nm}: {its} vs plain {its_ref} iterations")
        check(dx <= 1e-4, f"{a.nx}^3 b={nm}: x differs by {dx}")
        check(fwd <= 1e-4, f"{a.nx}^3 b={nm}: forward error {fwd}")
        if a is a128 and nm == "ones":
            print(f"K2 128^3 b=ones: {its} iterations; the JAX package "
                  f"took {JAX_ITERS_ONES_128} (BENCH_r05.json) — a check "
                  f"of the trajectory, not a speed figure")
            check(295 <= its <= 305, f"b=ones took {its} iterations")

    b1 = results[0][2]
    r_a = cgx_torch.auto_solve(a128, b1, tol=TOL)
    r_b = cgx_torch.auto_solve(a128, b1, tol=TOL)
    same = (int(r_a.iterations) == int(r_b.iterations)
            and torch.equal(r_a.x, r_b.x))
    print(f"K2 reproducible: {same}")
    check(same, "two K2 runs on the same input differ")

    # -- 5. times -----------------------------------------------------------
    nx, ny, nz = N128
    n = nx * ny * nz
    nnz = 7 * n - 6 * nx * ny
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    t_k1, t_k1p = time_pair(
        lambda: k1.stencil3d_spmv(x, nx=nx, ny=ny, nz=nz),
        lambda: k1.stencil3d_spmv_reference(x, nx, ny, nz), inner=20)
    # One PyTorch call that computes K1's function: conv3d with the seven
    # taps in a 3x3x3 kernel, padding 1, in full fp32 (cuDNN's TF32 off).
    torch.backends.cudnn.allow_tf32 = False
    wk = torch.zeros((1, 1, 3, 3, 3), device=dev)
    wk[0, 0, 1, 1, 1] = 6.0
    for tap in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        wk[(0, 0) + tap] = -1.0
    xv = x.view(1, 1, nx, ny, nz)

    def conv():
        return torch.nn.functional.conv3d(xv, wk, padding=1)

    check(maxrel(conv().reshape(-1), k1.stencil3d_spmv_reference(
        x, nx, ny, nz)) <= 1e-6, "conv3d does not compute K1's function")
    conv()
    t_conv = statistics.median(event_ms(conv, inner=20) for _ in range(5))
    print(f"[{card}] K1 128^3: {t_k1 * 1e3:.2f} us/SpMV "
          f"({nnz / (t_k1 * 1e-3) / 1e9:.1f} Gnnz/s); plain "
          f"{t_k1p * 1e3:.2f} us ({nnz / (t_k1p * 1e-3) / 1e9:.1f} Gnnz/s); "
          f"conv3d {t_conv * 1e3:.2f} us")

    k2_ms, k2_its = {}, {}
    for a in (a128, a224):
        b = torch.ones(a.shape[0], dtype=torch.float32, device=dev)
        spec = stencil_taps(a)
        its = int(cgx_torch.auto_solve(a, b, tol=TOL).iterations)
        its_ref = int(k2.resident_cg_reference(spec, b, tol=TOL,
                                               maxiter=a.shape[0])[3])
        t_k2, t_k2p = time_pair(
            lambda: cgx_torch.auto_solve(a, b, tol=TOL),
            lambda: k2.resident_cg_reference(spec, b, tol=TOL,
                                             maxiter=a.shape[0]), reps=5)
        k2_ms[a.nx] = (t_k2, t_k2p)
        k2_its[a.nx] = its
        print(f"[{card}] K2 {a.nx}^3 b=ones: {t_k2:.3f} ms/solve, "
              f"{t_k2 / its * 1e3:.2f} us/iter ({its} it); plain "
              f"{t_k2p:.3f} ms/solve, {t_k2p / its_ref * 1e3:.2f} us/iter "
              f"({its_ref} it)")

    # -- 6. the Jacobi-PCG path over DIA operators ---------------------------
    from cgx_torch.io.poisson import poisson3d_dia27
    from cgx_torch.kernels import fused_dia_cg as fdia
    from cgx_torch.kernels import fused_engine as k3
    from cgx_torch.kernels.fused_cg import build_fused
    from cgx_torch.solve.auto import FUSED_MIN_ROWS

    t0 = time.perf_counter()
    dias = {"DIA-7 192^3": scaled_dia7(N192, dev),
            "DIA-27 128^3": poisson3d_dia27(*N128, variable=True,
                                            seed=SEED).to(dev)}
    print(f"DIA operators built in {time.perf_counter() - t0:.1f} s")
    dia_cases = []
    for label, a in dias.items():
        m = cgx_torch.JacobiPrecond.from_matrix(a)
        n = a.shape[0]
        rhs = {"ones": torch.ones(n, dtype=torch.float32, device=dev),
               "random": torch.from_numpy(np.random.default_rng(SEED)
                                          .standard_normal(n)
                                          .astype(np.float32)).to(dev)}
        for nm, b in rhs.items():
            route = cgx_torch.select_backend(a, b, m)
            check(route == "resident_dia", f"{label} routed to {route}")
            dia_cases.append((label, a, m, nm, b))

    k2.resident_cg_launches = k2.resident_dia_launches = 0
    k3.fused_a_launches = k3.fused_b_launches = 0
    dia_results = []
    for label, a, m, nm, b in dia_cases:
        before = k2.resident_dia_launches
        res = cgx_torch.auto_solve(a, b, tol=TOL, preconditioner=m)
        torch.cuda.synchronize()
        check(k2.resident_dia_launches == before + 1,
              f"{label} b={nm}: auto_solve did not launch K2 (planes) once")
        check(bool(res.converged), f"{label} b={nm} did not converge")
        dia_results.append(res)
    launches["k2_planes"] = k2.resident_dia_launches
    print(f"DIA path launches: K2 planes {launches['k2_planes']}, K2 const "
          f"{k2.resident_cg_launches}, K3 A {k3.fused_a_launches}")
    check(launches["k2_planes"] == len(dia_cases)
          and k2.resident_cg_launches == 0 and k3.fused_a_launches == 0,
          "the DIA path did not run through K2's planes mode alone")

    # -- 7. the history path (K3) ----------------------------------------
    a7, m7 = dias["DIA-7 192^3"], dia_cases[0][2]
    b7 = dia_cases[0][4]
    b224 = torch.ones(n224, dtype=torch.float32, device=dev)
    hist_cases = [("DIA-7 192^3 b=ones", a7, m7, b7),
                  ("stencil 224^3 b=ones", a224, None, b224)]
    for _, a, _, b in hist_cases:
        check(b.shape[0] >= FUSED_MIN_ROWS, "history case below the "
              "two-pass engine's size")
    k2.resident_cg_launches = k2.resident_dia_launches = 0
    k3.fused_a_launches = k3.fused_b_launches = 0
    hist_results = []
    for label, a, m, b in hist_cases:
        before = (k3.fused_a_launches, k3.fused_b_launches)
        res = cgx_torch.auto_solve(a, b, tol=TOL, preconditioner=m,
                                   maxiter=MAXIT_HIST, track_history=True)
        torch.cuda.synchronize()
        its = int(res.iterations)
        da = k3.fused_a_launches - before[0]
        db = k3.fused_b_launches - before[1]
        print(f"K3 {label}: {its} iterations, {da} A and {db} B launches, "
              f"history length {res.history.shape[0]}")
        check(bool(res.converged), f"K3 {label} did not converge")
        check(da >= its + 1 and db >= its,
              f"K3 {label}: {da} A / {db} B launches for {its} iterations")
        check(res.history.shape == (MAXIT_HIST + 1,),
              f"K3 {label}: history of shape {tuple(res.history.shape)}")
        hist_results.append(res)
    launches["k3_a"] = k3.fused_a_launches
    launches["k3_b"] = k3.fused_b_launches
    check(k2.resident_cg_launches == 0 and k2.resident_dia_launches == 0,
          "the history path launched K2")

    # -- 8. held against the plain versions and fp64 ----------------------
    k2p_err = 0.0
    x64_cache = {}

    def fp64_solution(label, nm, a, b):
        """The fp64 Jacobi-PCG (DIA) or CG (stencil) solution of the same
        system, to 1e-10."""
        if (label, nm) not in x64_cache:
            if isinstance(a, cgx_torch.DIAMatrix):
                a64 = a.astype(torch.float64)
                x64_cache[label, nm] = cgx_torch.cg_solve(
                    a64, b.double(), tol=1e-10, maxiter=20000,
                    preconditioner=cgx_torch.JacobiPrecond.from_matrix(
                        a64)).x
            else:
                x64_cache[label, nm] = cgx_torch.cg_solve(
                    a.matvec, b.double(), tol=1e-10, maxiter=20000).x
        return x64_cache[label, nm]

    def relres_of(a, b, x):
        if isinstance(a, cgx_torch.DIAMatrix):
            b64 = b.double()
            r = b64 - cgx_torch.spmv(a.astype(torch.float64), x.double())
            return float(torch.linalg.vector_norm(r)
                         / torch.linalg.vector_norm(b64))
        return true_relres(a, b, x)

    for (label, a, m, nm, b), res in zip(dia_cases, dia_results):
        nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)
        x_s, _, _, k_ref, _, _ = k2.resident_cg_reference(
            (nx, ny, nz, taps, coeffs), e * b, planes=planes, weight=w,
            sym=sym, tol=TOL, maxiter=a.shape[0])
        x_ref = e * x_s
        x64 = fp64_solution(label, nm, a, b)
        hold(f"K2 planes {label} b={nm}", res.x, int(res.iterations),
             x_ref, int(k_ref), relres_of(a, b, res.x),
             relres_of(a, b, x_ref), rel(res.x, x64), rel(x_ref, x64))
        k2p_err = max(k2p_err, float((res.x - x_ref).abs().max()))

    engines = {}
    for (label, a, m, b), res in zip(hist_cases, hist_results):
        if m is None:
            eng, e = build_fused(a, torch.float32), None
        else:
            eng, e, _ = fdia.build_fused_dia(a, torch.float32,
                                             inv_diag=m.inv_diag)
        engines[label] = (eng, e, b)
        b_s = b if e is None else e * b
        ref = eng.solve_reference(b_s, tol=TOL, maxiter=MAXIT_HIST,
                                  track_history=True)
        x_ref = ref.x if e is None else e * ref.x
        x64 = fp64_solution(label.split(" b=")[0], "ones", a, b)
        hold(f"K3 {label}", res.x, int(res.iterations), x_ref,
             int(ref.iterations), relres_of(a, b, res.x),
             relres_of(a, b, x_ref), rel(res.x, x64), rel(x_ref, x64))
        k = min(int(res.iterations), int(ref.iterations))
        h, h_ref = res.history[:k + 1], ref.history[:k + 1]
        hdev = float(((h - h_ref).abs() / h_ref.abs()).max())
        print(f"K3 {label}: history over {k + 1} entries within {hdev:.3e} "
              f"of the plain version's (bound 2e-2)")
        check(hdev <= 2e-2, f"K3 {label}: history differs by {hdev}")

    r_a = cgx_torch.auto_solve(a7, b7, tol=TOL, preconditioner=m7)
    r_b = cgx_torch.auto_solve(a7, b7, tol=TOL, preconditioner=m7)
    same_k2 = (int(r_a.iterations) == int(r_b.iterations)
               and torch.equal(r_a.x, r_b.x))
    h_a = cgx_torch.auto_solve(a7, b7, tol=TOL, preconditioner=m7,
                               maxiter=MAXIT_HIST, track_history=True)
    h_b = cgx_torch.auto_solve(a7, b7, tol=TOL, preconditioner=m7,
                               maxiter=MAXIT_HIST, track_history=True)
    same_k3 = (int(h_a.iterations) == int(h_b.iterations)
               and torch.equal(h_a.x, h_b.x)
               and torch.equal(h_a.history, h_b.history))
    print(f"K2 planes reproducible: {same_k2}; K3 reproducible: {same_k3}")
    check(same_k2 and same_k3, "two runs on the same input differ")

    # K3's kernels one step each at the main path's shapes.
    k3_err = {"a": 0.0, "b": 0.0}
    for label, (eng, e, b) in engines.items():
        p = b if e is None else e * b
        q, pq, qq = eng.kernel_a(p)
        q_ref, pq_ref, qq_ref = eng.kernel_a_reference(p)
        err_a = float((q - q_ref).abs().max())
        rz = torch.sum(p * p)
        out = eng.kernel_b(rz, pq_ref, qq_ref, torch.zeros_like(p), p, p,
                           q_ref)
        out_ref = eng.kernel_b_reference(rz, pq_ref, qq_ref,
                                         torch.zeros_like(p), p, p, q_ref)
        err_b = max(float((g - r).abs().max())
                    for g, r in zip(out[:3], out_ref[:3]))
        scale_b = max(float(r.abs().max()) for r in out_ref[:3])
        sums_dev = max(abs(float(g) - float(r)) / abs(float(r))
                       for g, r in ((pq, pq_ref), (qq, qq_ref))
                       + tuple(zip(out[3:], out_ref[3:])))
        print(f"K3 one step, {label}: A max|q-q_ref| {err_a:.3e} (bound "
              f"1e-6 * {float(q_ref.abs().max()):.3e}), B max|x,r,p - "
              f"plain| {err_b:.3e} (bound 1e-6 * {scale_b:.3e}), sums "
              f"within {sums_dev:.3e} (bound 1e-5)")
        check(err_a <= 1e-6 * float(q_ref.abs().max()), "K3 A disagrees")
        check(err_b <= 1e-6 * scale_b, "K3 B disagrees")
        check(sums_dev <= 1e-5, "K3 sums disagree")
        k3_err["a"] = max(k3_err["a"], err_a)
        k3_err["b"] = max(k3_err["b"], err_b)

    # -- 9. times -----------------------------------------------------------
    k2p_ms = {}
    for label, a in dias.items():
        m = cgx_torch.JacobiPrecond.from_matrix(a)
        b = torch.ones(a.shape[0], dtype=torch.float32, device=dev)
        nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
            a, torch.float32, inv_diag=m.inv_diag)
        spec, b_s = (nx, ny, nz, taps, coeffs), e * b
        kw = dict(planes=planes, weight=w, sym=sym, tol=TOL,
                  maxiter=a.shape[0])
        its = int(k2.resident_cg_call(spec, b_s, **kw)[3])
        its_ref = int(k2.resident_cg_reference(spec, b_s, **kw)[3])
        t_k, t_p = time_pair(lambda: k2.resident_cg_call(spec, b_s, **kw),
                             lambda: k2.resident_cg_reference(spec, b_s,
                                                              **kw), reps=3)
        k2p_ms[label] = (t_k, t_p, planes.shape[0], len(taps), its)
        print(f"[{card}] K2 planes {label} b=ones: {t_k:.3f} ms/solve, "
              f"{t_k / its * 1e3:.2f} us/iter ({its} it, {len(taps)} taps, "
              f"{planes.shape[0]} planes, sym {sym}); plain {t_p:.3f} "
              f"ms/solve, {t_p / its_ref * 1e3:.2f} us/iter ({its_ref} it)")

    k3_us = {}
    for label, (eng, e, b) in engines.items():
        b_s = b if e is None else e * b
        its = int(eng.solve(b_s, tol=TOL, maxiter=MAXIT_HIST,
                            track_history=True).iterations)
        its_ref = int(eng.solve_reference(b_s, tol=TOL, maxiter=MAXIT_HIST,
                                          track_history=True).iterations)
        t_k, t_p = time_pair(
            lambda: eng.solve(b_s, tol=TOL, maxiter=MAXIT_HIST,
                              track_history=True),
            lambda: eng.solve_reference(b_s, tol=TOL, maxiter=MAXIT_HIST,
                                        track_history=True), reps=3)
        k3_us[label] = (t_k / its * 1e3, t_p / its_ref * 1e3)
        print(f"[{card}] K3 {label} (history): {t_k:.3f} ms/solve, "
              f"{k3_us[label][0]:.2f} us/iter ({its} it); plain {t_p:.3f} "
              f"ms/solve, {k3_us[label][1]:.2f} us/iter ({its_ref} it)")
    its224 = int(cgx_torch.auto_solve(a224, b224, tol=TOL).iterations)
    print(f"[{card}] 224^3 b=ones: K2 constant mode "
          f"{k2_ms[224][0] / its224 * 1e3:.2f} us/iter beside K3 "
          f"{k3_us['stencil 224^3 b=ones'][0]:.2f} us/iter")

    eng7, e7, b7_ = engines["DIA-7 192^3 b=ones"]
    p7 = e7 * b7_
    q7, pq7, qq7 = eng7.kernel_a_reference(p7)
    rz7 = torch.sum(p7 * p7)
    z7 = torch.zeros_like(p7)
    t_a, t_ap = time_pair(lambda: eng7.kernel_a(p7),
                          lambda: eng7.kernel_a_reference(p7), inner=20)
    t_b, t_bp = time_pair(
        lambda: eng7.kernel_b(rz7, pq7, qq7, z7, p7, p7, q7),
        lambda: eng7.kernel_b_reference(rz7, pq7, qq7, z7, p7, p7, q7),
        inner=20)
    # One PyTorch call that computes K3 A's product (without its sums):
    # torch's CSR product of Ã.
    csr7 = scaled_csr(dias["DIA-7 192^3"], e7)
    pc7 = p7[:, None]
    check(maxrel((csr7 @ pc7)[:, 0], q7) <= 1e-5,
          "the CSR product does not compute K3 A's product")
    t_csr7 = statistics.median(event_ms(lambda: csr7 @ pc7, inner=20)
                               for _ in range(5))
    del csr7
    print(f"[{card}] K3 one call from Python at DIA-7 192^3: A "
          f"{t_a * 1e3:.2f} us (plain {t_ap * 1e3:.2f} us; torch's CSR "
          f"product of Ã alone {t_csr7 * 1e3:.2f} us), B "
          f"{t_b * 1e3:.2f} us (plain {t_bp * 1e3:.2f} us)")

    w_entries = wbell_phases(dev, card)
    m_entries = multi_phases(dev, card, dias)
    b_entries = bsr_phases(dev, card)
    x_entries = mixed_phases(dev, card, dias, fp64_solution, relres_of)

    # Bounds: each input read once, each output written once (4 B words),
    # against the operations at the fp32 rate.  K1: x in, y out, 2 flops
    # per stored entry.  K2 per solve: b in, x out (its planes and weight
    # in), per iteration the operator's 2 flops per entry plus 10 per row
    # for the dots and updates.  K3 one call: A reads p and its planes and
    # writes q; B reads x, r, p, q, w and writes x, r, p.
    n128 = N128[0] * N128[1] * N128[2]
    k1_b = bound(8 * n128, 2 * nnz - n128)
    k2_b = bound(8 * n128, k2_its[128] * (2 * nnz + 10 * n128))
    n_pl, n_taps, its7 = k2p_ms["DIA-7 192^3"][2:]
    n192 = N192[0] * N192[1] * N192[2]
    k2p_b = bound((n_pl + 3) * 4 * n192, its7 * n192 * (2 * n_taps + 12))
    k3a_b = bound((eng7.planes.shape[0] + 2) * 4 * eng7.n,
                  eng7.n * (2 * len(eng7.taps) + 4))
    k3b_b = bound(8 * 4 * eng7.n, 12 * eng7.n)

    def entry(name, source, replaces, launches, err, ms, plain_ms, b,
              library_ms=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1],
                "library_ms": library_ms}

    report = {"kernels": [
        entry("stencil3d_spmv", "cgx_torch/csrc/stencil.cu",
              "cgx/kernels/stencil.py:29", launches["k1"], k1_err[N128],
              t_k1, t_k1p, k1_b, t_conv),
        entry("resident_cg", "cgx_torch/csrc/resident_cg.cu",
              "cgx/kernels/fused_resident.py:115", launches["k2"], k2_err,
              k2_ms[128][0], k2_ms[128][1], k2_b),
        entry("resident_cg_planes", "cgx_torch/csrc/resident_cg.cu",
              "cgx/kernels/fused_resident.py:115", launches["k2_planes"],
              k2p_err, k2p_ms["DIA-7 192^3"][0], k2p_ms["DIA-7 192^3"][1],
              k2p_b),
        entry("fused_kernel_a", "cgx_torch/csrc/fused_engine.cu",
              "cgx/kernels/fused_engine.py:272", launches["k3_a"],
              k3_err["a"], t_a, t_ap, k3a_b, t_csr7),
        entry("fused_kernel_b", "cgx_torch/csrc/fused_engine.cu",
              "cgx/kernels/fused_engine.py:411", launches["k3_b"],
              k3_err["b"], t_b, t_bp, k3b_b),
    ] + w_entries + m_entries + b_entries + x_entries}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)

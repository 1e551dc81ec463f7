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
   its plain version, and K2's constant mode beside K3 at 224³.

The launch counters are set to 0 just before each of the paths 4, 6 and 7
and read just after it.  The line before the last is a JSON object
describing each kernel; the last line is ``{"ok": true, "device":
{...}}``.  Needs one CUDA card; it imports neither JAX nor the JAX
package.
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
TOL = 1e-6
JAX_ITERS_ONES_128 = 300  # the JAX package's count (BENCH_r05.json)
MAXIT_HIST = 5000         # maxiter of the history solves


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


def time_pair(kernel, plain, reps: int = 7, inner: int = 1):
    """Median ms per call of ``kernel`` and ``plain``, interleaved."""
    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner

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

    a = poisson3d_dia(*dims)
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
    print(f"[{card}] K1 128^3: {t_k1 * 1e3:.2f} us/SpMV "
          f"({nnz / (t_k1 * 1e-3) / 1e9:.1f} Gnnz/s); plain "
          f"{t_k1p * 1e3:.2f} us ({nnz / (t_k1p * 1e-3) / 1e9:.1f} Gnnz/s)")

    k2_ms = {}
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
        k2p_ms[label] = (t_k, t_p)
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
    print(f"[{card}] K3 one call from Python at DIA-7 192^3: A "
          f"{t_a * 1e3:.2f} us (plain {t_ap * 1e3:.2f} us), B "
          f"{t_b * 1e3:.2f} us (plain {t_bp * 1e3:.2f} us)")

    report = {"kernels": [
        {"name": "stencil3d_spmv", "route": "cuda",
         "source": "cgx_torch/csrc/stencil.cu",
         "replaces": "cgx/kernels/stencil.py:29",
         "launches": launches["k1"], "max_abs_err": k1_err[N128],
         "ms": t_k1, "plain_ms": t_k1p},
        {"name": "resident_cg", "route": "cuda",
         "source": "cgx_torch/csrc/resident_cg.cu",
         "replaces": "cgx/kernels/fused_resident.py:115",
         "launches": launches["k2"], "max_abs_err": k2_err,
         "ms": k2_ms[128][0], "plain_ms": k2_ms[128][1]},
        {"name": "resident_cg_planes", "route": "cuda",
         "source": "cgx_torch/csrc/resident_cg.cu",
         "replaces": "cgx/kernels/fused_resident.py:115",
         "launches": launches["k2_planes"], "max_abs_err": k2p_err,
         "ms": k2p_ms["DIA-7 192^3"][0],
         "plain_ms": k2p_ms["DIA-7 192^3"][1]},
        {"name": "fused_kernel_a", "route": "cuda",
         "source": "cgx_torch/csrc/fused_engine.cu",
         "replaces": "cgx/kernels/fused_engine.py:272",
         "launches": launches["k3_a"], "max_abs_err": k3_err["a"],
         "ms": t_a, "plain_ms": t_ap},
        {"name": "fused_kernel_b", "route": "cuda",
         "source": "cgx_torch/csrc/fused_engine.cu",
         "replaces": "cgx/kernels/fused_engine.py:411",
         "launches": launches["k3_b"], "max_abs_err": k3_err["b"],
         "ms": t_b, "plain_ms": t_bp},
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)

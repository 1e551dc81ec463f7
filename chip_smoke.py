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
   and their plain versions.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card; it
imports neither JAX nor the JAX package.
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
TOL = 1e-6
JAX_ITERS_ONES_128 = 300  # the JAX package's count (BENCH_r05.json)


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
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)

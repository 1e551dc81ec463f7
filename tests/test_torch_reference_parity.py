"""The port against the compiled reference C program (its golden tests).

The port's copy of ``tests/test_reference_parity.py``: compile the
reference solver (the read-only tree that file names, ``REF_DIR``) into a
temporary directory, write a 2-D Poisson problem in its 4-line input
format, run both solvers for a fixed iteration count and compare the
solutions.  Without the reference tree or gcc the tests that need the
binary skip, as the JAX package's do.

``cg <input> k`` performs k + 1 CG updates (its break comes after the x/r
update of iteration k), so the port runs ``maxiter = k + 1`` with ``tol =
0``; the program prints every x entry as ``\\t%f``.
"""
import io
import os
import subprocess
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from cgx_torch.io.legacy import read_legacy, write_legacy
from cgx_torch.io.poisson import poisson2d
from cgx_torch.solve.cg import cg_solve
# The JAX package's copy decides where the reference is and whether it
# can be built: both files skip on the same condition.
from test_reference_parity import HAVE_GCC, HAVE_REF, REF_DIR


@pytest.fixture(scope="module")
def ref_binary(tmp_path_factory):
    if not (HAVE_REF and HAVE_GCC):
        pytest.skip("reference source or gcc unavailable")
    d = tmp_path_factory.mktemp("refbuild")
    exe = d / "cg"
    subprocess.run(
        ["gcc", "-O2", "-o", str(exe),
         os.path.join(REF_DIR, "cg.c"), os.path.join(REF_DIR, "mv_ops.c"),
         "-I", REF_DIR, "-lm"],
        check=True, capture_output=True)
    return str(exe)


def run_reference(exe, input_path, max_iterations):
    out = subprocess.run([exe, input_path, str(max_iterations)],
                         check=True, capture_output=True, text=True).stdout
    xs = [float(line.strip()) for line in out.splitlines()
          if line.startswith("\t") and _is_float(line.strip())]
    return np.array(xs)


def _is_float(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def test_legacy_format_roundtrip(tmp_path):
    a = poisson2d(6, 5, device="cpu")
    b = np.random.default_rng(0).standard_normal(30)
    p = str(tmp_path / "io.txt")
    write_legacy(p, a, b)
    a2, b2 = read_legacy(p, device="cpu")
    np.testing.assert_array_equal(a2.indptr.numpy(), a.indptr.numpy())
    np.testing.assert_array_equal(a2.col_indices.numpy(),
                                  a.col_indices.numpy())
    np.testing.assert_allclose(a2.values.numpy(), a.values.numpy())
    np.testing.assert_allclose(b2.numpy(), b)


@pytest.mark.parametrize("iters", [5, 30])
def test_solution_matches_reference_binary(ref_binary, tmp_path, iters):
    """x from the port == x from the C binary on 2-D Poisson (fp64, fixed
    iterations)."""
    nx = ny = 16
    a = poisson2d(nx, ny, device="cpu")
    n = nx * ny
    b = np.random.default_rng(11).standard_normal(n)
    p = str(tmp_path / f"poisson_{iters}.txt")
    write_legacy(p, a, b)

    x_ref = run_reference(ref_binary, p, iters)
    assert x_ref.shape == (n,)
    res = cg_solve(a, torch.from_numpy(b), tol=0.0, maxiter=iters + 1)
    # %f prints 6 decimals: compare at that tolerance.
    np.testing.assert_allclose(res.x.numpy(), x_ref, atol=5e-6)


def test_residual_trajectory_vs_reference_converges(ref_binary, tmp_path):
    """Both solvers drive the true residual to the same magnitude."""
    import scipy.sparse as sp

    a = poisson2d(8, 8, device="cpu")
    b = np.random.default_rng(2).standard_normal(64)
    p = str(tmp_path / "traj.txt")
    write_legacy(p, a, b)

    x_ref = run_reference(ref_binary, p, 63)
    res = cg_solve(a, torch.from_numpy(b), tol=0.0, maxiter=64)
    s = sp.csr_matrix((a.values.numpy(), a.col_indices.numpy(),
                       a.indptr.numpy()), shape=a.shape)
    r_ref = np.linalg.norm(b - s @ x_ref)
    r_port = np.linalg.norm(b - s @ res.x.numpy())
    nb = np.linalg.norm(b)
    assert r_port <= max(r_ref / nb, 1e-12) * nb * 1.5 + 1e-5 * nb


def test_cli_legacy_compat_matches_reference_binary(ref_binary, tmp_path):
    """End to end: ``python -m cgx_torch solve --legacy-compat`` prints
    the C binary's solution."""
    from cgx_torch.cli import main

    a = poisson2d(10, 10, device="cpu")
    b = np.random.default_rng(4).standard_normal(100)
    p = str(tmp_path / "cli.txt")
    write_legacy(p, a, b)

    x_ref = run_reference(ref_binary, p, 20)
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        code = main(["solve", "--input", p, "--dtype", "f64", "--maxiter",
                     "20", "--legacy-compat", "--device", "cpu"])
    assert code == 0
    x_cli = np.array([float(v) for v in out.getvalue().split()])
    assert x_cli.shape == x_ref.shape
    np.testing.assert_allclose(x_cli, x_ref, atol=5e-6)

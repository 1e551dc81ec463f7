"""The port's entry points against the JAX package's ``__graft_entry__``.

``entry(device="cpu")`` runs the same Jacobi-PCG solve as cgx's
``entry()`` (equal iterations, x within 1e-5); ``dryrun_multichip(4)``
runs every stage of cgx's dry run on 4 spawned gloo ranks (one group for
the module).  A fresh interpreter importing the harness modules and the
entry loads no JAX.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_matches_cgx():
    """The same solve as cgx's jitted ``entry()``: equal iterations, x
    within 1e-5, converged to tol 1e-5."""
    import jax

    from __graft_entry__ import entry as cgx_entry

    from cgx_torch.graft_entry import entry

    fn0, args0 = cgx_entry()
    x0, its0, rr0 = jax.jit(fn0)(*args0)
    fn, args = entry(device="cpu")
    x, its, rr = fn(*args)
    assert int(its) == int(its0)
    assert tuple(x.shape) == tuple(x0.shape) == (16 ** 3,)
    x0 = np.asarray(x0, np.float64)
    assert np.linalg.norm(x.numpy() - x0) <= 1e-5 * np.linalg.norm(x0)
    assert float(rr) ** 0.5 <= 1e-5 * float(args[1].double().norm())


def test_dryrun_multichip_on_four_ranks():
    """Every stage of the dry run (halo, all-gather, ic0_sweep, pipelined,
    the fused engines, WBELL, df64, the 2-D grid) on 4 gloo ranks."""
    from cgx_torch.graft_entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")


def test_fresh_import_loads_no_jax():
    code = ("import sys\n"
            "import cgx_torch.bench, cgx_torch.bench.suitesparse, "
            "cgx_torch.bench.df64_rhs, cgx_torch.bench.scaling, "
            "cgx_torch.bench.reference_full, cgx_torch.graft_entry, "
            "cgx_torch.io.matrix_market\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'cgx.')) or m in ('cgx', "
            "'__graft_entry__')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_default_device_without_a_card():
    """``entry()`` and ``dryrun_multichip(n, device="cuda")`` outside a
    group raise without a card, and ``python -m cgx_torch.graft_entry``
    exits non-zero: nothing falls back to the CPU."""
    import torch

    from cgx_torch.graft_entry import dryrun_multichip, entry

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()
    with pytest.raises(RuntimeError, match="torchrun"):
        dryrun_multichip(2, device="cuda")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "cgx_torch.graft_entry"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "no CUDA card" in out.stderr

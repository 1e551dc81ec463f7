"""The port's command line against cgx's (``tests/test_cli.py``'s cases).

Each test runs the same argv through ``cgx.cli.main`` and
``cgx_torch.cli.main`` (the port's with ``--device cpu`` after it, since
its default is the card) and compares what they print: the iterations
(equal in fp64, within 2 in fp32), the residual norms (fp64: the printed
three digits within 1 %), the routing lines and the legacy-compat dump
line by line.  ``--devices N`` spawns N gloo ranks on the port's side and
runs on N virtual devices on cgx's; the ``--devices 8`` cases share one
spawn (``eight_ranks``).

``test_select_backend_routes_fused_on_tpu`` has no counterpart here: it
simulates cgx's TPU routing rule (``jax.default_backend() == "tpu"``), and
the port's routing on the card is held by ``tests/test_torch_auto.py`` and
``chip_smoke.py``.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv, capsys):
    code = main(argv)
    out, err = capsys.readouterr()
    return code, out, err


def both(argv, capsys, port_argv=None):
    """``(cgx's (code, out, err), the port's)`` for one argv."""
    from cgx.cli import main as cgx_main
    from cgx_torch.cli import main as port_main

    theirs = _run(cgx_main, argv, capsys)
    port_argv = list(argv if port_argv is None else port_argv)
    if port_argv[0] in ("solve", "bench", "info"):
        port_argv += ["--device", "cpu"]
    mine = _run(port_main, port_argv, capsys)
    return theirs, mine


def _summary(err):
    m = re.search(r"iterations=(\d+) converged=(\w+) residual_norm=(\S+)",
                  err)
    assert m, err
    return int(m.group(1)), m.group(2) == "True", float(m.group(3))


def _same_solve(theirs, mine, fp64=True):
    """Both exit 0 and converge; iterations equal (fp64) or within 2
    (fp32); fp64 residual norms within 1 %."""
    assert theirs[0] == 0, theirs[2]
    assert mine[0] == 0, mine[2]
    it_t, conv_t, rn_t = _summary(theirs[2])
    it_m, conv_m, rn_m = _summary(mine[2])
    assert conv_t and conv_m
    if fp64:
        assert it_m == it_t, (it_m, it_t)
        assert rn_m == pytest.approx(rn_t, rel=1e-2)
    else:
        assert abs(it_m - it_t) <= 2, (it_m, it_t)


def _gen(tmp_path, capsys, dims, name="prob.txt"):
    from cgx.cli import main as cgx_main
    p = str(tmp_path / name)
    assert _run(cgx_main, ["gen", "--poisson", dims, "--out", p],
                capsys)[0] == 0
    return p


def test_gen_and_solve_legacy_roundtrip(tmp_path, capsys):
    """``gen`` writes the same legacy file in both packages; the fp64
    Jacobi solve of it takes the same iterations."""
    p_t, p_m = str(tmp_path / "t.txt"), str(tmp_path / "m.txt")
    theirs, mine = both(["gen", "--poisson", "8x8", "--out", p_t], capsys,
                        ["gen", "--poisson", "8x8", "--out", p_m])
    assert theirs[0] == mine[0] == 0 and "n=64" in mine[2]
    assert open(p_t).read() == open(p_m).read()
    theirs, mine = both(["solve", "--input", p_m, "--dtype", "f64", "--tol",
                         "1e-8", "--precond", "jacobi"], capsys)
    _same_solve(theirs, mine)


def test_solve_legacy_compat_output_format(tmp_path, capsys):
    """The legacy-compat dump: 25 ``\\t%f`` lines, equal line by line."""
    p = _gen(tmp_path, capsys, "5x5")
    theirs, mine = both(["solve", "--input", p, "--dtype", "f64",
                         "--maxiter", "30", "--legacy-compat"], capsys)
    assert theirs[0] == mine[0] == 0
    lt, lm = theirs[1].splitlines(), mine[1].splitlines()
    assert len(lm) == len(lt) == 25
    assert all(line.startswith("\t") for line in lm)
    for a, b in zip(lt, lm):
        assert abs(float(a) - float(b)) <= 1e-6, (a, b)
    assert _summary(mine[2])[0] == _summary(theirs[2])[0] == 31


def _bench_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_bench_json_line(capsys):
    """One JSON line with cgx's keys; the same iterations in fp64."""
    theirs, mine = both(["bench", "--poisson", "16x16", "--format", "dia",
                         "--dtype", "f64", "--precond", "jacobi", "--reps",
                         "2"], capsys)
    assert theirs[0] == mine[0] == 0
    rt, rm = _bench_json(theirs[1]), _bench_json(mine[1])
    assert set(rm) == set(rt)
    assert rm["n"] == 256 and rm["converged"]
    assert rm["spmv_gnnz_s"] > 0 and rm["solve_ms"] > 0
    assert rm["iterations"] == rt["iterations"]
    assert (rm["nnz"], rm["format"], rm["dtype"], rm["precond"]) == \
        (rt["nnz"], rt["format"], rt["dtype"], rt["precond"])
    assert rm["device"] == "cpu"


def test_bench_json_reports_path(capsys):
    """The route ``select_backend`` gives on the CPU: the loop."""
    theirs, mine = both(["bench", "--poisson", "16x16", "--format", "dia",
                         "--dtype", "f64", "--precond", "jacobi", "--reps",
                         "1"], capsys)
    assert _bench_json(mine[1])["path"] == "xla"
    assert _bench_json(theirs[1])["path"] in ("xla", "padded")


# The ``--devices 8`` cases: cgx runs each argv on 8 virtual devices; the
# port's sides run in one spawn of 8 gloo ranks for the module (each rank
# runs every case's ``cmd_solve`` in turn, as ``main`` runs one).
# ``main``'s own spawn is held by the ``--devices 4`` tests below.
_EIGHT_RANKS = {
    "distributed": ["solve", "--poisson", "16x16", "--format", "dia",
                    "--dtype", "f64", "--precond", "jacobi", "--devices",
                    "8", "--tol", "1e-8"],
    "method_flag": ["solve", "--poisson", "16x16", "--format", "dia",
                    "--dtype", "f64", "--precond", "jacobi", "--devices",
                    "8", "--tol", "1e-8", "--method", "single_reduction"],
    "fused_stencil": ["solve", "--poisson", "16x6x7", "--format", "stencil",
                      "--dtype", "f32", "--devices", "8", "--tol", "1e-5"],
    "ic0_sweep": ["solve", "--poisson", "16x16", "--format", "dia",
                  "--dtype", "f64", "--precond", "ic0-sweep", "--sweeps",
                  "2", "--devices", "8", "--tol", "1e-8"],
}


def _rank_solves(mesh, argvs):
    """One spawned rank: every case's ``solve`` on ``mesh``, in order."""
    from cgx_torch.cli import _rank_solve

    return [_rank_solve(mesh, argv) for argv in argvs]


@pytest.fixture(scope="module")
def eight_ranks():
    """Rank 0's ``(exit code, stdout, stderr)`` of each ``--devices 8``
    case (``--device cpu`` appended), as ``main`` returns and prints
    them."""
    from cgx_torch.dist import run_spmd

    names = list(_EIGHT_RANKS)
    argvs = [_EIGHT_RANKS[k] + ["--device", "cpu"] for k in names]
    got = run_spmd(_rank_solves, 8, argvs)[0]
    return {k: (code or 0, out, err) for k, (code, out, err)
            in zip(names, got)}


def both_on_eight(name, capsys, eight_ranks):
    """``(cgx's (code, out, err), the port's)`` of a ``--devices 8``
    case."""
    from cgx.cli import main as cgx_main

    return _run(cgx_main, _EIGHT_RANKS[name], capsys), eight_ranks[name]


def test_solve_distributed(capsys, eight_ranks):
    """``--devices 8``: 8 gloo ranks (cgx: 8 virtual devices), the same
    iterations in fp64."""
    theirs, mine = both_on_eight("distributed", capsys, eight_ranks)
    _same_solve(theirs, mine)


def test_mtx_input(tmp_path, capsys):
    p = _gen(tmp_path, capsys, "7x6", "a.mtx")
    theirs, mine = both(["solve", "--input", p, "--dtype", "f64", "--tol",
                         "1e-8"], capsys)
    _same_solve(theirs, mine)


def test_print_sparse_format():
    """The reference dump of a vector and of a matrix: the same text."""
    import jax.numpy as jnp

    from cgx.io.poisson import poisson2d
    from cgx.utils.debug import format_sparse as cgx_format
    from cgx_torch.io.poisson import poisson2d as port_poisson2d
    from cgx_torch.utils.debug import format_sparse

    s = format_sparse(np.asarray([1.5, 0.0, -2.25]))
    assert s == cgx_format(jnp.asarray([1.5, 0.0, -2.25]))
    lines = s.splitlines()
    assert lines[0] == "Size: 3" and lines[1] == "NNZ: 2"
    assert lines[2] == "\t1.500000"
    s2 = format_sparse(port_poisson2d(3, 3, device="cpu"), max_entries=4)
    assert s2 == cgx_format(poisson2d(3, 3), max_entries=4)
    assert "Size: 9" in s2 and "more)" in s2


def test_solve_stencil_format(capsys):
    theirs, mine = both(["solve", "--poisson", "8x8x8", "--format",
                         "stencil", "--dtype", "f32", "--tol", "1e-5"],
                        capsys)
    _same_solve(theirs, mine, fp64=False)


def test_native_format_roundtrip(tmp_path):
    """Every kind the CLI's ``--input .npz`` reads: saved by the port,
    loaded by the port and by cgx, the same products."""
    import jax.numpy as jnp
    import torch

    import cgx_torch
    from cgx.io.native_format import load_matrix as cgx_load
    from cgx.ops.spmv import spmv as cgx_spmv
    from cgx_torch.io.native_format import load_matrix, save_matrix
    from cgx_torch.io.poisson import poisson2d, poisson2d_dia

    rng = np.random.default_rng(42)
    a_csr = poisson2d(7, 6, device="cpu")
    b = rng.standard_normal(42)
    cases = {
        "csr": a_csr,
        "coo": a_csr.to_coo(),
        "dia": poisson2d_dia(7, 6, device="cpu"),
        "ell": cgx_torch.ell_from_csr(a_csr, device="cpu"),
        "bsr": cgx_torch.bsr_from_csr(a_csr, 4),
        "st3": cgx_torch.poisson3d_stencil(3, 4, 5),
    }
    for name, a in cases.items():
        p = str(tmp_path / f"{name}.npz")
        save_matrix(p, a, torch.from_numpy(b) if name == "csr" else None)
        a2, b2 = load_matrix(p, device="cpu")
        a3, _ = cgx_load(p)
        x = rng.standard_normal(a.shape[0])
        y1 = cgx_torch.spmv(a, torch.from_numpy(x))
        y2 = cgx_torch.spmv(a2, torch.from_numpy(x))
        y3 = np.asarray(cgx_spmv(a3, jnp.asarray(x)))
        np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(y3, y1.numpy(), rtol=1e-6, err_msg=name)
        if name == "csr":
            np.testing.assert_allclose(b2.numpy(), b)


def test_solve_distributed_method_flag(capsys, eight_ranks):
    """``--method single_reduction`` across 8 ranks."""
    theirs, mine = both_on_eight("method_flag", capsys, eight_ranks)
    _same_solve(theirs, mine)


def test_solve_distributed_fused_stencil(capsys, eight_ranks):
    """A stencil across 8 ranks takes the fused engine (K3's plain
    version on the CPU)."""
    theirs, mine = both_on_eight("fused_stencil", capsys, eight_ranks)
    _same_solve(theirs, mine, fp64=False)


def test_solve_distributed_ic0_sweep(capsys, eight_ranks):
    theirs, mine = both_on_eight("ic0_sweep", capsys, eight_ranks)
    _same_solve(theirs, mine)


def test_solve_ic0_sweep_single_device(capsys):
    theirs, mine = both(["solve", "--poisson", "12x12", "--dtype", "f64",
                         "--precond", "ic0-sweep", "--tol", "1e-8"], capsys)
    _same_solve(theirs, mine)


def test_solve_accuracy_df64(tmp_path, capsys):
    """``--accuracy df64`` reports its cycles and TRUE relres; the same
    cycle count as cgx's."""
    p = _gen(tmp_path, capsys, "8x8")
    theirs, mine = both(["solve", "--input", p, "--tol", "1e-6",
                         "--precond", "jacobi", "--accuracy", "df64"],
                        capsys)
    assert mine[0] == 0, mine[2]
    for line in ("df64 outer cycles=", "true_relres=", "converged=True"):
        assert line in mine[2]
    cycles = [re.search(r"outer cycles=(\d+)", e[2]).group(1)
              for e in (theirs, mine)]
    assert cycles[0] == cycles[1]


def test_solve_format_wbell(tmp_path, capsys):
    """``--format wbell`` from a file input: the build line and the solve
    (K7's plain version), iterations within 2 of cgx's."""
    p = _gen(tmp_path, capsys, "12x12")
    theirs, mine = both(["solve", "--input", p, "--format", "wbell", "--tol",
                         "1e-6", "--precond", "jacobi"], capsys)
    assert "format=wbell" in mine[2] and "build_s=" in mine[2] \
        and "fill=" in mine[2]
    fills = [re.search(r"fill=(\S+)", e[2]).group(1) for e in (theirs, mine)]
    assert fills[0] == fills[1]
    _same_solve(theirs, mine, fp64=False)


def test_solve_format_auto_reports_pick(tmp_path, capsys):
    p = _gen(tmp_path, capsys, "10x10")
    theirs, mine = both(["solve", "--input", p, "--format", "auto", "--tol",
                         "1e-6"], capsys)
    picks = [re.search(r"format=(\w+)", e[2]).group(1)
             for e in (theirs, mine)]
    assert picks[0] == picks[1]
    _same_solve(theirs, mine, fp64=False)


def test_solve_format_wbell_rejects_ic0(tmp_path, capsys):
    from cgx_torch.cli import main

    p = _gen(tmp_path, capsys, "12x12")
    with pytest.raises(SystemExit, match="wbell"):
        main(["solve", "--input", p, "--format", "wbell", "--precond", "ic0",
              "--device", "cpu"])


def test_bench_format_wbell(capsys):
    theirs, mine = both(["bench", "--poisson", "12x12x12", "--format",
                         "wbell", "--reps", "1", "--tol", "1e-5"], capsys)
    assert mine[0] == 0, mine[2]
    rec, ref = _bench_json(mine[1]), _bench_json(theirs[1])
    assert rec["format"] == ref["format"] == "WBELLMatrix"
    assert rec["path"] == ref["path"] == "wbell"
    assert rec["nnz"] == ref["nnz"] > 0     # true nnz, not the fill
    assert rec["converged"]
    assert abs(rec["iterations"] - ref["iterations"]) <= 2


def test_solve_df64_wbell_inner(tmp_path, capsys):
    p = _gen(tmp_path, capsys, "12x12")
    theirs, mine = both(["solve", "--input", p, "--format", "wbell",
                         "--accuracy", "df64", "--tol", "1e-8", "--precond",
                         "jacobi"], capsys)
    assert mine[0] == 0, mine[2]
    assert "df64 outer cycles=" in mine[2] and "converged=True" in mine[2]


def test_solve_format_wbell_new_preconds(tmp_path, capsys):
    p = _gen(tmp_path, capsys, "14x14")
    for pc in ("poly", "block-jacobi"):
        theirs, mine = both(["solve", "--input", p, "--format", "wbell",
                             "--tol", "1e-6", "--precond", pc], capsys)
        _same_solve(theirs, mine, fp64=False)


def test_solve_wbell_distributed(tmp_path, capsys):
    """``--format wbell --devices 4``: the row-partitioned WBELL engine on 4
    gloo ranks, iterations within 2 of cgx's 4-device solve."""
    p = _gen(tmp_path, capsys, "40x40")
    theirs, mine = both(["solve", "--input", p, "--format", "wbell",
                         "--devices", "4", "--tol", "1e-6", "--precond",
                         "jacobi"], capsys)
    assert "format=wbell (distributed)" in mine[2]
    _same_solve(theirs, mine, fp64=False)


def _rank_wbell_solve_fails(mesh, argv):
    """One rank of ``solve --devices N`` whose distributed WBELL solve
    raises ValueError (as a K7 launch check does): what the rank's
    ``cmd_solve`` did, and what it printed."""
    from contextlib import redirect_stderr
    from io import StringIO

    import cgx_torch.dist.wbell as dwb
    from cgx_torch import cli

    def fail(*args, **kwargs):
        raise ValueError("K7 launch failed")

    dwb.dist_wbell_cg_solve = fail
    err = StringIO()
    try:
        with redirect_stderr(err):
            code = cli.cmd_solve(cli._parser().parse_args(argv), mesh=mesh)
    except ValueError as e:
        return "raised", str(e), err.getvalue()
    return "returned", code, err.getvalue()


def test_solve_wbell_distributed_failure_raises(tmp_path, capsys):
    """Under ``--format auto --devices 2`` only a failed WBELL build takes
    the CSR partition: a failed solve raises on every rank and nothing
    prints the fallback."""
    from cgx_torch.dist import run_spmd

    p = _gen(tmp_path, capsys, "20x20")
    argv = ["solve", "--input", p, "--format", "auto", "--devices", "2",
            "--precond", "jacobi", "--device", "cpu"]
    for kind, what, err in run_spmd(_rank_wbell_solve_fails, 2, argv):
        assert (kind, what) == ("raised", "K7 launch failed"), err
        assert "format=wbell (distributed)" in err
        assert "csr partition" not in err and "iterations=" not in err


def _random_wbell_file(tmp_path, n, diag):
    """A prebuilt WBELL operator written by cgx (``--input op.npz``)."""
    import scipy.sparse as sp

    import cgx
    from cgx.io.native_format import save_matrix

    a = sp.random(n, n, density=0.02, random_state=3, format="csr")
    a = sp.csr_matrix((a + a.T) + sp.eye(n) * diag)
    p = str(tmp_path / "op.npz")
    save_matrix(p, cgx.wbell_from_csr(a))
    return p


def test_solve_prebuilt_wbell_npz(tmp_path, capsys):
    """cgx's saved WBELL operator loads in the port and solves, no
    rebuild."""
    p = _random_wbell_file(tmp_path, 500, 12.0)
    theirs, mine = both(["solve", "--input", p, "--tol", "1e-6",
                         "--precond", "jacobi"], capsys)
    assert "format=wbell (prebuilt)" in mine[2]
    _same_solve(theirs, mine, fp64=False)


def test_solve_save_operator_roundtrip(tmp_path, capsys):
    """``--save-operator`` persists the port's WBELL build; a second run
    loads it."""
    from cgx_torch.cli import main

    p = _gen(tmp_path, capsys, "20x20")
    op = str(tmp_path / "op.npz")
    code, _, err = _run(main, ["solve", "--input", p, "--format", "wbell",
                               "--tol", "1e-6", "--save-operator", op,
                               "--device", "cpu"], capsys)
    assert code == 0 and "operator saved" in err, err
    code, _, err = _run(main, ["solve", "--input", op, "--tol", "1e-6",
                               "--precond", "jacobi", "--device", "cpu"],
                        capsys)
    assert code == 0, err
    assert "format=wbell (prebuilt)" in err and "converged=True" in err


def test_solve_file_input_defaults_to_auto_format(tmp_path, capsys):
    p = _gen(tmp_path, capsys, "10x10")
    theirs, mine = both(["solve", "--input", p, "--tol", "1e-6"], capsys)
    assert "format=" in mine[2]
    _same_solve(theirs, mine, fp64=False)


def test_solve_poisson_keeps_csr_default(capsys):
    theirs, mine = both(["solve", "--poisson", "12x12", "--tol", "1e-6"],
                        capsys)
    assert "format=" not in mine[2]
    _same_solve(theirs, mine, fp64=False)


def test_solve_prebuilt_wbell_npz_rejects_f64(tmp_path, capsys):
    from cgx_torch.cli import main

    p = _random_wbell_file(tmp_path, 500, 12.0)
    with pytest.raises(SystemExit, match="df64"):
        main(["solve", "--input", p, "--dtype", "f64", "--device", "cpu"])


def test_solve_not_converged_hints_df64(capsys):
    theirs, mine = both(["solve", "--poisson", "24x24", "--tol", "1e-30",
                         "--maxiter", "3"], capsys)
    assert mine[0] == theirs[0] == 2
    assert "converged=False" in mine[2] and "--accuracy df64" in mine[2]
    assert _summary(mine[2])[0] == _summary(theirs[2])[0] == 3


def test_solve_df64_distributed(tmp_path, capsys):
    """``--accuracy df64 --devices 4``: the df64 refinement on 4 gloo
    ranks."""
    p = _gen(tmp_path, capsys, "40x40")
    theirs, mine = both(["solve", "--input", p, "--accuracy", "df64",
                         "--devices", "4", "--tol", "1e-8", "--precond",
                         "jacobi"], capsys)
    assert mine[0] == 0, mine[2]
    assert "df64 (distributed, 4 shards)" in mine[2]
    assert "true_relres=" in mine[2] and "converged=True" in mine[2]
    cycles = [re.search(r"outer cycles=(\d+)", e[2]).group(1)
              for e in (theirs, mine)]
    assert abs(int(cycles[0]) - int(cycles[1])) <= 1


def test_solve_df64_save_and_reuse_bundle(tmp_path, capsys):
    """``--accuracy df64 --save-operator`` writes the bundle; ``--input``
    of it implies df64 and skips the builds."""
    from cgx_torch.cli import main

    p = _gen(tmp_path, capsys, "12x12")
    op = str(tmp_path / "op.npz")
    code, _, err = _run(main, ["solve", "--input", p, "--format", "wbell",
                               "--accuracy", "df64", "--tol", "1e-8",
                               "--precond", "jacobi", "--save-operator", op,
                               "--device", "cpu"], capsys)
    assert code == 0, err
    assert "operator saved" in err and "converged=True" in err
    code, _, err = _run(main, ["solve", "--input", op, "--tol", "1e-8",
                               "--precond", "jacobi", "--device", "cpu"],
                        capsys)
    assert code == 0, err
    assert "ir_df64 operator bundle" in err
    assert "format=ir_df64 (prebuilt bundle)" in err
    assert "true_relres=" in err and "converged=True" in err


def test_solve_bundle_rejects_devices(tmp_path, capsys):
    """A df64 bundle with ``--devices 4`` exits with cgx's reason (the
    partition needs the raw CSR), from the spawned ranks."""
    import scipy.sparse as sp

    import cgx
    from cgx.io.native_format import save_df64_operator
    from cgx.solve.hp import IRDF64Operator, df64_ell_from_csr
    from cgx_torch.cli import main

    a = sp.random(400, 400, density=0.02, random_state=3, format="csr")
    a = sp.csr_matrix((a + a.T) + sp.eye(400) * 10.0)
    op = IRDF64Operator(a_hp=df64_ell_from_csr(a), wb=cgx.wbell_from_csr(a),
                        diag=a.diagonal())
    p = str(tmp_path / "op.npz")
    save_df64_operator(p, op)
    with pytest.raises(SystemExit, match="single-device"):
        main(["solve", "--input", p, "--devices", "4", "--device", "cpu"])


def test_bench_rejects_df64_bundle(tmp_path):
    """``bench --input`` of a df64 bundle exits with cgx's reason, and each
    package names its own per-RHS harness (``python -m
    cgx_torch.bench.df64_rhs`` for the port)."""
    import scipy.sparse as sp

    import cgx
    from cgx.cli import main as cgx_main
    from cgx.io.native_format import save_df64_operator
    from cgx.solve.hp import IRDF64Operator, df64_ell_from_csr
    from cgx_torch.cli import main

    a = sp.random(400, 400, density=0.02, random_state=3, format="csr")
    a = sp.csr_matrix((a + a.T) + sp.eye(400) * 10.0)
    op = IRDF64Operator(a_hp=df64_ell_from_csr(a), wb=cgx.wbell_from_csr(a),
                        diag=a.diagonal())
    p = str(tmp_path / "op.npz")
    save_df64_operator(p, op)
    with pytest.raises(SystemExit, match=r"python -m cgx\.bench\.df64_rhs"):
        cgx_main(["bench", "--input", p])
    with pytest.raises(SystemExit, match=r"does not take ir_df64 bundles.*"
                       r"python -m cgx_torch\.bench\.df64_rhs"):
        main(["bench", "--input", p, "--device", "cpu"])


# -- the port's own boundaries ------------------------------------------------


def _python(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + code_or_args, cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120, **kw)


def test_fresh_import_loads_no_jax():
    """The command line and the distributed modules import neither JAX nor
    cgx."""
    proc = _python(["-c", "import sys, cgx_torch.cli, cgx_torch.dist.wbell, "
                    "cgx_torch.dist.hp; print(sorted(m for m in sys.modules "
                    "if m == 'jax' or m.startswith(('jax.', 'cgx.')) "
                    "or m == 'cgx'))"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_default_device_without_card_exits_nonzero():
    """``python -m cgx_torch solve`` runs on the card by default: with no
    card it exits non-zero and says so, it does not fall back."""
    proc = _python(["-m", "cgx_torch", "solve", "--poisson", "8x8"])
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert "iterations=" not in proc.stderr
    proc = _python(["-m", "cgx_torch", "solve", "--poisson", "8x8",
                    "--devices", "2"])
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr


def test_devices_on_one_card_names_torchrun(monkeypatch, capsys):
    """``--devices 2 --device cuda`` outside a group of 2 exits with the
    torchrun command (one card holds one NCCL rank); nothing spawns."""
    import torch

    from cgx_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        main(["solve", "--poisson", "8x8", "--devices", "2"])


def test_python_m_entry_on_cpu():
    """``python -m cgx_torch`` with ``--device cpu`` runs the solve."""
    proc = _python(["-m", "cgx_torch", "solve", "--poisson", "12x12",
                    "--dtype", "f64", "--tol", "1e-8", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    assert "converged=True" in proc.stderr

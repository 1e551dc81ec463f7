"""The port's harnesses against cgx.bench: the SuiteSparse sweep, the df64
escalation, the warm df64 run per right-hand side, the reference
program's full-size problem, and ``load_suitesparse``.

The same numpy inputs (the stand-ins are built from one seed by both
packages) go through ``cgx.bench.*`` and ``cgx_torch.bench.*``.  fp32
iterations agree within 5 %, every converged row's relres is ≤ tol, the
df64 results reach a TRUE relres ≤ 1.5 · tol in both.  The port's solves
run on the CPU here (``device="cpu"``: the kernels' plain versions, one
thread); the card's run is ``chip_smoke.py``'s phases SS, DR and RF.
"""
import gzip
import inspect
import json
import os
import re
import shutil
import tarfile

import numpy as np
import pytest

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the small solves here run faster without the
    thread pool, and steadier beside the other test workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def thermal_rows():
    """The port's and cgx's ``fmt="csr"`` rows on the thermal2 stand-in at
    scale 0.002 (2,456 rows), all four preconditioners, and the port's
    matrix."""
    from cgx.bench.suitesparse import bench_matrix as cgx_bench
    from cgx.io.suitesparse import standin as cgx_standin

    from cgx_torch.bench.suitesparse import bench_matrix
    from cgx_torch.io.suitesparse import standin

    a = standin("thermal2", scale=0.002, device="cpu")
    mine = bench_matrix("thermal2", a, True, tol=TOL, maxiter=4000, reps=1,
                        fmt="csr", chunk=200, device="cpu")
    theirs = cgx_bench("thermal2", cgx_standin("thermal2", scale=0.002),
                       True, tol=TOL, maxiter=4000, reps=1, fmt="csr",
                       chunk=200)
    return a, mine, theirs


def _by_precond(rows):
    return {r["precond"]: r for r in rows}


def test_bench_matrix_csr_matches_cgx(thermal_rows):
    """``fmt="csr"``: the same rows, keys and formats; ``converged`` equal,
    fp32 iterations within 5 %, each relres ≤ tol."""
    _, mine, theirs = thermal_rows
    m, t = _by_precond(mine), _by_precond(theirs)
    assert list(m) == list(t) == ["none", "jacobi", "ic0", "block_jacobi"]
    for p in m:
        assert set(m[p]) == set(t[p]), (p, set(m[p]) ^ set(t[p]))
        assert m[p]["format"] == t[p]["format"] == "csr"
        for key in ("matrix", "standin", "n", "nnz", "dtype", "tol"):
            assert m[p][key] == t[p][key], (p, key)
        assert m[p]["converged"] == t[p]["converged"] is True
        assert abs(m[p]["iterations"] - t[p]["iterations"]) \
            <= 0.05 * t[p]["iterations"], (p, m[p]["iterations"],
                                           t[p]["iterations"])
        assert m[p]["relres"] <= TOL and m[p]["solve_ms"] > 0
    assert "setup_s" in m["ic0"]


def test_bench_matrix_wbell_rows(thermal_rows):
    """``fmt="wbell"`` on the CPU (K7's plain version): the none, jacobi
    and block_jacobi rows run the WBELL operator and ic0 keeps CSR, as
    ``tests/test_wbell.py`` asserts of cgx's; all converge.  none and
    jacobi take the CSR rows' iterations within 5 %.  WBELL's block-Jacobi
    inverts the supervariable 8×8 blocks of its permuted layout, not the
    natural order's, so its count is held within 10 %."""
    from cgx_torch.bench.suitesparse import bench_matrix

    a, csr_rows, _ = thermal_rows
    rows = _by_precond(bench_matrix("thermal2", a, True, tol=TOL,
                                    maxiter=4000, reps=1, fmt="wbell",
                                    chunk=200, device="cpu"))
    csr = _by_precond(csr_rows)
    assert rows["none"]["format"] == rows["jacobi"]["format"] == "wbell"
    assert rows["block_jacobi"]["format"] == "wbell"
    assert rows["ic0"]["format"] == "csr"
    assert "setup_s" in rows["none"]
    assert "bj_setup_s" in rows["block_jacobi"]
    for p, r in rows.items():
        assert r["converged"] and r["relres"] <= TOL, r
        bar = 0.10 if p == "block_jacobi" else 0.05
        assert abs(r["iterations"] - csr[p]["iterations"]) \
            <= bar * csr[p]["iterations"], (p, r["iterations"],
                                            csr[p]["iterations"])


def test_ic0_guard_row_records_clean_error(monkeypatch):
    """A guarded IC(0) row is an error record in both packages (as
    ``tests/test_precond.py`` holds cgx's), and not a failure of the
    sweep."""
    import scipy.sparse as sp

    import cgx as cgx_mod
    from cgx.bench.suitesparse import bench_matrix as cgx_bench
    from cgx.sparse.types import csr_from_scipy as cgx_csr

    import cgx_torch
    from cgx_torch.bench.suitesparse import bench_matrix, failures
    from cgx_torch.sparse.types import csr_from_scipy

    a_sp = sp.diags([-1.0, 2.2, -1.0], [-1, 0, 1], shape=(96, 96),
                    format="csr", dtype=np.float64)
    for mod in (cgx_mod, cgx_torch):
        orig = mod.IC0Precond.from_matrix
        monkeypatch.setattr(
            mod.IC0Precond, "from_matrix",
            staticmethod(lambda m, dtype=None, _o=orig, **kw:
                         _o(m, dtype=dtype, gather_budget=10)))
    (theirs,) = cgx_bench("tiny", cgx_csr(a_sp), True, tol=TOL, maxiter=200,
                          reps=1, fmt="csr", preconds="ic0")
    (mine,) = bench_matrix("tiny", csr_from_scipy(a_sp, device="cpu"), True,
                           tol=TOL, maxiter=200, reps=1, fmt="csr",
                           preconds="ic0", device="cpu")
    for row in (theirs, mine):
        assert "IC(0) guard" in row["error"]
        assert "IC0SweepPrecond" in row["error"]
    assert set(mine) == set(theirs)
    assert failures([mine]) == []


def test_main_exits_nonzero_on_a_failed_row(monkeypatch, capsys):
    """A row whose solve raised keeps cgx's error record in the JSON line,
    and ``main`` exits non-zero; so does a df64 record with an error."""
    import cgx_torch.utils.checkpoint as ck
    from cgx_torch.bench import suitesparse

    def broken(*args, **kw):
        def solve(b):
            raise RuntimeError("launch failed")
        return solve

    monkeypatch.setattr(ck, "make_checkpointed_solver", broken)
    code = suitesparse.main(["--names", "thermal2", "--scale", "0.002",
                             "--preconds", "none,jacobi", "--reps", "1",
                             "--device", "cpu"])
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.strip().splitlines()]
    assert code == 1
    assert [r["error"] for r in rows] == ["RuntimeError: launch failed"] * 2
    assert "launch failed" in err
    assert suitesparse.failures([{"precond": "none", "converged": False,
                                  "df64": {"error": "ValueError: x"}}])


@pytest.fixture(scope="module")
def ill_conditioned():
    """The bcsstk17 stand-in at scale 0.05 (468 rows, κ ≈ 6.8e4 with the
    stiffness set's per-dof scaling), its host scipy fp64 copy, and a
    seeded fp32 right-hand side."""
    from cgx_torch.bench.suitesparse import _csr64
    from cgx_torch.io.suitesparse import standin

    a = standin("bcsstk17", scale=0.05, device="cpu")
    base = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32)
    return a, _csr64(a), base


def test_df64_escalation_matches_cgx(ill_conditioned):
    """``_df64_escalation`` in both packages reaches a TRUE relres ≤ 1.5 ·
    tol; the outer cycles agree within one (both refine over fp32 inners
    of the same matrix; the port's inner CG sums in another order)."""
    from cgx.bench.suitesparse import _df64_escalation as cgx_esc
    from cgx.sparse.types import csr_from_scipy as cgx_csr

    from cgx_torch.bench.suitesparse import _df64_escalation

    a, a64, base = ill_conditioned
    mine = _df64_escalation(a, base, tol=TOL, maxiter=4000, chunk=500,
                            cache={}, device="cpu")
    theirs = cgx_esc(cgx_csr(a64), base, tol=TOL, maxiter=4000, chunk=500,
                     cache={})
    assert set(mine) == set(theirs), (mine, theirs)
    for rec in (mine, theirs):
        assert rec["converged"] and rec["true_relres"] <= 1.5 * TOL, rec
    assert abs(mine["outer"] - theirs["outer"]) <= 1, (mine, theirs)


def _cgx_df64_rhs_keys() -> set:
    """The keys cgx's df64_rhs prints: its record's literal and every
    ``rec["..."]`` it assigns."""
    import cgx.bench.df64_rhs as mod

    src = inspect.getsource(mod.main)
    keys = set(re.findall(r'rec\["(\w+)"\]', src))
    keys |= set(re.findall(r'"(\w+)":', src.split("rec = {", 1)[1]
                           .split("}", 1)[0]))
    return keys


def test_df64_rhs_main_cpu(tmp_path, capsys):
    """``df64_rhs.main --device cpu`` at a tiny size: the built run (its
    TRUE residual checked), the bundle written and loaded, the ``--multi``
    form on the loaded bundle (K8's plain version) and built, each line
    with cgx's keys; ``--multi`` with a missing ``--operator`` exits
    non-zero (cgx skips the save silently)."""
    from cgx_torch.bench import df64_rhs

    op = str(tmp_path / "op.npz")
    small = ["--name", "thermal2", "--scale", "0.002", "--rhs", "1",
             "--device", "cpu"]
    runs = [small + ["--operator", op],                # build, save
            small + ["--operator", op],                # load
            small + ["--operator", op, "--multi", "2"],
            small + ["--multi", "2"]]
    recs = []
    for argv in runs:
        assert df64_rhs.main(argv) == 0
        recs.append(json.loads(capsys.readouterr().out.strip()))
    keys = _cgx_df64_rhs_keys()
    built = {"standin", "n", "nnz"}
    for rec, loaded in zip(recs, (False, True, True, False)):
        assert set(rec) == (keys - built if loaded else keys), rec
    assert recs[0]["operator"] == op and recs[1]["operator"] == "loaded"
    assert recs[3]["multi_k"] == 2 and len(recs[3]["relres"][0]) == 2
    for rec in recs:
        rel = np.ravel([rec["first_rhs_relres"]] + rec["relres"])
        assert (rel <= TOL).all(), rec
    with pytest.raises(SystemExit) as e:
        df64_rhs.main(small + ["--multi", "2", "--operator",
                               str(tmp_path / "missing.npz")])
    assert e.value.code not in (0, None)
    assert "missing.npz" in str(e.value.code)
    assert not os.path.exists(tmp_path / "missing.npz")


def test_load_suitesparse_matches_cgx(tmp_path, monkeypatch):
    """``load_suitesparse`` reads ``.mtx``, ``.mtx.gz`` and the collection's
    ``.tar.gz`` bundle from a directory (and from ``$CGX_SUITESPARSE_DIR``),
    equal to cgx's; without a file it raises, naming the directory."""
    import scipy.io
    import scipy.sparse as sp

    from cgx.io.matrix_market import load_suitesparse as cgx_load

    from cgx_torch.io.matrix_market import load_suitesparse

    m = sp.random(40, 40, density=0.1, random_state=3, format="csr")
    m = (m + m.T + sp.eye(40) * 4.0).tocsr()
    d = tmp_path / "ss"
    d.mkdir()
    scipy.io.mmwrite(str(d / "plain.mtx"), m, symmetry="symmetric")
    with open(d / "plain.mtx", "rb") as f, \
            gzip.open(d / "zipped.mtx.gz", "wb") as g:
        shutil.copyfileobj(f, g)
    (tmp_path / "bundle").mkdir()
    shutil.copy(d / "plain.mtx", tmp_path / "bundle" / "bundle.mtx")
    with tarfile.open(d / "bundle.tar.gz", "w:gz") as t:
        t.add(tmp_path / "bundle" / "bundle.mtx", arcname="bundle/bundle.mtx")
    for name in ("plain", "zipped", "bundle"):
        mine = load_suitesparse(name, str(d), device="cpu")
        theirs = cgx_load(name, str(d))
        for f in ("values", "col_indices", "indptr"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          np.asarray(getattr(theirs, f)))
        assert mine.shape == tuple(theirs.shape) == (40, 40)
    np.testing.assert_allclose(
        sp.csr_matrix((mine.values.numpy(), mine.col_indices.numpy(),
                       mine.indptr.numpy()), shape=(40, 40)).toarray(),
        m.toarray(), rtol=1e-15)
    monkeypatch.setenv("CGX_SUITESPARSE_DIR", str(d))
    assert load_suitesparse("plain", device="cpu").nnz == m.nnz
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "empty")):
        load_suitesparse("plain", str(tmp_path / "empty"), device="cpu")


def test_build_full_problem_and_solve_match_cgx():
    """``build_full_problem(n=3000, bands=8)`` equals cgx's entry for
    entry, and its fixed 31-update fp32 solve equals cgx's jitted
    ``cg_solve`` within 1e-5 (relative)."""
    import jax
    import jax.numpy as jnp

    from cgx.bench.reference_full import build_full_problem as cgx_build
    from cgx.solve.cg import cg_solve as cgx_cg
    from cgx.sparse.types import csr_from_scipy as cgx_csr

    from cgx_torch.bench.reference_full import build_full_problem, solve_full
    from cgx_torch.sparse.types import csr_from_scipy

    s, b = build_full_problem(n=3000, bands=8)
    s0, b0 = cgx_build(n=3000, bands=8)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(s, f), getattr(s0, f))
    np.testing.assert_array_equal(b, b0)
    x, t_cold, t_warm = solve_full(csr_from_scipy(s, device="cpu"), b, 30,
                                   device="cpu")
    solve = jax.jit(lambda a, b: cgx_cg(a, b, tol=0.0, maxiter=31))
    x0 = np.asarray(solve(cgx_csr(s0).astype(jnp.float32),
                          jnp.asarray(b0, jnp.float32)).x, np.float64)
    assert np.linalg.norm(x - x0) <= 1e-5 * np.linalg.norm(x0)
    assert t_cold > 0 and t_warm > 0


def test_reference_full_main_against_the_binary(capsys):
    """``reference_full.main`` against the compiled reference program, at a
    small n (skips without the reference tree)."""
    from test_reference_parity import HAVE_GCC, HAVE_REF, REF_DIR

    if not (HAVE_REF and HAVE_GCC):
        pytest.skip("the reference tree or gcc is absent")
    from cgx_torch.bench import reference_full

    code = reference_full.main(["--n", "3000", "--bands", "8", "--iters",
                                "30", "--ref-dir", REF_DIR, "--device",
                                "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and rec["rel_dx"] < 1e-3, rec


def test_reference_full_main_without_the_tree(tmp_path):
    """Without the reference tree ``main`` fails, as cgx's does."""
    from cgx_torch.bench import reference_full

    with pytest.raises(SystemExit) as e:
        reference_full.main(["--ref-dir", str(tmp_path), "--device", "cpu"])
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("call", ["bench_matrix", "suitesparse.main",
                                  "df64_rhs.main", "reference_full.main",
                                  "load_suitesparse"])
def test_default_device_without_a_card(call, tmp_path):
    """The card is every entry point's default: without one each raises
    or exits non-zero, and nothing falls back to the CPU."""
    import torch

    from cgx_torch.bench import df64_rhs, reference_full, suitesparse
    from cgx_torch.io.matrix_market import load_suitesparse
    from cgx_torch.io.suitesparse import standin

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    calls = {
        "bench_matrix": lambda: suitesparse.bench_matrix(
            "thermal2", standin("thermal2", scale=0.0005, device="cpu"),
            True),
        "suitesparse.main": lambda: suitesparse.main(["--scale", "0.001"]),
        "df64_rhs.main": lambda: df64_rhs.main(["--scale", "0.001"]),
        "reference_full.main": lambda: reference_full.main(
            ["--ref-dir", str(tmp_path)]),
        "load_suitesparse": lambda: load_suitesparse("x", str(tmp_path)),
    }
    with pytest.raises((SystemExit, RuntimeError)) as e:
        calls[call]()
    if e.type is SystemExit:
        assert e.value.code not in (0, None)
        assert "no CUDA card" in str(e.value.code)

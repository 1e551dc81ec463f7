"""The port's native library (``cgx_torch.native``), its legacy parser and
IC(0) entries, the debug printers, and the new modules' imports (CPU).

Counterparts of ``tests/test_native.py``: the native parse against the
numpy parse and the writer's input, a missing file, no trailing newline,
a malformed token; the native factor against the Python one.  Beside
them: four processes building one fresh directory at once, a failed build
raising, and ``format_sparse`` equal to cgx's string.
"""
import io
import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx_torch  # noqa: E402
from cgx.io import legacy as jlegacy  # noqa: E402
from cgx.io import poisson as jpoisson  # noqa: E402
from cgx.utils import debug as jdebug  # noqa: E402
from cgx_torch import native  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.io import legacy as tlegacy  # noqa: E402
from cgx_torch.io.poisson import poisson2d  # noqa: E402
from cgx_torch.solve import ic0 as tic0  # noqa: E402
from cgx_torch.utils import debug as tdebug  # noqa: E402
from conftest import random_spd_csr  # noqa: E402
from torch_parity import n_, seeded, t  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the native library needs g++")


def _write_system(path, nx=9, ny=7, seed=0):
    a = poisson2d(nx, ny, device=CPU)
    b = seeded(nx * ny, seed=seed) / 3.0
    tlegacy.write_legacy(str(path), a, t(b))
    return a, b


@needs_gxx
def test_native_parser_matches_numpy_and_writer(tmp_path):
    path = tmp_path / "in.txt"
    a, b = _write_system(path)
    cols, rp, av, bv = native.parse_legacy(str(path))
    assert (cols.dtype, rp.dtype, av.dtype, bv.dtype) == (
        np.int32, np.int32, np.float64, np.float64)
    np.testing.assert_array_equal(cols, n_(a.col_indices))
    np.testing.assert_array_equal(rp, n_(a.indptr))
    np.testing.assert_array_equal(av, n_(a.values))
    np.testing.assert_array_equal(bv, b)
    for g, w in zip((cols, rp, av, bv), tlegacy.parse_numpy(str(path))):
        np.testing.assert_array_equal(g, w)


@needs_gxx
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_read_legacy_of_a_cgx_file(tmp_path, dtype):
    """A file cgx writes reads back through the native parser as the
    arrays cgx wrote (cgx's own reader is not called: its native build
    races under xdist, ROADMAP "Known faults")."""
    path = str(tmp_path / "in.txt")
    vals, cols, indptr, n = jpoisson.poisson2d_csr_arrays(8, 6)
    b = seeded(n, seed=1) / 7.0
    from cgx.sparse.types import CSRMatrix as JCSR
    jlegacy.write_legacy(path, JCSR.from_arrays(vals, cols, indptr, (n, n)),
                         jnp.asarray(b))
    ta, tb = tlegacy.read_legacy(path, dtype=dtype, device=CPU)
    assert ta.shape == (n, n)
    np.testing.assert_array_equal(n_(ta.values), vals.astype(dtype))
    np.testing.assert_array_equal(n_(ta.col_indices), cols)
    np.testing.assert_array_equal(n_(ta.indptr), indptr)
    np.testing.assert_array_equal(n_(tb), b.astype(dtype))


@needs_gxx
def test_native_parser_missing_file(tmp_path):
    with pytest.raises(IOError):
        native.parse_legacy(str(tmp_path / "nonexistent.txt"))
    with pytest.raises(IOError):
        tlegacy.read_legacy(str(tmp_path / "nonexistent.txt"), device=CPU)


@needs_gxx
def test_native_parser_no_trailing_newline(tmp_path):
    """A file not ending in whitespace: the '\\0' sentinel keeps strtod in
    bounds."""
    p = tmp_path / "in.txt"
    p.write_text("0,1\n0,1,2\n2.0,3.0\n1.5,2.5")
    cols, rp, av, bv = native.parse_legacy(str(p))
    np.testing.assert_array_equal(cols, [0, 1])
    np.testing.assert_array_equal(rp, [0, 1, 2])
    np.testing.assert_array_equal(av, [2.0, 3.0])
    np.testing.assert_array_equal(bv, [1.5, 2.5])


@needs_gxx
def test_native_parser_malformed_token(tmp_path):
    """A non-numeric token is an error, not a loop, and no numpy parse
    stands in for it."""
    p = tmp_path / "bad.txt"
    p.write_text("0,xyz,2\n0,1,2\n2.0,3.0\n1.5,2.5\n")
    with pytest.raises(IOError):
        native.parse_legacy(str(p))
    with pytest.raises(IOError):
        tlegacy.read_legacy(str(p), device=CPU)


@needs_gxx
def test_native_ic0_matches_python():
    a = cgx_torch.csr_from_scipy(random_spd_csr(
        80, 0.08, np.random.default_rng(6)), device=CPU)
    lv_py, lc, lp = tic0.ic0_factor(a, use_native=False)
    lv_nat, lc2, lp2 = tic0.ic0_factor(a)
    np.testing.assert_array_equal(lc, lc2)
    np.testing.assert_array_equal(lp, lp2)
    np.testing.assert_allclose(lv_nat, lv_py, rtol=1e-12, atol=1e-14)


@needs_gxx
def test_native_ic0_breakdown():
    a = cgx_torch.csr_from_scipy(sp.csr_matrix(
        np.array([[1.0, 2.0], [2.0, 1.0]])), device=CPU)
    lv, lc, lp = tic0._tril_pattern(a)
    with pytest.raises(np.linalg.LinAlgError, match="row 1"):
        native.ic0_factor_native(lp, lc, lv)


@needs_gxx
def test_native_ic0_levels_match_python_schedule():
    a = poisson2d(12, 10, device=CPU)
    lv, lc, lp = tic0._tril_pattern(a)
    _, levels = native.ic0_factor_native(lp, lc, lv)
    np.testing.assert_array_equal(levels, tic0._level_schedule(
        lc, lp, a.shape[0], use_native=False))
    np.testing.assert_array_equal(levels, native.level_schedule_native(
        lc, lp, a.shape[0]))


_BUILD = ("import sys; from cgx_torch import native; "
          "so, secs = native.build(sys.argv[1]); native.lib(sys.argv[1]); "
          "print(so.name, secs)")


@needs_gxx
def test_concurrent_build_into_one_fresh_directory(tmp_path):
    """Four processes build into one fresh directory at once: each
    compiles to a file of its own, and all four load the library."""
    out = tmp_path / "native_build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(out)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (so, err) in zip(procs, results):
        assert p.returncode == 0, err
    names = {so.split()[0] for so, _ in results}
    assert len(names) == 1
    assert sorted(f.name for f in out.iterdir()) == sorted(names)


@needs_gxx
def test_build_names_by_hash_and_reuses(tmp_path):
    so, secs = native.build(tmp_path)
    assert so.parent == tmp_path and so.name.startswith(
        "libcgx_torch_native_") and secs > 0
    assert native.build(tmp_path) == (so, 0.0)
    assert native.BUILD_DIR.parts[-2:] == ("build", "cgx_torch")


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    if shutil.which("g++") is not None:
        src = tmp_path / "src"
        src.mkdir()
        (src / "broken.cpp").write_text("int f( { return 0; }\n")
        monkeypatch.setattr(native, "_SRC", src)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as exc:
            native.build(tmp_path / "out")
        assert "broken.cpp" in str(exc.value)
        assert [f for f in (tmp_path / "out").iterdir()] == []
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.build(tmp_path / "other")


# -- the debug printers -------------------------------------------------------

DUMPS = {
    "csr": lambda: jpoisson.poisson2d(4, 3),
    "dia": lambda: jpoisson.poisson3d_dia(3, 2, 2),
    "vector": lambda: jnp.asarray(seeded(11, seed=2)),
    "numpy2d": lambda: seeded(12, seed=3).reshape(3, 4),
}


@pytest.mark.parametrize("max_entries", [None, 5])
@pytest.mark.parametrize("kind", sorted(DUMPS))
def test_format_sparse_equals_cgx(kind, max_entries):
    a_j = DUMPS[kind]()
    if kind == "vector":
        a_t = t(np.asarray(a_j))
    elif kind == "numpy2d":
        a_t = a_j
    else:
        a_t = operator_from_cgx(a_j, device=CPU)
    want = jdebug.format_sparse(a_j, max_entries)
    assert tdebug.format_sparse(a_t, max_entries) == want
    buf = io.StringIO()
    tdebug.print_sparse(a_t, max_entries, file=buf)
    assert buf.getvalue() == want
    assert want.startswith("Size: ")


def test_new_modules_import_neither_jax_nor_cgx():
    code = ("import sys, cgx_torch, cgx_torch.native, cgx_torch.solve.ic0, "
            "cgx_torch.solve.chebyshev, cgx_torch.solve.cg, "
            "cgx_torch.utils.debug, cgx_torch.io.legacy, cgx_torch.interop; "
            "from cgx_torch.native import parse_legacy, ic0_factor_native; "
            "from cgx_torch.solve.ic0 import (greedy_coloring, ic0_factor, "
            "ic0_factor_shifted, IC0Precond, IC0SweepPrecond); "
            "from cgx_torch import (cg_solve_single_reduction, "
            "cg_solve_pipelined, analytic_bounds, estimate_bounds, "
            "chebyshev_solve, IC0Precond, IC0SweepPrecond); "
            "from cgx_torch.utils.debug import format_sparse, print_sparse; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'cgx' not in sys.modules, 'cgx imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_exports_match_cgx():
    """What cgx exports from these modules, cgx_torch exports too."""
    import cgx
    from cgx import native as jnative
    from cgx.solve import ic0 as jic0

    for name in ("cg_solve_single_reduction", "cg_solve_pipelined",
                 "analytic_bounds", "chebyshev_solve", "estimate_bounds",
                 "IC0Precond", "IC0SweepPrecond"):
        assert name in cgx.__all__ and name in cgx_torch.__all__
        assert hasattr(cgx_torch, name)
    assert set(jic0.__all__) <= set(tic0.__all__)
    for name in ("lib", "parse_legacy", "ic0_factor_native"):
        assert hasattr(jnative, name) and hasattr(native, name)
    assert set(jdebug.__all__) == set(tdebug.__all__)

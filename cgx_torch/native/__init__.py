"""The port's native (C++) host code, built with g++ and loaded by ctypes.

Counterpart of :mod:`cgx.native`, with its own copy of the sources
(``cgx_torch/native/src``): the legacy 4-line parser and the IC(0) host
factor and level schedule.  The library is compiled at first use into
``build/cgx_torch/`` beside the package (or into the ``build_dir`` a caller
passes), named by a hash of the sources, the flags and the host CPU's
feature flags (``-march=native`` code runs only where it was built).
Each build compiles to a temporary file of its own and renames it into
place, so processes that build at once never share a half-written file.

There is no fallback: without ``g++``, or when the compile fails, the
call raises with the compiler's output.  The Python loops of
:mod:`cgx_torch.solve.ic0` run only where a caller asks for them
(``use_native=False``).  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["GXX_FLAGS", "BUILD_DIR", "build", "lib", "parse_legacy",
           "ic0_factor_native", "level_schedule_native"]

_SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "cgx_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: what ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return platform.processor().encode()


def _library_path(build_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags())
    for f in sorted(_SRC.glob("*.cpp")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir / f"libcgx_torch_native_{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[os.PathLike] = None) -> tuple[Path, float]:
    """Compile the native library if it is missing from ``build_dir``
    (default ``build/cgx_torch/``).  Returns its path and the seconds the
    compile took (0.0 when it was already built).  Raises without
    ``g++`` or when the compile fails."""
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    so = _library_path(build_dir)
    if so.exists():
        return so, 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("cgx_torch.native: building the native library "
                           "needs g++ (not found on PATH)")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=so.stem + ".", suffix=".tmp",
                               dir=build_dir)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, "-o", tmp,
           *map(str, sorted(_SRC.glob("*.cpp")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("cgx_torch.native: g++ failed:\n" + " ".join(cmd)
                           + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


@functools.cache
def _load(path: str) -> ctypes.CDLL:
    l = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    l.cgx_parse_legacy.restype = ctypes.c_void_p
    l.cgx_parse_legacy.argtypes = [ctypes.c_char_p]
    l.cgx_parsed_sizes.restype = None
    l.cgx_parsed_sizes.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
    l.cgx_parsed_copy.restype = None
    l.cgx_parsed_copy.argtypes = [ctypes.c_void_p, i32p, i32p, f64p, f64p]
    l.cgx_parsed_free.restype = None
    l.cgx_parsed_free.argtypes = [ctypes.c_void_p]
    l.cgx_ic0_factor.restype = ctypes.c_int32
    l.cgx_ic0_factor.argtypes = [ctypes.c_int64, i32p, i32p, f64p, i32p,
                                 i64p]
    l.cgx_level_schedule.restype = None
    l.cgx_level_schedule.argtypes = [ctypes.c_int64, i32p, i32p, i32p]
    return l


def lib(build_dir: Optional[os.PathLike] = None) -> ctypes.CDLL:
    """The loaded native library, built first if needed (see
    :func:`build`)."""
    so, _ = build(build_dir)
    return _load(str(so))


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_legacy(path: str):
    """Native parse of the 4-line format → ``(col_indices, row_ptr,
    a_values, b_values)`` host arrays (int32, int32, float64, float64).
    Raises ``IOError`` on an unreadable file or a non-numeric token."""
    l = lib()
    h = l.cgx_parse_legacy(os.fsencode(path))
    if not h:
        raise IOError(f"cgx_parse_legacy: cannot read or parse {path!r} "
                      "(I/O failure or non-numeric token)")
    try:
        nnz = ctypes.c_int64()
        nrp = ctypes.c_int64()
        nb = ctypes.c_int64()
        l.cgx_parsed_sizes(h, ctypes.byref(nnz), ctypes.byref(nrp),
                           ctypes.byref(nb))
        cols = np.empty(nnz.value, np.int32)
        rp = np.empty(nrp.value, np.int32)
        av = np.empty(nnz.value, np.float64)
        bv = np.empty(nb.value, np.float64)
        l.cgx_parsed_copy(h, _ptr(cols, ctypes.c_int32),
                          _ptr(rp, ctypes.c_int32),
                          _ptr(av, ctypes.c_double),
                          _ptr(bv, ctypes.c_double))
        return cols, rp, av, bv
    finally:
        l.cgx_parsed_free(h)


def ic0_factor_native(indptr, cols, tril_values):
    """Native IC(0) over a lower-triangular CSR pattern (row-sorted,
    diagonal last).  Returns ``(l_values, levels)``; raises
    ``numpy.linalg.LinAlgError`` on a pivot breakdown, as the Python path
    of :func:`cgx_torch.solve.ic0.ic0_factor` does."""
    l = lib()
    indptr = _i32(indptr)
    cols = _i32(cols)
    vals = np.array(tril_values, dtype=np.float64, copy=True)
    n = len(indptr) - 1
    levels = np.zeros(n, np.int32)
    fail = ctypes.c_int64(-1)
    rc = l.cgx_ic0_factor(n, _ptr(indptr, ctypes.c_int32),
                          _ptr(cols, ctypes.c_int32),
                          _ptr(vals, ctypes.c_double),
                          _ptr(levels, ctypes.c_int32), ctypes.byref(fail))
    if rc != 0:
        raise np.linalg.LinAlgError(
            f"IC(0) breakdown at row {fail.value}: pivot <= 0")
    return vals, levels


def level_schedule_native(cols, indptr, n: int) -> np.ndarray:
    """Dependency level of each row of a lower-triangular CSR factor
    (diagonal last), as int64."""
    l = lib()
    ip = _i32(indptr)
    cc = _i32(cols)
    levels = np.zeros(n, np.int32)
    l.cgx_level_schedule(n, _ptr(ip, ctypes.c_int32),
                         _ptr(cc, ctypes.c_int32),
                         _ptr(levels, ctypes.c_int32))
    return levels.astype(np.int64)

"""Build and load the port's CUDA kernels; probe the toolchain.

The sources in ``cgx_torch/csrc/*.cu`` have a plain C interface.  They are
compiled at first use by ``nvcc``, one process per source, all started
together, and linked into one shared library under ``build/cgx_torch/``
beside the package, named by a hash of the sources and the flags (an
edited source gets a new library), and loaded with ``ctypes``.  Nothing
here runs when the module is imported: on a machine without ``nvcc``
importing the package works, and only a CUDA call raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "check", "library", "probe"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cgx_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream c_void_p).
_SIGNATURES = {
    "cgx_stencil3d_spmv": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "cgx_resident_cg_grid": [_I, _I, _P],
    "cgx_resident_cg": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                        _P, _I, _I, _P, _P, _P, _P],
    "cgx_resident_dia_cg_grid": [_I, _I, _I, _I, _P],
    "cgx_resident_dia_cg": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                            _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
    "cgx_fused_a_grid": [_I, _I, _I, _I, _I, _I, _P],
    "cgx_fused_b_grid": [_I, _I, _I, _P],
    "cgx_fused_a": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                    _P, _P, _P, _I, _I, _I, _P],
    "cgx_fused_b": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _P],
    "cgx_multi_a_grid": [_I, _I, _I, _I, _I, _P],
    "cgx_multi_b_grid": [_I, _I, _P],
    "cgx_multi_a": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                    _I, _I, _P],
    "cgx_multi_b": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P],
    "cgx_wbell_resident": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "cgx_wbell_tiered": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "cgx_wbell_windowed": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _P],
    "cgx_bell_spmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("cgx_torch: building the CUDA kernels needs nvcc "
                           "(not found on PATH or in /usr/local/cuda/bin)")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libcgx_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for these sources is missing.

    Returns the library path and the seconds the compile took (0.0 when it
    was already built).
    """
    so = _library_path()
    if so.exists():
        return so, 0.0
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # One nvcc per source, all running at once, then one link.
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(cu, objs))]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out)
    if failed:
        raise RuntimeError("cgx_torch: nvcc failed:\n" + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("cgx_torch: nvcc link failed:\n" + " ".join(cmd)
                           + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, so)
    for o in objs:
        o.unlink()
    return so, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use, loaded once)."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"cgx_torch: {what} failed with cudaError {rc}")


def probe() -> dict:
    """The toolchain this process sees: CUDA device, nvcc, triton."""
    import torch

    info = {"torch": torch.__version__, "torch_cuda": torch.version.cuda,
            "cuda_device": (torch.cuda.get_device_name(0)
                            if torch.cuda.is_available() else None)}
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        info["nvcc"] = out[-1] if out else None
    except RuntimeError:
        info["nvcc"] = None
    try:
        import triton
        info["triton"] = triton.__version__
    except ImportError:
        info["triton"] = None
    return info

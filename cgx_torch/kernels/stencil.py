"""K1: 7-point 3-D stencil SpMV — CUDA kernel and its plain version.

Replaces the Pallas kernel :func:`cgx.kernels.stencil.stencil3d_spmv_pallas`
(``_kernel``: one halo-window DMA per block).  The CUDA source is
``cgx_torch/csrc/stencil.cu``.  Its kernel marches along x: each thread owns
one (j, k) column of four z-values (a float4; one in the scalar form) and
walks a chunk of ``kChunk`` rows along i with x at i−1, i and i+1 in
registers, the z neighbours from its lane neighbours by shuffles and the y
neighbours from the L1; the kernel's block, chunk and choice of form are
set there alone.  Its floor is bytes: x read once and y written once, 8 B
a row.  Each row sums its taps in ``cgx::stencil_row``'s order, each
product and sum rounded on its own, so the march equals the first design
bit for bit.

:func:`stencil3d_spmv` launches the march for a CUDA tensor and takes the
plain PyTorch version, :func:`stencil3d_spmv_reference`, only for a CPU
tensor.  ``stencil3d_spmv_launches`` counts the march's launches.  The
first design (one thread per row) stays as :func:`_before_spmv` (CUDA
only, counted nowhere), the same-run "before" of the tests and the smoke.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from cgx_torch.sparse.stencil import Stencil3D

__all__ = ["stencil3d_spmv", "stencil3d_spmv_reference",
           "stencil3d_spmv_launches", "carried_nodes"]

# Kernel launches so far (a run resets it to show which kernels it used).
stencil3d_spmv_launches = 0

# Tap order of the 7-point operator, as in cgx.kernels.fused_cg.stencil_taps.
_TAPS7 = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
          (1, 0, 0), (-1, 0, 0))


def carried_nodes(row0: int, step: int, count: int, ny: int, nz: int):
    """The nodes ``(i, j, k)`` of rows ``row0, row0 + step, …`` (``count``
    rows) as the whole-solve and one-pass kernels carry them
    (``cgx::Walk`` in ``csrc/stencil.cuh``): two divisions, for the first
    row and for the step, then one compare-and-subtract an axis per row.
    The kernels' arithmetic in Python, for the tests."""
    line, k = divmod(row0, nz)
    i, j = divmod(line, ny)
    line, dk = divmod(step, nz)
    di, dj = divmod(line, ny)
    nodes = []
    for _ in range(count):
        nodes.append((i, j, k))
        k += dk
        ck = int(k >= nz)
        k -= ck * nz
        j += dj + ck
        cj = int(j >= ny)
        j -= cj * ny
        i += di + cj
    return nodes


def stencil3d_spmv_reference(x: torch.Tensor, nx: int, ny: int, nz: int,
                             coeffs=(6.0, -1.0, -1.0, -1.0)) -> torch.Tensor:
    """Plain PyTorch ``y = A x`` (shifted adds with zero fill)."""
    cc, cx, cy, cz = coeffs
    return Stencil3D(nx=nx, ny=ny, nz=nz, c_center=cc, c_x=cx, c_y=cy,
                     c_z=cz).matvec(x)


def tap_arrays(taps, coeffs):
    """ctypes host arrays ``(int[3·T], float[T])`` for the C entry points."""
    flat = [int(d) for tap in taps for d in tap]
    return ((ctypes.c_int * len(flat))(*flat),
            (ctypes.c_float * len(coeffs))(*map(float, coeffs)))


def check_cuda_vector(v: torch.Tensor, n: int, name: str,
                      dtype=torch.float32) -> None:
    """Raise unless ``v`` is a contiguous CUDA vector of ``n`` rows of
    ``dtype`` (float32, or bfloat16 for the kernels' bf16 modes) with
    ``n < 2**31`` (the kernels index rows in int32)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the CUDA kernels take float32 or bfloat16 "
                        f"vectors, not {dtype}")
    if v.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got "
                        f"{v.dtype}")
    if v.dim() != 1 or v.shape[0] != n:
        raise ValueError(f"{name}: expected shape ({n},), got "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous "
                         f"tensor")
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} rows do not fit int32 indexing")


@functools.lru_cache(maxsize=64)
def _packed_coeffs(coeffs) -> ctypes.Array:
    """The seven coefficients in tap order (centre, z+, z−, y+, y−, x+,
    x−) as the C entry takes them, packed once per coefficient tuple."""
    cc, cx, cy, cz = coeffs
    return (ctypes.c_float * 7)(cc, cz, cz, cy, cy, cx, cx)


@functools.cache
def _march_call():
    """The march's C entry, the reader of a device's current stream (its
    raw handle, without a Stream object) and the return-code check, looked
    up once."""
    from cgx_torch.kernels import _build

    return (_build.library().cgx_stencil3d_march,
            torch._C._cuda_getCurrentRawStream, _build.check)


def stencil3d_spmv(x: torch.Tensor, *, nx: int, ny: int, nz: int,
                   coeffs=(6.0, -1.0, -1.0, -1.0)) -> torch.Tensor:
    """``y = A x`` for the 7-point stencil; ``x`` flat ``(nx·ny·nz,)``."""
    global stencil3d_spmv_launches
    if not x.is_cuda:
        if x.device.type == "cpu":
            return stencil3d_spmv_reference(x, nx, ny, nz, coeffs)
        raise ValueError(f"stencil3d_spmv: unsupported device {x.device}")
    check_cuda_vector(x, nx * ny * nz, "stencil3d_spmv")
    fn, stream, check = _march_call()
    cf = _packed_coeffs(tuple(coeffs))
    y = torch.empty_like(x)
    index = x.get_device()
    if index == torch.cuda.current_device():
        rc = fn(x.data_ptr(), y.data_ptr(), nx, ny, nz, cf, stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(x.data_ptr(), y.data_ptr(), nx, ny, nz, cf,
                    stream(index))
    check(rc, "stencil3d_spmv launch")
    stencil3d_spmv_launches += 1
    return y


def _before_spmv(x: torch.Tensor, nx: int, ny: int, nz: int,
                 coeffs=(6.0, -1.0, -1.0, -1.0)) -> torch.Tensor:
    """K1's first design, one thread per row, through its first host call
    (the taps packed per call, a device context): the same-run "before"
    of the tests and the smoke.  CUDA only; counted nowhere."""
    from cgx_torch.kernels import _build

    check_cuda_vector(x, nx * ny * nz, "stencil3d_spmv")
    cc, cx, cy, cz = coeffs
    taps, cf = tap_arrays(_TAPS7, (cc, cz, cz, cy, cy, cx, cx))
    lib = _build.library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cgx_stencil3d_spmv(x.data_ptr(), y.data_ptr(), nx, ny, nz,
                                    len(_TAPS7), taps, cf, stream)
    _build.check(rc, "stencil3d_spmv first design launch")
    return y

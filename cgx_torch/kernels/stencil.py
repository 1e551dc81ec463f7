"""K1: 7-point 3-D stencil SpMV — CUDA kernel and its plain version.

Replaces the Pallas kernel :func:`cgx.kernels.stencil.stencil3d_spmv_pallas`
(``_kernel``: one halo-window DMA per block).  The CUDA source
(``cgx_torch/csrc/stencil.cu``, tap loop in ``stencil.cuh``) runs one thread
per row over the flat vector with no padded operand: the boundary masks
come from index arithmetic.  Its floor is bytes, about 8 B/row (read x,
write y) when the neighbour reads hit L1/L2; this first version runs
about 5× above that floor at 128³ (see PERF.md).

:func:`stencil3d_spmv` launches the kernel for a CUDA tensor and takes the
plain PyTorch version, :func:`stencil3d_spmv_reference`, only for a CPU
tensor.  ``stencil3d_spmv_launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from cgx_torch.sparse.stencil import Stencil3D

__all__ = ["stencil3d_spmv", "stencil3d_spmv_reference",
           "stencil3d_spmv_launches"]

# Kernel launches so far (a run resets it to show which kernels it used).
stencil3d_spmv_launches = 0

# Tap order of the 7-point operator, as in cgx.kernels.fused_cg.stencil_taps.
_TAPS7 = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
          (1, 0, 0), (-1, 0, 0))


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


def stencil3d_spmv(x: torch.Tensor, *, nx: int, ny: int, nz: int,
                   coeffs=(6.0, -1.0, -1.0, -1.0)) -> torch.Tensor:
    """``y = A x`` for the 7-point stencil; ``x`` flat ``(nx·ny·nz,)``."""
    global stencil3d_spmv_launches
    if x.device.type == "cpu":
        return stencil3d_spmv_reference(x, nx, ny, nz, coeffs)
    if x.device.type != "cuda":
        raise ValueError(f"stencil3d_spmv: unsupported device {x.device}")
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
    _build.check(rc, "stencil3d_spmv launch")
    stencil3d_spmv_launches += 1
    return y

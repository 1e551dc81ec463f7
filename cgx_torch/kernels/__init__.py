"""Hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``cgx.kernels``; exports the same surface: the block-ELL
product, the stencil SpMV and the solvers over the two-pass, multi-RHS,
whole-solve and semi-resident kernels.  The solvers are imported on first
use: ``cgx_torch.ops.spmv`` imports this package, and the solvers import
``cgx_torch.ops.spmv``.  One name differs: ``fused_dia_cg`` here is the
module, as the port's callers use it (in the JAX package the function
shadows its module); the function is ``fused_dia_cg.fused_dia_cg``.
"""
import importlib

from cgx_torch.kernels.bsr import (BlockELL, bell_from_bsr, bell_spmm,
                                   bell_spmv)

# Exported functions imported on first use: name -> module.
_LAZY = {
    "stencil3d_spmv": "stencil",
    "fused_stencil_cg": "fused_cg",
    "fused_stencil_cg_multi": "fused_multi",
    "fused_dia_cg_multi": "fused_multi",
    "resident_stencil_cg": "fused_resident",
    "resident_dia_cg": "fused_resident",
    "sr_stencil_cg": "fused_semiresident",
    "sr_dia_cg": "fused_semiresident",
}

__all__ = ["BlockELL", "bell_from_bsr", "bell_spmm", "bell_spmv",
           "fused_dia_cg", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

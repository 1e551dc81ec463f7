"""cgx_torch — the PyTorch / CUDA port of cgx for NVIDIA Hopper.

The JAX package ``cgx`` is the reference; every module here has one
counterpart there.  Plain tensor code is PyTorch; the TPU kernels on the
ported path are hand-written CUDA C++ for ``sm_90a`` under
``cgx_torch/csrc``, built with ``nvcc`` at first use.  Importing this
package imports neither JAX nor ``cgx`` and needs no GPU.
"""
from cgx_torch.sparse.stencil import (GeneralStencil3D, Stencil2D, Stencil3D,
                                      poisson2d_stencil, poisson3d_27point,
                                      poisson3d_stencil)
from cgx_torch.sparse.types import (BSRMatrix, COOMatrix, CSRMatrix,
                                    DIAMatrix, ELLMatrix, bsr_from_csr,
                                    coo_from_scipy, csr_from_scipy,
                                    dia_from_csr, ell_from_csr)
from cgx_torch.sparse.wbell import (WBELL_MIN_ROWS, WBELLMatrix, auto_format,
                                    pick_format, wbell_from_csr)
from cgx_torch.ops.spmv import spmm, spmv
from cgx_torch.ops import blas
from cgx_torch.solve.cg import (CGResult, cg_solve, cg_solve_pipelined,
                                cg_solve_single_reduction)
from cgx_torch.solve.precond import (BlockJacobiPrecond, JacobiPrecond,
                                     PolynomialPrecond)
from cgx_torch.solve.ic0 import IC0Precond, IC0SweepPrecond
from cgx_torch.solve.block import block_cg_solve, cg_solve_multi
from cgx_torch.solve.wbell import (WBellBlockJacobiPrecond, wbell_cg_solve,
                                   wbell_cg_solve_multi)
from cgx_torch.solve.ir import ir_cg_solve, ir_supported
from cgx_torch.solve.auto import auto_solve, select_backend
from cgx_torch.solve.chebyshev import (analytic_bounds, chebyshev_solve,
                                       estimate_bounds)
from cgx_torch.solve.hp import (IRDF64Operator, df64_cg_solve, ir_df64_solve,
                                make_ir_df64_solver,
                                make_ir_df64_solver_multi)
from cgx_torch.utils.checkpoint import cg_solve_checkpointed

__version__ = "0.1.0"

__all__ = [
    "Stencil2D", "Stencil3D", "GeneralStencil3D", "poisson2d_stencil",
    "poisson3d_stencil", "poisson3d_27point", "COOMatrix", "CSRMatrix",
    "BSRMatrix", "DIAMatrix", "ELLMatrix", "WBELLMatrix", "csr_from_scipy",
    "coo_from_scipy", "bsr_from_csr", "dia_from_csr",
    "ell_from_csr", "wbell_from_csr", "auto_format", "pick_format",
    "WBELL_MIN_ROWS", "spmv", "spmm", "blas", "CGResult", "cg_solve",
    "cg_solve_single_reduction", "cg_solve_pipelined",
    "wbell_cg_solve", "wbell_cg_solve_multi", "WBellBlockJacobiPrecond",
    "JacobiPrecond", "BlockJacobiPrecond", "PolynomialPrecond",
    "cg_solve_multi", "block_cg_solve", "auto_solve", "select_backend",
    "ir_cg_solve", "ir_supported", "analytic_bounds", "chebyshev_solve",
    "estimate_bounds", "IC0Precond", "IC0SweepPrecond",
    "cg_solve_checkpointed", "df64_cg_solve", "ir_df64_solve",
    "make_ir_df64_solver", "make_ir_df64_solver_multi", "IRDF64Operator",
]

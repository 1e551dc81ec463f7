"""Carry operators, preconditioners, vectors and results between cgx and
cgx_torch.

Everything crosses as numpy arrays or plain fields, so this module imports
neither JAX nor ``cgx``: a ``cgx`` object is read by its class name and
fields.  The data of a ``DIAMatrix``, ``CSRMatrix``, ``COOMatrix``,
``BSRMatrix``, ``BlockELL`` or ``WBELLMatrix`` (every field, the static
ones included; bfloat16 values stay bfloat16) and of a ``JacobiPrecond``,
``BlockJacobiPrecond``, ``WBellBlockJacobiPrecond``,
``PolynomialPrecond``, ``IC0Precond`` or ``IC0SweepPrecond`` is copied to
``device`` (the card unless the caller asks for the CPU), so both packages
solve the same system from the same numbers.  The df64 state crosses the
same way: a ``DF64ELL`` or an ``IRDF64Operator`` (``operator_from_cgx``),
a ``DF64`` pair (``df64_from_cgx``) and a ``CGState`` snapshot
(``state_from_cgx``).  A ``cgx.dist`` ``Partition`` becomes the port's
host-side :class:`~cgx_torch.dist.partition.Partition`
(``partition_from_cgx``).
"""
from __future__ import annotations

import numpy as np
import torch

from cgx_torch.solve.cg import CGResult
from cgx_torch.solve.ic0 import IC0Precond, IC0SweepPrecond
from cgx_torch.solve.precond import (BlockJacobiPrecond, JacobiPrecond,
                                     PolynomialPrecond)
from cgx_torch.solve.wbell import WBellBlockJacobiPrecond
from cgx_torch.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D
from cgx_torch.kernels.bsr import BlockELL
from cgx_torch.sparse.types import (BSRMatrix, COOMatrix, CSRMatrix,
                                    DIAMatrix, resolve_device)
from cgx_torch.sparse.wbell import WBELLMatrix

__all__ = ["operator_from_cgx", "precond_from_cgx", "tensor_from_numpy",
           "result_to_numpy", "df64_from_cgx", "state_from_cgx",
           "partition_from_cgx"]


def operator_from_cgx(a, device="cuda"):
    """The port's operator for a ``cgx`` ``Stencil2D``/``Stencil3D``/
    ``GeneralStencil3D``/``DIAMatrix``/``CSRMatrix``/``COOMatrix``/
    ``BSRMatrix``/``BlockELL``/``WBELLMatrix``/``DF64ELL``/
    ``IRDF64Operator`` (duck-typed by class name and fields; a port
    operator is read the same way).  Stored data lands on ``device``; a
    stencil stores none."""
    kind = type(a).__name__
    if kind == "DF64ELL":
        from cgx_torch.solve.hp import DF64ELL
        return DF64ELL(vhi=tensor_from_numpy(a.vhi, device),
                       vlo=tensor_from_numpy(a.vlo, device),
                       col_indices=tensor_from_numpy(
                           a.col_indices, device).to(torch.int64),
                       shape=(int(a.shape[0]), int(a.shape[1])))
    if kind == "IRDF64Operator":
        from cgx_torch.solve.hp import IRDF64Operator
        return IRDF64Operator(
            a_hp=operator_from_cgx(a.a_hp, device),
            wb=None if a.wb is None else operator_from_cgx(a.wb, device),
            diag=np.asarray(_numpy(a.diag), np.float64))
    dtype_name = str(getattr(a, "dtype_name", "float32"))
    if kind == "Stencil3D":
        return Stencil3D(nx=int(a.nx), ny=int(a.ny), nz=int(a.nz),
                         c_center=float(a.c_center), c_x=float(a.c_x),
                         c_y=float(a.c_y), c_z=float(a.c_z),
                         dtype_name=dtype_name)
    if kind == "Stencil2D":
        return Stencil2D(nx=int(a.nx), ny=int(a.ny),
                         c_center=float(a.c_center), c_x=float(a.c_x),
                         c_y=float(a.c_y), dtype_name=dtype_name)
    if kind == "GeneralStencil3D":
        return GeneralStencil3D(
            nx=int(a.nx), ny=int(a.ny), nz=int(a.nz),
            taps=tuple(tuple(int(d) for d in t) for t in a.taps),
            coeffs=tuple(float(c) for c in a.coeffs),
            dtype_name=dtype_name)
    if kind == "DIAMatrix":
        grid = getattr(a, "grid", None)
        return DIAMatrix(data=tensor_from_numpy(a.data, device),
                         offsets=tuple(int(o) for o in a.offsets),
                         shape=(int(a.shape[0]), int(a.shape[1])),
                         grid=None if grid is None
                         else tuple(int(g) for g in grid))
    if kind == "CSRMatrix":
        return CSRMatrix.from_arrays(_numpy(a.values), _numpy(a.col_indices),
                                     _numpy(a.indptr), a.shape,
                                     device=device)
    shape = tuple(int(d) for d in getattr(a, "shape", ()))

    def field(name, dtype=None):
        v = tensor_from_numpy(getattr(a, name), device)
        return v if dtype is None else v.to(dtype)

    if kind == "COOMatrix":
        return COOMatrix(values=field("values"),
                         row_indices=field("row_indices", torch.int64),
                         col_indices=field("col_indices", torch.int64),
                         shape=shape)
    if kind == "BSRMatrix":
        return BSRMatrix(values=field("values"),
                         col_indices=field("col_indices", torch.int64),
                         indptr=field("indptr", torch.int64),
                         row_indices=field("row_indices", torch.int64),
                         shape=shape, blocksize=int(a.blocksize))
    if kind == "BlockELL":
        return BlockELL(values=field("values"),
                        block_cols=field("block_cols", torch.int32),
                        shape=shape)
    if kind == "WBELLMatrix":
        return WBELLMatrix(
            values=field("values"), diag_internal=field("diag_internal"),
            perm=field("perm", torch.int64),
            iperm=field("iperm", torch.int64),
            **{f: field(f, torch.int32)
               for f in ("lc", "outg", "ps", "wb", "zi", "g0", "gn", "pgo",
                         "p_og", "p_ga")},
            shape=shape,
            **{f: int(getattr(a, f)) for f in ("ng_real", "nt", "ngw",
                                               "wbcap", "span", "nnz")})
    raise TypeError(f"operator_from_cgx: unsupported operator {kind!r}")


def precond_from_cgx(m, device="cuda", operator=None):
    """The port's preconditioner for a ``cgx`` ``JacobiPrecond`` (its
    ``inv_diag``), ``BlockJacobiPrecond`` (its ``inv_blocks`` and
    ``blocksize``), ``WBellBlockJacobiPrecond`` (its ``binv``) or
    ``PolynomialPrecond`` (its ``inv_diag``, ``steps`` and ``omega``, over
    ``operator``, the port's operator for the same matrix: the JAX
    object's matvec is a closure and cannot cross), ``IC0Precond`` (its
    forward and backward level packings, ``n``, ``n_levels`` and
    ``perm``) or ``IC0SweepPrecond`` (its ``lower`` and ``upper`` DIA
    triangles, ``inv_diag``, ``nsweeps`` and ``n_levels``).  Data lands
    on ``device``."""
    kind = type(m).__name__
    if kind == "JacobiPrecond":
        return JacobiPrecond(inv_diag=tensor_from_numpy(m.inv_diag, device))
    if kind == "BlockJacobiPrecond":
        return BlockJacobiPrecond(
            inv_blocks=tensor_from_numpy(m.inv_blocks, device),
            blocksize=int(m.blocksize))
    if kind == "WBellBlockJacobiPrecond":
        return WBellBlockJacobiPrecond(binv=tensor_from_numpy(m.binv,
                                                              device))
    if kind == "PolynomialPrecond":
        if operator is None:
            raise ValueError("precond_from_cgx: a PolynomialPrecond needs "
                             "operator=, the port's operator it applies")
        return PolynomialPrecond(operator,
                                 tensor_from_numpy(m.inv_diag, device),
                                 steps=int(m.steps), omega=float(m.omega))
    if kind == "IC0Precond":
        fields = {f: tensor_from_numpy(getattr(m, f), device)
                  for f in ("f_rows", "f_cols", "f_vals", "f_inv_diag",
                            "b_rows", "b_cols", "b_vals", "b_inv_diag")}
        perm = None if m.perm is None else tuple(
            tensor_from_numpy(p, device) for p in m.perm)
        return IC0Precond(**fields, n=int(m.n), n_levels=int(m.n_levels),
                          perm=perm)
    if kind == "IC0SweepPrecond":
        return IC0SweepPrecond(lower=operator_from_cgx(m.lower, device),
                               upper=operator_from_cgx(m.upper, device),
                               inv_diag=tensor_from_numpy(m.inv_diag,
                                                          device),
                               nsweeps=int(m.nsweeps),
                               n_levels=int(m.n_levels))
    raise TypeError(f"precond_from_cgx: unsupported preconditioner "
                    f"{kind!r}")


def df64_from_cgx(x, device="cuda"):
    """The port's :class:`~cgx_torch.ops.df64.DF64` for a ``cgx`` ``DF64``
    (its ``hi`` and ``lo`` words, on ``device``)."""
    from cgx_torch.ops.df64 import DF64
    return DF64(tensor_from_numpy(x.hi, device),
                tensor_from_numpy(x.lo, device))


def state_from_cgx(state, device="cuda"):
    """The port's :class:`~cgx_torch.solve.cg.CGState` for a ``cgx``
    ``CGState`` (every field, on ``device``), to resume its solve through
    :func:`cgx_torch.solve.cg.cg_chunk`."""
    from cgx_torch.solve.cg import CGState
    return CGState(**{f: tensor_from_numpy(getattr(state, f), device)
                      for f in ("x", "r", "z", "p", "rz", "rr", "k",
                                "history")})


def partition_from_cgx(part):
    """The port's :class:`~cgx_torch.dist.partition.Partition` for a
    ``cgx.dist`` ``Partition``: the same stacked arrays, on the host, and
    the same static fields."""
    from cgx_torch.dist.partition import Partition

    def host(v):
        return None if v is None else np.array(_numpy(v), copy=True)

    return Partition(
        ell_values=host(part.ell_values), ell_cols=host(part.ell_cols),
        dia_data=host(part.dia_data),
        dia_offsets=tuple(int(o) for o in part.dia_offsets),
        kind=str(part.kind), mode=str(part.mode), n=int(part.n),
        n_shards=int(part.n_shards), rows_local=int(part.rows_local),
        halo_lo=int(part.halo_lo), halo_hi=int(part.halo_hi))


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def tensor_from_numpy(v, device="cuda") -> torch.Tensor:
    """A copy of an array (numpy, a tensor, or anything ``np.asarray``
    takes, such as a JAX array) as a tensor on ``device`` (the card unless
    the caller asks for the CPU; without a card the default raises).
    bfloat16 (a tensor, or numpy's ``ml_dtypes`` type) stays bfloat16."""
    dev = resolve_device(device)
    if isinstance(v, torch.Tensor):
        return v.detach().to(dev, copy=True)
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":      # exact through float32
        return torch.from_numpy(arr.astype(np.float32)).to(dev).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def result_to_numpy(res: CGResult) -> dict:
    """A :class:`CGResult`'s fields as numpy arrays.  ``iterations`` and
    ``converged`` are a Python int and bool for a single right-hand side
    and ``(k,)`` arrays for a batched result."""
    its = res.iterations.detach().cpu().numpy()
    conv = res.converged.detach().cpu().numpy()
    return {
        "x": res.x.detach().cpu().numpy(),
        "iterations": int(its) if its.ndim == 0 else its,
        "residual_norm_sq": res.residual_norm_sq.detach().cpu().numpy(),
        "converged": bool(conv) if conv.ndim == 0 else conv,
        "history": res.history.detach().cpu().numpy(),
    }

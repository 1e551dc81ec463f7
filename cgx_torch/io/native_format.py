"""cgx's own on-disk matrix format: ``.npz`` with a format tag (PyTorch).

Counterpart of :mod:`cgx.io.native_format`, byte for byte: the same
``kind`` tags, array names, dtypes and statics, so a file written by
either package loads in the other.  Binary and exact, unlike the
reference's decimal text format (``cg.c:146-218``): a round trip keeps
every bit.  It stores any container (the matrix-free stencils as their
dimensions and coefficients only) and the operator bundle of the df64
refinement solver.

Index arrays are written as the JAX package keeps them (int32; the
port's int64 indices are narrowed, which the JAX package's shapes
allow) and read back as the port's index dtypes.  A loaded
``WBELLMatrix`` builds its row layouts lazily at first use, as a built
one does.  :func:`load_matrix` and :func:`load_df64_operator` put the
arrays on ``device`` (the card unless the caller asks for the CPU); a
right-hand side comes back as a host numpy array from
:func:`load_df64_operator` and as a tensor on ``device`` from
:func:`load_matrix`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_matrix", "load_matrix", "save_df64_operator",
           "load_df64_operator", "peek_kind"]

# WBELL's arrays and statics, in the JAX package's order.
_WBELL_FIELDS = ("values", "lc", "outg", "ps", "wb", "zi", "g0", "gn",
                 "perm", "iperm", "diag_internal", "pgo", "p_og", "p_ga")
_WBELL_STATICS = ("ng_real", "nt", "ngw", "wbcap", "span", "nnz")


def _np(v, dtype=None) -> np.ndarray:
    """A host numpy copy of a tensor or array; bfloat16 through fp32."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        v = v.cpu().numpy()
    v = np.asarray(v)
    return v if dtype is None else v.astype(dtype)


def _t(arr, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from a loaded array (a bfloat16 field written
    through ``ml_dtypes`` comes back as raw 2-byte void: its bits)."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _shape(z) -> tuple:
    return tuple(int(v) for v in z["shape"])


def peek_kind(path: str) -> str:
    """The format tag of a saved ``.npz`` without loading its arrays."""
    with np.load(path) as z:
        return str(z["kind"])


def _wbell_arrays(wb, prefix: str = "") -> dict:
    out = {}
    for f in _WBELL_FIELDS:
        v = getattr(wb, f)
        out[prefix + f] = _np(v) if f in ("values", "diag_internal") \
            else _np(v, np.int32)
    return out


def _wbell_from(z, shape, statics, prefix: str, device):
    from cgx_torch.sparse.wbell import WBELLMatrix

    fields = {}
    for f in _WBELL_FIELDS:
        if f in ("values", "diag_internal"):
            fields[f] = _t(z[prefix + f], device)
        elif f in ("perm", "iperm"):
            fields[f] = _t(z[prefix + f], device, torch.int64)
        else:
            fields[f] = _t(z[prefix + f], device, torch.int32)
    return WBELLMatrix(**fields, shape=shape,
                       **{s: int(v) for s, v in zip(_WBELL_STATICS,
                                                    statics)})


def save_df64_operator(path: str, op, b=None) -> None:
    """Persist an :class:`cgx_torch.solve.hp.IRDF64Operator` bundle: the
    df64 ELL split (exact hi/lo of the fp64 operator), the fp32 WBELL
    operator of the inners and the fp64 diagonal, so that a later process
    skips the host builds (``make_ir_df64_solver(prebuilt=...)``)."""
    arrays = dict(kind="ir_df64",
                  hp_vhi=_np(op.a_hp.vhi), hp_vlo=_np(op.a_hp.vlo),
                  hp_cols=_np(op.a_hp.col_indices, np.int32),
                  shape=np.asarray(op.a_hp.shape),
                  diag=_np(op.diag, np.float64))
    if op.wb is not None:
        arrays["wb_statics"] = np.asarray(
            [getattr(op.wb, s) for s in _WBELL_STATICS])
        arrays.update(_wbell_arrays(op.wb, "wb_"))
    if b is not None:
        arrays["rhs"] = _np(b)
    np.savez_compressed(path, **arrays)


def load_df64_operator(path: str, device="cuda"):
    """Load ``(IRDF64Operator, rhs_or_None)`` saved by
    :func:`save_df64_operator` (by either package), its arrays on
    ``device``."""
    from cgx_torch.solve.hp import DF64ELL, IRDF64Operator
    from cgx_torch.sparse.types import resolve_device

    dev = resolve_device(device)
    with np.load(path) as z:
        if str(z["kind"]) != "ir_df64":
            raise ValueError(f"{path}: not an ir_df64 operator bundle")
        b = np.asarray(z["rhs"]) if "rhs" in z else None
        shape = _shape(z)
        a_hp = DF64ELL(vhi=_t(z["hp_vhi"], dev), vlo=_t(z["hp_vlo"], dev),
                       col_indices=_t(z["hp_cols"], dev, torch.int64),
                       shape=shape)
        wb = None
        if "wb_statics" in z:
            wb = _wbell_from(z, shape, z["wb_statics"], "wb_", dev)
        return IRDF64Operator(a_hp=a_hp, wb=wb,
                              diag=np.asarray(z["diag"], np.float64)), b


def save_matrix(path: str, a, b=None) -> None:
    """Save a matrix of the port (and an optional right-hand side) to
    ``.npz``."""
    from cgx_torch.sparse import stencil, types
    from cgx_torch.sparse.wbell import WBELLMatrix

    if isinstance(a, types.CSRMatrix):
        arrays = dict(kind="csr", values=_np(a.values),
                      col_indices=_np(a.col_indices, np.int32),
                      indptr=_np(a.indptr, np.int32),
                      shape=np.asarray(a.shape))
    elif isinstance(a, types.COOMatrix):
        arrays = dict(kind="coo", values=_np(a.values),
                      row_indices=_np(a.row_indices, np.int32),
                      col_indices=_np(a.col_indices, np.int32),
                      shape=np.asarray(a.shape))
    elif isinstance(a, types.DIAMatrix):
        arrays = dict(kind="dia", data=_np(a.data),
                      offsets=np.asarray(a.offsets),
                      shape=np.asarray(a.shape))
    elif isinstance(a, types.ELLMatrix):
        arrays = dict(kind="ell", values=_np(a.values),
                      col_indices=_np(a.col_indices, np.int32),
                      shape=np.asarray(a.shape))
    elif isinstance(a, types.BSRMatrix):
        arrays = dict(kind="bsr", values=_np(a.values),
                      col_indices=_np(a.col_indices, np.int32),
                      indptr=_np(a.indptr, np.int32),
                      shape=np.asarray(a.shape),
                      blocksize=np.asarray(a.blocksize))
    elif isinstance(a, stencil.Stencil3D):
        arrays = dict(kind="stencil3d",
                      dims=np.asarray([a.nx, a.ny, a.nz]),
                      coeffs=np.asarray([a.c_center, a.c_x, a.c_y, a.c_z]))
    elif isinstance(a, stencil.Stencil2D):
        arrays = dict(kind="stencil2d", dims=np.asarray([a.nx, a.ny]),
                      coeffs=np.asarray([a.c_center, a.c_x, a.c_y]))
    elif isinstance(a, WBELLMatrix):
        # The built operator: its host build amortises across processes.
        arrays = dict(kind="wbell", shape=np.asarray(a.shape),
                      statics=np.asarray([getattr(a, s)
                                          for s in _WBELL_STATICS]))
        arrays.update(_wbell_arrays(a))
    else:
        raise TypeError(f"save_matrix: unsupported type {type(a)!r}")
    if b is not None:
        arrays["rhs"] = _np(b)
    np.savez_compressed(path, **arrays)


def load_matrix(path: str, device="cuda"):
    """Load ``(matrix, rhs_or_None)`` saved by :func:`save_matrix` (by
    either package), on ``device``."""
    from cgx_torch.sparse import stencil, types
    from cgx_torch.sparse.types import resolve_device

    dev = resolve_device(device)
    i64 = torch.int64
    with np.load(path) as z:
        kind = str(z["kind"])
        b = _t(z["rhs"], dev) if "rhs" in z else None
        if kind == "csr":
            a = types.CSRMatrix.from_arrays(
                np.asarray(z["values"]), z["col_indices"], z["indptr"],
                _shape(z), device=dev)
        elif kind == "coo":
            a = types.COOMatrix(_t(z["values"], dev),
                                _t(z["row_indices"], dev, i64),
                                _t(z["col_indices"], dev, i64), _shape(z))
        elif kind == "dia":
            a = types.DIAMatrix(_t(z["data"], dev),
                                tuple(int(v) for v in z["offsets"]),
                                _shape(z))
        elif kind == "ell":
            a = types.ELLMatrix(_t(z["values"], dev),
                                _t(z["col_indices"], dev, i64), _shape(z))
        elif kind == "bsr":
            indptr = np.asarray(z["indptr"])
            counts = np.diff(indptr)
            rows = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
            a = types.BSRMatrix(_t(z["values"], dev),
                                _t(z["col_indices"], dev, i64),
                                _t(indptr, dev, i64), _t(rows, dev),
                                _shape(z), int(z["blocksize"]))
        elif kind == "stencil3d":
            d, c = z["dims"], z["coeffs"]
            a = stencil.Stencil3D(int(d[0]), int(d[1]), int(d[2]),
                                  float(c[0]), float(c[1]), float(c[2]),
                                  float(c[3]))
        elif kind == "stencil2d":
            d, c = z["dims"], z["coeffs"]
            a = stencil.Stencil2D(int(d[0]), int(d[1]), float(c[0]),
                                  float(c[1]), float(c[2]))
        elif kind == "wbell":
            a = _wbell_from(z, _shape(z), z["statics"], "", dev)
        else:
            raise ValueError(f"unknown format kind {kind!r}")
    return a, b

"""Debug printers: the reference's ``print_sparse`` dump (PyTorch).

Counterpart of :mod:`cgx.utils.debug`.  The reference dumps size, nnz and
every value with ``\\t%f`` lines (``mv_ops.c:77-95``) and uses it both for
debugging and for emitting the final solution (``cg.c:78``).
:func:`print_sparse` writes that format for any of the port's containers
(anything with ``.values`` or ``.data``) or a vector (a tensor on any
device, or an array); :func:`format_sparse` returns the string.
"""
from __future__ import annotations

import io
import sys
from typing import Optional

import numpy as np
import torch

__all__ = ["print_sparse", "format_sparse"]


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def format_sparse(a, max_entries: Optional[int] = None) -> str:
    """Reference-format dump: ``Size: n``, ``NNZ: k``, then ``\\t%f``
    values (the first ``max_entries`` of them, and a count of the rest)."""
    out = io.StringIO()
    if hasattr(a, "values") and not callable(a.values):
        vals = _host(a.values).ravel()
        n = a.shape[0]
    elif isinstance(a, np.ndarray) or (hasattr(a, "data")
                                       and not isinstance(a, torch.Tensor)):
        vals = _host(a if isinstance(a, np.ndarray) else a.data).ravel()
        n = a.shape[0]
    else:
        vals = _host(a).ravel()
        n = vals.shape[0]
    nnz = int(np.count_nonzero(vals)) if vals.size else 0
    out.write(f"Size: {n}\n")
    out.write(f"NNZ: {nnz}\n")
    shown = vals if max_entries is None else vals[:max_entries]
    for v in shown:
        out.write("\t%f\n" % float(v))
    if max_entries is not None and vals.size > max_entries:
        out.write(f"\t... ({vals.size - max_entries} more)\n")
    return out.getvalue()


def print_sparse(a, max_entries: Optional[int] = None, file=None) -> None:
    (file or sys.stdout).write(format_sparse(a, max_entries))

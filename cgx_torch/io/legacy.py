"""Reader and writer of the reference C program's 4-line input format.

Counterpart of :mod:`cgx.io.legacy`.  The format (the reference's
``read_input_file``, ``cg.c:146-218``; SURVEY.md §3.3) is four
comma-separated lines:

```
line 0: col_indices (nnz ints)
line 1: row_ptr     (n+1 ints)     — A.size = count - 1 (cg.c:204)
line 2: A values    (nnz doubles)
line 3: b values    (n doubles)
```

:func:`read_legacy` parses with the port's native C++ parser
(:mod:`cgx_torch.native`, built at first use), the JAX package's choice
for the reference's full scale (~18 M nonzeros).  :func:`parse_numpy`,
one numpy call a line, stays beside it as the plain version; no
fallback reaches it.  The writer writes integers with ``str`` and floats
with ``repr`` (shortest round-trip), as the JAX package does, so a file
read back gives the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from cgx_torch.sparse.types import CSRMatrix, resolve_device

__all__ = ["read_legacy", "parse_numpy", "write_legacy"]


def read_legacy(path: str, dtype=np.float64, device="cuda"):
    """Parse the 4-line format with the native parser → ``(CSRMatrix,
    b)`` on ``device``."""
    from cgx_torch.native import parse_legacy

    dev = resolve_device(device)
    col_indices, indptr, values, b = parse_legacy(path)
    values = values.astype(dtype, copy=False)
    b = b.astype(dtype, copy=False)
    n = len(indptr) - 1
    a = CSRMatrix.from_arrays(values, col_indices, indptr, (n, n), device=dev)
    return a, torch.from_numpy(b).to(dev)


def parse_numpy(path: str, dtype=np.float64):
    """The plain parse, one numpy call a line → ``(col_indices, row_ptr,
    a_values, b_values)`` host arrays (int64, int64, ``dtype``,
    ``dtype``)."""
    with open(path, "r") as f:
        lines = [f.readline().strip() for _ in range(4)]
    col_indices = np.array(lines[0].split(","), dtype=np.int64)
    indptr = np.array(lines[1].split(","), dtype=np.int64)
    values = np.array(lines[2].split(","), dtype=dtype)
    b = np.array(lines[3].split(","), dtype=dtype)
    return col_indices, indptr, values, b


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def write_legacy(path: str, a, b) -> None:
    """Write ``(CSR matrix, rhs)`` in the 4-line format.  ``a`` is a
    :class:`CSRMatrix` (or anything with ``col_indices``, ``indptr`` and
    ``values``); the floats are written in float64."""
    cols = _host(a.col_indices)
    indptr = _host(a.indptr)
    values = _host(a.values).astype(np.float64)
    bv = _host(b).astype(np.float64)
    with open(path, "w") as f:
        f.write(",".join(map(str, cols.tolist())) + "\n")
        f.write(",".join(map(str, indptr.tolist())) + "\n")
        f.write(",".join(map(repr, values.tolist())) + "\n")
        f.write(",".join(map(repr, bv.tolist())) + "\n")

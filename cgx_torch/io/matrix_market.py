"""Matrix Market (``.mtx``) reading and writing (PyTorch).

Counterpart of :func:`cgx.io.matrix_market.read_matrix_market` and
``write_matrix_market``: parsing is host-side (scipy's ``mmread``), and the
result is the port's :class:`~cgx_torch.sparse.types.CSRMatrix` on
``device``.  The local SuiteSparse loader is
:func:`cgx_torch.io.suitesparse.load_suitesparse`; nothing here fetches.
"""
from __future__ import annotations

import gzip

import numpy as np

from cgx_torch.sparse.types import CSRMatrix, csr_from_scipy

__all__ = ["read_matrix_market", "write_matrix_market"]


def read_matrix_market(path: str, dtype=np.float64,
                       device="cuda") -> CSRMatrix:
    """Read ``.mtx`` / ``.mtx.gz`` into a :class:`CSRMatrix` on
    ``device``.  Symmetric storage is expanded to full; pattern matrices
    get unit values."""
    import scipy.io
    import scipy.sparse as sp

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        m = scipy.io.mmread(f)
    if not sp.issparse(m):
        m = sp.csr_matrix(m)
    return csr_from_scipy(m.tocsr().astype(dtype), device=device)


def write_matrix_market(path: str, a: CSRMatrix, comment: str = "") -> None:
    """Write a CSR matrix (the port's, or anything with ``values``,
    ``col_indices``, ``indptr`` and ``shape``) as coordinate ``.mtx``."""
    import scipy.io
    import scipy.sparse as sp

    def host(v):
        return v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)

    s = sp.csr_matrix((host(a.values), host(a.col_indices), host(a.indptr)),
                      shape=a.shape)
    scipy.io.mmwrite(path, s, comment=comment)

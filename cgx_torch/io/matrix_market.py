"""Matrix Market (``.mtx``) reading and writing (PyTorch).

Counterpart of :func:`cgx.io.matrix_market.read_matrix_market` and
``write_matrix_market``: parsing is host-side (scipy's ``mmread``), and the
result is the port's :class:`~cgx_torch.sparse.types.CSRMatrix` on
``device``.

:func:`load_suitesparse` is the counterpart of
:func:`cgx.io.matrix_market.load_suitesparse`: it reads a SuiteSparse
matrix by name from a local directory (``.mtx``, ``.mtx.gz`` or the
collection's ``.tar.gz`` bundle) and raises when it is not there.  Nothing
here fetches.  (:func:`cgx_torch.io.suitesparse.load_suitesparse`, which
returns ``None`` for a missing matrix, is the stand-in fallback's.)
"""
from __future__ import annotations

import gzip
import io
import os
import tarfile
from typing import Optional

import numpy as np

from cgx_torch.sparse.types import CSRMatrix, csr_from_scipy, resolve_device

__all__ = ["read_matrix_market", "write_matrix_market", "load_suitesparse"]


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


def load_suitesparse(name: str, directory: Optional[str] = None,
                     dtype=np.float64, device="cuda") -> CSRMatrix:
    """Load a SuiteSparse matrix by name from a local directory, as a
    :class:`CSRMatrix` on ``device``.

    Accepts ``<dir>/<name>.mtx``, ``<dir>/<name>.mtx.gz``, or the
    collection's ``<dir>/<name>.tar.gz`` bundle (which holds
    ``<name>/<name>.mtx``).  ``directory`` defaults to
    ``$CGX_SUITESPARSE_DIR``, else ``~/suitesparse``.  Raises
    ``FileNotFoundError``, naming the directory, when none is there.
    """
    dev = resolve_device(device)
    directory = directory or os.environ.get(
        "CGX_SUITESPARSE_DIR", os.path.expanduser("~/suitesparse"))
    for ext in (".mtx", ".mtx.gz"):
        p = os.path.join(directory, name + ext)
        if os.path.exists(p):
            return read_matrix_market(p, dtype, device=dev)
    tar = os.path.join(directory, f"{name}.tar.gz")
    if os.path.exists(tar):
        import scipy.io

        with tarfile.open(tar, "r:gz") as t:
            data = t.extractfile(t.getmember(f"{name}/{name}.mtx")).read()
        m = scipy.io.mmread(io.BytesIO(data)).tocsr().astype(dtype)
        return csr_from_scipy(m, device=dev)
    raise FileNotFoundError(
        f"SuiteSparse matrix {name!r} not found under {directory}. Nothing "
        "is fetched: place <name>.mtx[.gz] or the collection's "
        "<name>.tar.gz there (set CGX_SUITESPARSE_DIR to change the search "
        "path).")

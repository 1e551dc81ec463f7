"""SuiteSparse SPD matrices: the local loader and the stand-ins (PyTorch).

Counterpart of :mod:`cgx.io.suitesparse`, with its own copy of the
generators so that the port imports nothing of the JAX package.  The
stand-ins are built with numpy/scipy from the same seed and equal the JAX
package's entry for entry; the results are the port's
:class:`~cgx_torch.sparse.types.CSRMatrix` on ``device``.  Nothing is
fetched: :func:`load_suitesparse` looks only in a local directory
(``directory`` or ``$CGX_SUITESPARSE_DIR``), and :func:`load_or_standin`
falls back to the stand-in.

The stand-ins, each imitating the published properties of one matrix:

* ``thermal2`` (n = 1,228,045, ≈ 7 nnz/row): a FEM-style graph Laplacian
  of a random-point Delaunay triangulation of the unit square, with
  log-normal edge weights and a Dirichlet-like shift on the hull;
* ``bcsstk17``/``bcsstk18``: a 3-dof shell-grid stiffness surrogate with a
  log-normal stiffness field and per-dof scaling (~1e10 conditioning);
* ``ecology2``: a conductance-weighted 5-point grid Laplacian;
* ``G3_circuit``: a random-geometric-graph Laplacian with grounded nodes;
* ``parabolic_fem``: Delaunay diffusion plus a lumped mass term.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from cgx_torch.sparse.types import CSRMatrix, csr_from_scipy

__all__ = ["SUITESPARSE_SPD", "load_suitesparse", "standin",
           "load_or_standin"]

# Published collection metadata (dimension, nonzeros) for the target set.
SUITESPARSE_SPD = {
    "thermal2": dict(n=1_228_045, nnz=8_580_313, kind="unstructured FEM "
                     "thermal", cond="~1e6-1e7 (mesh Laplacian)"),
    "bcsstk17": dict(n=10_974, nnz=428_650, kind="shell stiffness",
                     cond="~1.3e10"),
    "bcsstk18": dict(n=11_948, nnz=149_090, kind="nuclear power station "
                     "stiffness", cond="~6.5e11"),
    "ecology2": dict(n=999_999, nnz=4_995_991, kind="weighted 2-D grid "
                     "Laplacian (landscape ecology)", cond="~1e7-1e8 "
                     "(2-D grid at h~1e-3)"),
    "G3_circuit": dict(n=1_585_478, nnz=7_660_826, kind="circuit "
                       "simulation graph Laplacian", cond="~1e6-1e7"),
    "parabolic_fem": dict(n=525_825, nnz=3_674_625, kind="parabolic FEM "
                          "(diffusion + mass)", cond="~1e5-1e6 "
                          "(mass term caps the grid conditioning)"),
}


def load_suitesparse(name: str, directory: Optional[str] = None,
                     device="cuda") -> Optional[CSRMatrix]:
    """The REAL matrix ``<dir>/<name>.mtx[.gz]`` on ``device`` if present,
    else ``None``.  ``directory`` defaults to ``$CGX_SUITESPARSE_DIR``."""
    directory = directory or os.environ.get("CGX_SUITESPARSE_DIR", "")
    if not directory:
        return None
    for ext in (".mtx", ".mtx.gz"):
        p = os.path.join(directory, name + ext)
        if os.path.exists(p):
            from cgx_torch.io.matrix_market import read_matrix_market
            return read_matrix_market(p, dtype=np.float64, device=device)
    return None


def _delaunay_laplacian(n_nodes: int, seed: int):
    """FEM-style graph Laplacian of a random Delaunay triangulation."""
    import scipy.sparse as sp
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_nodes, 2))
    tri = Delaunay(pts)
    # Undirected edge list from the triangle list.
    e = np.vstack([tri.simplices[:, [0, 1]], tri.simplices[:, [1, 2]],
                   tri.simplices[:, [2, 0]]])
    e.sort(axis=1)
    e = np.unique(e, axis=0)
    # Positive edge weights (mild conductivity variation, like a thermal
    # problem with varying material).
    w = rng.lognormal(0.0, 0.5, len(e))
    i, j = e[:, 0], e[:, 1]
    rows = np.concatenate([i, j])
    cols = np.concatenate([j, i])
    vals = np.concatenate([-w, -w])
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n_nodes, n_nodes)).tocsr()
    deg = -np.asarray(a.sum(axis=1)).ravel()
    # Dirichlet-like regularization on the convex hull (mirrors the fixed-
    # temperature boundary of the real problem; also makes it SPD, not
    # merely semi-definite).
    diag = deg.copy()
    diag[np.unique(tri.convex_hull)] += 1.0
    a = a + sp.diags(diag)
    return a.tocsr()


def _shell_stiffness(nodes_x: int, nodes_y: int, nodes_z: int, seed: int,
                     sigma_k: float = 1.0, sigma_d: float = 0.8):
    """3-dof-per-node grid 'stiffness' surrogate in proper incidence
    (graph-elasticity) form: for each of the 13 positive-direction
    neighbour offsets, edge energy ``(x_a - x_b)ᵀ B_e (x_a - x_b)`` with a
    rank-1+εI SPD 3x3 block ``B_e`` — PSD by construction, pinned SPD by a
    one-face Dirichlet clamp.  Conditioning comes from three physically
    faithful sources: the mesh (Laplacian (L/h)²), a log-normal element
    stiffness field (``sigma_k``), and log-normal per-dof scaling
    (``sigma_d`` — the part Jacobi recovers, as for the real bcsstk set).
    """
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    nn = nodes_x * nodes_y * nodes_z
    idx = np.arange(nn).reshape(nodes_x, nodes_y, nodes_z)
    k_node = rng.lognormal(0.0, sigma_k, nn)

    rows, cols, blocks = [], [], []
    offsets = [(dx, dy, dz)
               for dx in (0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
               if (dx, dy, dz) > (0, 0, 0)]
    for (dx, dy, dz) in offsets:
        sa = idx[max(0, -dx):nodes_x - max(0, dx),
                 max(0, -dy):nodes_y - max(0, dy),
                 max(0, -dz):nodes_z - max(0, dz)].ravel()
        sb = idx[max(0, dx):nodes_x - max(0, -dx),
                 max(0, dy):nodes_y - max(0, -dy),
                 max(0, dz):nodes_z - max(0, -dz)].ravel()
        k = np.sqrt(k_node[sa] * k_node[sb])
        d = rng.standard_normal((len(sa), 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        blk = (d[:, :, None] * d[:, None, :]
               + 0.05 * np.eye(3)) * k[:, None, None]
        # Incidence assembly: (a,a)+=B, (b,b)+=B, (a,b)-=B, (b,a)-=B.
        rows += [sa, sb, sa, sb]
        cols += [sa, sb, sb, sa]
        blocks += [blk, blk, -blk, -blk]

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    blocks = np.concatenate(blocks)
    order = np.argsort(rows, kind="stable")
    rows, cols, blocks = rows[order], cols[order], blocks[order]
    indptr = np.zeros(nn + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=nn), out=indptr[1:])
    a = sp.bsr_matrix((blocks, cols.astype(np.int32), indptr),
                      shape=(3 * nn, 3 * nn)).tocsr()
    a.sum_duplicates()
    # Dirichlet clamp on the x == 0 face (removes the rigid-body null
    # space, like the vessel's support constraints).
    pinned = np.repeat(idx[0].ravel() * 3, 3) + np.tile([0, 1, 2],
                                                        idx[0].size)
    clamp = np.zeros(3 * nn)
    clamp[pinned] = float(np.median(k_node))
    a = a + sp.diags(clamp)
    # Per-dof log-normal scaling (units/element-size contrast).
    d = sp.diags(rng.lognormal(0.0, sigma_d, 3 * nn))
    a = (d @ a @ d).tocsr()
    a.sort_indices()
    return a


def _weighted_grid2d_laplacian(nx: int, ny: int, seed: int,
                               sigma: float = 1.0):
    """5-point 2-D grid Laplacian with log-normal edge conductivities and
    a Dirichlet boundary ring (the ecology2 class: landscape-connectivity
    models are exactly conductance-weighted grid Laplacians)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    rows, cols, vals = [], [], []
    for (sa, sb) in ((idx[:-1, :].ravel(), idx[1:, :].ravel()),
                     (idx[:, :-1].ravel(), idx[:, 1:].ravel())):
        w = rng.lognormal(0.0, sigma, len(sa))
        rows += [sa, sb]
        cols += [sb, sa]
        vals += [-w, -w]
    a = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    diag = -np.asarray(a.sum(axis=1)).ravel()
    boundary = np.unique(np.concatenate(
        [idx[0], idx[-1], idx[:, 0], idx[:, -1]]))
    diag[boundary] += 1.0
    return (a + sp.diags(diag)).tocsr()


def _geometric_graph_laplacian(n_nodes: int, seed: int,
                               avg_degree: float = 3.8):
    """Random-geometric-graph Laplacian + grounded nodes (the G3_circuit
    class: circuit conductance matrices are graph Laplacians over sparse
    irregular node graphs with a few grounded terminals)."""
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = rng.random((n_nodes, 2))
    # Radius for the target mean degree: E[deg] = n·π·r².
    r = float(np.sqrt(avg_degree / (np.pi * n_nodes)))
    tree = cKDTree(pts)
    pairs = tree.query_pairs(r, output_type="ndarray")
    w = rng.lognormal(0.0, 0.7, len(pairs))
    i, j = pairs[:, 0], pairs[:, 1]
    a = sp.coo_matrix((np.concatenate([-w, -w]),
                       (np.concatenate([i, j]), np.concatenate([j, i]))),
                      shape=(n_nodes, n_nodes)).tocsr()
    diag = -np.asarray(a.sum(axis=1)).ravel()
    # Ground ~0.1% of the nodes (supply/ground rails) — pins the global
    # null space the way a circuit's reference node does.
    gnd = rng.choice(n_nodes, max(1, n_nodes // 1000), replace=False)
    diag[gnd] += 1.0
    # Leakage conductance to ground on every node: random geometric
    # graphs have floating subnets/isolated vertices that a real circuit
    # does not (everything leaks to substrate); 1e-6 of the mean degree
    # keeps them invertible at a realistic ~1e6-1e7 conditioning class.
    diag += 1e-6 * max(float(diag.mean()), 1.0)
    return (a + sp.diags(diag)).tocsr()


def _fem_diffusion_mass(n_nodes: int, seed: int, c: float = 10.0):
    """Delaunay FEM diffusion + lumped mass term ``L + c·M`` (the
    parabolic_fem class: an implicit time step of the heat equation — the
    mass term caps the conditioning at ~‖L‖/(c·m_min), well below the
    pure-Laplacian class)."""
    import scipy.sparse as sp

    a = _delaunay_laplacian(n_nodes, seed)
    rng = np.random.default_rng(seed + 1)
    # Lumped mass ~ nodal area share (uniform points: ~1/n each, with
    # mild variation).
    m = rng.uniform(0.5, 1.5, n_nodes) / n_nodes
    return (a + sp.diags(c * m)).tocsr()


def standin(name: str, seed: int = 0, scale: float = 1.0,
            device="cuda") -> CSRMatrix:
    """Synthetic stand-in for a SuiteSparse SPD matrix, on ``device``.
    ``scale < 1`` shrinks the dimension proportionally."""
    if name == "thermal2":
        n = int(SUITESPARSE_SPD[name]["n"] * scale)
        a = _delaunay_laplacian(n, seed)
    elif name == "ecology2":
        # 999,999 = 999 x 1001 grid.
        f = scale ** 0.5
        nx, ny = max(4, int(999 * f)), max(4, int(1001 * f))
        a = _weighted_grid2d_laplacian(nx, ny, seed)
    elif name == "G3_circuit":
        n = int(SUITESPARSE_SPD[name]["n"] * scale)
        a = _geometric_graph_laplacian(n, seed)
    elif name == "parabolic_fem":
        n = int(SUITESPARSE_SPD[name]["n"] * scale)
        a = _fem_diffusion_mass(n, seed)
    elif name in ("bcsstk17", "bcsstk18"):
        # 10,974 = 3 * 3,658 nodes; a 31 x 59 x 2 shell grid gives 3,658.
        base = dict(bcsstk17=(31, 59, 2), bcsstk18=(34, 59, 2))[name]
        if scale != 1.0:
            f = scale ** 0.5
            base = (max(2, int(base[0] * f)), max(2, int(base[1] * f)),
                    base[2])
        a = _shell_stiffness(*base, seed=seed)
    else:
        raise ValueError(f"no stand-in defined for {name!r}")
    return csr_from_scipy(a, device=device)


def load_or_standin(name: str, directory: Optional[str] = None,
                    scale: float = 1.0, device="cuda"):
    """``(matrix, is_standin)``: the real matrix when it is present
    locally, else the stand-in."""
    real = load_suitesparse(name, directory, device=device)
    if real is not None:
        return real, False
    return standin(name, scale=scale, device=device), True

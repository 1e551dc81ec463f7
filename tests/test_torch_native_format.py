"""The native ``.npz`` format of the port (``cgx_torch.io.native_format``)
against the JAX package's (``cgx.io.native_format``).

For every kind (CSR, COO, DIA, ELL, BSR, both stencils, WBELL) each
package builds the same matrix from the same scipy input and writes it:
the two files hold the same arrays under the same names with the same
dtypes, and each loads in the other package to that package's own build,
array for array.  The df64 operator bundle crosses both ways too, and a
bundle written by cgx is solved by the port.  Everything runs on the CPU.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cgx.io.native_format as jnf
import cgx_torch.io.native_format as tnf
from torch_parity import n_

CPU = "cpu"
KINDS = ("csr", "coo", "dia", "ell", "bsr", "stencil3d", "stencil2d",
         "wbell")


def _scipy_poisson2d():
    from cgx_torch.io.poisson import poisson2d_csr_arrays

    vals, cols, indptr, n = poisson2d_csr_arrays(7, 6)
    return sp.csr_matrix((vals, cols, indptr), shape=(n, n))


def _random_spd(n, density, seed):
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    return sp.csr_matrix(a + a.T + sp.eye(n) * 10.0)


def _build(kind, pkg):
    """The same matrix of ``kind`` built by cgx (``pkg="j"``) or the port
    (``"t"``, on the CPU)."""
    if pkg == "j":
        import cgx.io.poisson as P
        import cgx.sparse.stencil as S
        import cgx.sparse.types as T
        from cgx.sparse.wbell import wbell_from_csr
        kw = {}
    else:
        import cgx_torch.io.poisson as P
        import cgx_torch.sparse.stencil as S
        import cgx_torch.sparse.types as T
        from cgx_torch.sparse.wbell import wbell_from_csr
        kw = dict(device=CPU)
    s = _scipy_poisson2d()
    if kind == "csr":
        return T.csr_from_scipy(s, **kw)
    if kind == "coo":
        return T.coo_from_scipy(s, **kw)
    if kind == "dia":
        return P.poisson2d_dia(7, 6, **kw)
    if kind == "ell":
        return T.ell_from_csr(T.csr_from_scipy(s, **kw), **kw)
    if kind == "bsr":
        return T.bsr_from_csr(T.csr_from_scipy(s, **kw), 4)
    if kind == "stencil3d":
        return S.poisson3d_stencil(3, 4, 5)
    if kind == "stencil2d":
        return S.poisson2d_stencil(5, 6)
    return wbell_from_csr(_random_spd(700, 0.01, 41), **kw)


_FIELDS = {
    "csr": ("values", "col_indices", "indptr", "row_indices"),
    "coo": ("values", "row_indices", "col_indices"),
    "dia": ("data",),
    "ell": ("values", "col_indices"),
    "bsr": ("values", "col_indices", "indptr", "row_indices"),
    "stencil3d": (),
    "stencil2d": (),
    "wbell": tnf._WBELL_FIELDS,
}
_STATICS = {
    "dia": ("offsets", "shape"),
    "bsr": ("shape", "blocksize"),
    "stencil3d": ("nx", "ny", "nz", "c_center", "c_x", "c_y", "c_z"),
    "stencil2d": ("nx", "ny", "c_center", "c_x", "c_y"),
    "wbell": ("shape",) + tnf._WBELL_STATICS,
}


def _same_matrix(kind, got, ref):
    """Two containers (either package) equal field for field."""
    assert type(got).__name__ == type(ref).__name__
    for f in _FIELDS[kind]:
        g, r = n_(getattr(got, f)), n_(getattr(ref, f))
        np.testing.assert_array_equal(g, r, err_msg=f)
    for f in _STATICS.get(kind, ("shape",)):
        assert tuple(np.atleast_1d(getattr(got, f))) == tuple(
            np.atleast_1d(getattr(ref, f))), f


def _same_file(p, q):
    """Two ``.npz`` files hold the same arrays: names, dtypes, values."""
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_loads_in_cgx(tmp_path, kind):
    """The port writes; cgx loads its own build back, and the file is the
    one cgx writes for the same matrix."""
    p, q = str(tmp_path / "port.npz"), str(tmp_path / "cgx.npz")
    tnf.save_matrix(p, _build(kind, "t"))
    jnf.save_matrix(q, _build(kind, "j"))
    _same_file(p, q)
    got, rhs = jnf.load_matrix(p)
    assert rhs is None
    _same_matrix(kind, got, _build(kind, "j"))


@pytest.mark.parametrize("kind", KINDS)
def test_cgx_file_loads_in_port(tmp_path, kind):
    """cgx writes; the port loads its own build back, and the port's own
    round trip is the identity."""
    q = str(tmp_path / "cgx.npz")
    b = np.random.default_rng(0).standard_normal(42)
    jnf.save_matrix(q, _build(kind, "j"), b)
    assert tnf.peek_kind(q) == kind
    got, rhs = tnf.load_matrix(q, device=CPU)
    ref = _build(kind, "t")
    _same_matrix(kind, got, ref)
    np.testing.assert_array_equal(n_(rhs), b)
    p = str(tmp_path / "again.npz")
    tnf.save_matrix(p, got)
    _same_matrix(kind, tnf.load_matrix(p, device=CPU)[0], ref)


def test_loaded_wbell_solves_as_built(tmp_path):
    """A loaded WBELL operator builds its row layout lazily, and its
    products (K7's and K9's plain versions) equal the built operator's
    bit for bit."""
    from cgx_torch.kernels.wbell import wbell_spmv

    w = _build("wbell", "t")
    p = str(tmp_path / "w.npz")
    tnf.save_matrix(p, w)
    w2, _ = tnf.load_matrix(p, device=CPU)
    assert "rows" not in w2.__dict__          # not built yet
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        700).astype(np.float32))
    for backend in ("resident", "windowed"):
        y1 = wbell_spmv(w, w.to_internal(x), backend=backend)
        y2 = wbell_spmv(w2, w2.to_internal(x), backend=backend)
        assert torch.equal(y1, y2)
    assert "rows" in w2.__dict__


def _bundles(tmp_path):
    """The same IR-df64 bundle written by each package."""
    import cgx.solve.hp as jhp
    import cgx_torch.solve.hp as thp

    a = _random_spd(300, 0.03, 3)
    b = np.random.default_rng(5).standard_normal(300)
    p, q = str(tmp_path / "port_op.npz"), str(tmp_path / "cgx_op.npz")
    from cgx.sparse.wbell import wbell_from_csr as j_wbell
    from cgx_torch.sparse.wbell import wbell_from_csr as t_wbell
    tnf.save_df64_operator(p, thp.IRDF64Operator(
        a_hp=thp.df64_ell_from_csr(a, device=CPU),
        wb=t_wbell(a, device=CPU), diag=a.diagonal()), b)
    jnf.save_df64_operator(q, jhp.IRDF64Operator(
        a_hp=jhp.df64_ell_from_csr(a), wb=j_wbell(a), diag=a.diagonal()), b)
    return a, b, p, q


def test_df64_bundle_same_file_both_ways(tmp_path):
    """The df64 bundle: the two packages write the same arrays, and each
    loads the other's to its own build."""
    import cgx.solve.hp as jhp

    a, b, p, q = _bundles(tmp_path)
    _same_file(p, q)
    assert tnf.peek_kind(p) == jnf.peek_kind(q) == "ir_df64"
    op_t, rhs_t = tnf.load_df64_operator(q, device=CPU)
    op_j, rhs_j = jnf.load_df64_operator(p)
    np.testing.assert_array_equal(rhs_t, b)
    np.testing.assert_array_equal(rhs_j, b)
    ref = jhp.df64_ell_from_csr(a)
    for f in ("vhi", "vlo", "col_indices"):
        np.testing.assert_array_equal(n_(getattr(op_t.a_hp, f)),
                                      np.asarray(getattr(ref, f)))
        np.testing.assert_array_equal(np.asarray(getattr(op_j.a_hp, f)),
                                      np.asarray(getattr(ref, f)))
    _same_matrix("wbell", op_t.wb, op_j.wb)
    np.testing.assert_array_equal(op_t.diag, a.diagonal())


def test_cgx_bundle_solved_by_port(tmp_path):
    """A bundle written by cgx drives the port's prebuilt refinement (K7's
    plain version) to the TRUE tolerance, as the same bundle does in cgx,
    with the same outer and inner counts."""
    import cgx
    import cgx.solve.hp as jhp
    import cgx_torch
    import cgx_torch.solve.hp as thp
    from cgx_torch.ops.df64 import df_to_f64

    a, b, _, q = _bundles(tmp_path)
    op, rhs = tnf.load_df64_operator(q, device=CPU)
    inv = (1.0 / op.diag).astype(np.float32)
    res, info = thp.make_ir_df64_solver(
        prebuilt=op, tol=1e-6, inner_tol=1e-2, inner_maxiter=2000,
        preconditioner=cgx_torch.JacobiPrecond(
            inv_diag=torch.from_numpy(inv)))(rhs)
    x = df_to_f64(res.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) <= 1.5e-6, info
    op_j, _ = jnf.load_df64_operator(q)
    _, info_j = jhp.make_ir_df64_solver(
        prebuilt=op_j, tol=1e-6, inner_tol=1e-2, inner_maxiter=2000,
        preconditioner=cgx.JacobiPrecond(inv_diag=jnp.asarray(inv)))(rhs)
    assert info["outer"] == info_j["outer"]
    assert info["inner_iterations"] == info_j["inner_iterations"]


def test_load_df64_operator_rejects_other_kinds(tmp_path):
    p = str(tmp_path / "m.npz")
    tnf.save_matrix(p, _build("csr", "t"))
    with pytest.raises(ValueError, match="ir_df64"):
        tnf.load_df64_operator(p, device=CPU)


def test_unsupported_and_unknown(tmp_path):
    with pytest.raises(TypeError, match="unsupported"):
        tnf.save_matrix(str(tmp_path / "x.npz"), object())
    p = str(tmp_path / "odd.npz")
    np.savez(p, kind="hyb")
    assert tnf.peek_kind(p) == "hyb"
    with pytest.raises(ValueError, match="unknown format kind"):
        tnf.load_matrix(p, device=CPU)


def test_loaders_default_to_the_card(tmp_path):
    """Without a device the loaders put the arrays on the card, and raise
    without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = str(tmp_path / "m.npz")
    tnf.save_matrix(p, _build("dia", "t"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tnf.load_matrix(p)

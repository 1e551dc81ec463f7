"""The port's block-sparse path against cgx on the CPU: the CSR Poisson
builders, COO and BSR (containers, conversions, products, solves), the
block-ELL build and K11's plain version, interop of the block formats,
and the legacy 4-line format.  The same seeded numpy data goes to both
packages; cgx's block-ELL kernel runs in interpret mode, as
tests/test_kernels.py runs it."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
from cgx.io import legacy as jlegacy  # noqa: E402
from cgx.io import poisson as jpoisson  # noqa: E402
from cgx.kernels import bsr as jbsr  # noqa: E402
from cgx.ops import spmv as jops  # noqa: E402
from cgx.sparse import types as jty  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.interop import operator_from_cgx, result_to_numpy  # noqa
from cgx_torch.io import legacy as tlegacy  # noqa: E402
from cgx_torch.io import poisson as tpoisson  # noqa: E402
from cgx_torch.kernels import bsr as tbsr  # noqa: E402
from cgx_torch.ops.spmv import spmm, spmv  # noqa: E402
from cgx_torch.sparse import types as tty  # noqa: E402
from conftest import random_spd_csr  # noqa: E402
from torch_parity import n_, t  # noqa: E402

CPU = "cpu"


def _random_csr(n, m, density, seed):
    """tests/test_sparse_ops.py's random matrix, from a seed."""
    s = sp.random(n, m, density=density, random_state=seed).tocsr()
    s.sort_indices()
    return s


def _maxrel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _both_csr(s):
    """The same scipy matrix as a cgx and a cgx_torch CSR."""
    return jty.csr_from_scipy(s), tty.csr_from_scipy(s, device=CPU)


def _assert_fields_equal(jax_obj, port_obj, names):
    for name in names:
        got, want = n_(getattr(port_obj, name)), n_(getattr(jax_obj, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# -- builders ------------------------------------------------------------------

@pytest.mark.parametrize("kind,dims,dtype", [
    ("2d", (5, 7), np.float64), ("2d", (1, 6), np.float32),
    ("3d", (4, 3, 5), np.float64)])
def test_poisson_csr_builders_equal(kind, dims, dtype):
    jf = {"2d": jpoisson.poisson2d_csr_arrays,
          "3d": jpoisson.poisson3d_csr_arrays}[kind]
    tf = {"2d": tpoisson.poisson2d_csr_arrays,
          "3d": tpoisson.poisson3d_csr_arrays}[kind]
    for got, want in zip(tf(*dims, dtype=dtype), jf(*dims, dtype=dtype)):
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    jm = {"2d": jpoisson.poisson2d, "3d": jpoisson.poisson3d}[kind](
        *dims, dtype=dtype)
    tm = {"2d": tpoisson.poisson2d, "3d": tpoisson.poisson3d}[kind](
        *dims, dtype=dtype, device=CPU)
    assert tm.shape == jm.shape and tm.col_indices.dtype == torch.int64
    _assert_fields_equal(jm, tm, ("values", "col_indices", "indptr",
                                  "row_indices"))


@pytest.mark.parametrize("shape,density", [((40, 40), 0.1), ((64, 33), 0.07),
                                           ((7, 120), 0.3)])
def test_coo_from_scipy_equal(shape, density):
    s = _random_csr(*shape, density, seed=sum(shape))
    # Hand scipy a COO in column-major order: both must lexsort it.
    cs = s.tocsc().tocoo()
    j, p = jty.coo_from_scipy(cs), tty.coo_from_scipy(cs, device=CPU)
    assert p.shape == j.shape and p.nnz == j.nnz
    _assert_fields_equal(j, p, ("values", "row_indices", "col_indices"))
    jc, tc = _both_csr(s)
    _assert_fields_equal(jc.to_coo(), tc.to_coo(),
                         ("values", "row_indices", "col_indices"))


@pytest.mark.parametrize("bs", [2, 4, 8])
def test_bsr_from_csr_equal(bs):
    s = random_spd_csr(37, 0.1, np.random.default_rng(bs))
    jc, tc = _both_csr(s)
    j, p = jty.bsr_from_csr(jc, bs), tty.bsr_from_csr(tc, bs)
    assert p.shape == j.shape == (-(-37 // bs) * bs,) * 2
    assert p.blocksize == j.blocksize == bs and p.nnzb == j.nnzb
    _assert_fields_equal(j, p, ("values", "col_indices", "indptr",
                                "row_indices"))


def _padding_matrix():
    """tests/test_kernels.py:83-99: block diagonal plus one dense block row
    and column, so the block rows are very uneven."""
    n = 64
    d = sp.lil_matrix((n, n))
    for i in range(n):
        d[i, i] = 2.0
    d[0, :] = 1.0
    d[:, 0] = 1.0
    return sp.csr_matrix(d)


def _block_diag(nbr=12, bs=8, seed=3):
    """tests/test_kernels.py:66-80: one block per block row (wb = 1)."""
    rng = np.random.default_rng(seed)
    return sp.csr_matrix(sp.block_diag(
        [rng.standard_normal((bs, bs)) for _ in range(nbr)], format="csr"))


def _beyond_chunk(nbr=300, bs=8):
    """tests/test_kernels.py:43-63: more than 256 block rows."""
    n = nbr * bs
    d = sp.random(nbr, nbr, density=0.01, random_state=0) + sp.identity(nbr)
    mask = sp.kron((d != 0).astype(np.float64), np.ones((bs, bs)))
    return sp.csr_matrix(mask.multiply(sp.random(n, n, density=1.0,
                                                 random_state=1)))


def _resident_vs_dma(bs=16, nb=24):
    """tests/test_kernels.py:844-867's operator."""
    d = sp.random(nb, nb, density=0.2, random_state=5).tocsr()
    d.setdiag(1.0)
    a = sp.kron(d, np.ones((bs, bs))).tocsr() * 0.01
    return sp.csr_matrix(a + sp.eye(bs * nb))


def _poisson(nx=10, ny=12):
    vals, cols, indptr, n = jpoisson.poisson2d_csr_arrays(nx, ny)
    return sp.csr_matrix((vals, cols, indptr), shape=(n, n))


def _both_bell(s, bs, dtype=np.float32):
    """The same matrix as a cgx and a cgx_torch BlockELL."""
    jc, tc = _both_csr(sp.csr_matrix(s, dtype=dtype))
    return (jbsr.bell_from_bsr(jty.bsr_from_csr(jc, bs)),
            tbsr.bell_from_bsr(tty.bsr_from_csr(tc, bs)))


@pytest.mark.parametrize("case,bs", [("poisson", 8), ("poisson", 16),
                                     ("spd", 8), ("padding", 8),
                                     ("wb1", 8)])
def test_bell_from_bsr_equal(case, bs):
    s = {"poisson": _poisson, "padding": _padding_matrix,
         "wb1": _block_diag,
         "spd": lambda: random_spd_csr(96, 0.1, np.random.default_rng(1))
         }[case]()
    j, p = _both_bell(s, bs, np.float64)
    assert p.shape == j.shape and p.wb == j.wb and p.blocksize == bs
    assert p.block_cols.dtype == torch.int32 and p.dtype == torch.float64
    _assert_fields_equal(j, p, ("values", "block_cols"))
    if case == "wb1":
        assert p.wb == 1
    if case == "padding":
        assert p.wb > 1


# -- products ------------------------------------------------------------------

@pytest.mark.parametrize("shape,density", [((40, 40), 0.1), ((64, 33), 0.07),
                                           ((7, 120), 0.3)])
def test_coo_csr_spmv_match_jax(shape, density):
    s = _random_csr(*shape, density, seed=7 + shape[0])
    x = np.random.default_rng(shape[1]).standard_normal(shape[1])
    jc, tc = _both_csr(s)
    for j, p in ((jc, tc), (jty.coo_from_scipy(s),
                            tty.coo_from_scipy(s, device=CPU))):
        want = np.asarray(jops.spmv(j, jnp.asarray(x)))
        np.testing.assert_allclose(n_(spmv(p, t(x))), want, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("k", [1, 3, 16])
def test_coo_spmm_matches_jax(k):
    s = _random_csr(30, 45, 0.1, seed=k)
    x = np.random.default_rng(k).standard_normal((45, k))
    want = np.asarray(jops.spmm(jty.coo_from_scipy(s), jnp.asarray(x)))
    got = n_(spmm(tty.coo_from_scipy(s, device=CPU), t(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bs", [2, 4, 8])
def test_bsr_spmv_matches_jax(bs):
    s = random_spd_csr(37, 0.1, np.random.default_rng(10 + bs))
    jc, tc = _both_csr(s)
    j, p = jty.bsr_from_csr(jc, bs), tty.bsr_from_csr(tc, bs)
    xp = np.zeros(p.shape[1])
    xp[:37] = np.random.default_rng(bs).standard_normal(37)
    want = np.asarray(jops.spmv(j, jnp.asarray(xp)))
    got = n_(spmv(p, t(xp)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[:37], s @ xp[:37], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k", [1, 5])
def test_bsr_spmm_matches_jax(k):
    s = random_spd_csr(32, 0.1, np.random.default_rng(20 + k))
    jc, tc = _both_csr(s)
    j, p = jty.bsr_from_csr(jc, 8), tty.bsr_from_csr(tc, 8)
    x = np.random.default_rng(k).standard_normal((32, k))
    want = np.asarray(jops.spmm(j, jnp.asarray(x)))
    np.testing.assert_allclose(n_(spmm(p, t(x))), want, rtol=1e-12,
                               atol=1e-12)


def _jax_bell(j, x, **kw):
    return np.asarray(jbsr.bell_spmm(j, jnp.asarray(x), interpret=True, **kw))


@pytest.mark.parametrize("engine", ["dma", "resident"])
@pytest.mark.parametrize("bs,k", [(8, 8), (8, 16), (16, 8)])
def test_bell_plain_matches_jax(bs, k, engine):
    """tests/test_kernels.py:18-30 on poisson2d(10, 12) in fp32."""
    j, p = _both_bell(_poisson(), bs)
    x = np.random.default_rng(bs + k).standard_normal(
        (p.shape[1], k)).astype(np.float32)
    got = tbsr.bell_spmm(p, t(x), engine=engine)
    assert got.dtype == torch.float32 and got.shape == (p.shape[0], k)
    np.testing.assert_allclose(n_(got), _jax_bell(j, x, engine=engine),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["spd", "beyond_chunk", "wb1", "padding"])
def test_bell_plain_matches_jax_cases(case):
    """tests/test_kernels.py:33-99: the random-SPD SpMV, more than 256 block
    rows (the "dma" engine), wb = 1 and inert padding blocks; each also
    against scipy."""
    s = {"spd": lambda: random_spd_csr(96, 0.1, np.random.default_rng(2)),
         "beyond_chunk": _beyond_chunk, "wb1": _block_diag,
         "padding": _padding_matrix}[case]()
    j, p = _both_bell(s, 8)
    n = s.shape[0]
    rng = np.random.default_rng(len(case))
    if case in ("spd", "padding"):
        x = rng.standard_normal(n).astype(np.float32)
        got = n_(tbsr.bell_spmv(p, t(x)))
        want = np.asarray(jbsr.bell_spmv(j, jnp.asarray(x), interpret=True))
    else:
        x = rng.standard_normal((n, 16 if case == "beyond_chunk" else 4)
                                ).astype(np.float32)
        got = n_(tbsr.bell_spmm(p, t(x), engine="dma"))
        want = _jax_bell(j, x, engine="dma")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert _maxrel(got[:n], s @ x.astype(np.float64)) < 1e-5


def test_bell_plain_matches_both_jax_engines():
    """tests/test_kernels.py:844-867: JAX's resident and DMA engines agree
    bit for bit; the plain version agrees with both and with fp64."""
    s = _resident_vs_dma()
    j, p = _both_bell(s, 16)
    x = np.random.default_rng(5).standard_normal(
        (s.shape[0], 64)).astype(np.float32)
    got = n_(tbsr.bell_spmm(p, t(x)))
    y_d = _jax_bell(j, x, engine="dma")
    y_r = _jax_bell(j, x, engine="resident")
    np.testing.assert_array_equal(y_r, y_d)
    np.testing.assert_allclose(got, y_r, rtol=1e-5, atol=1e-5)
    assert _maxrel(got, s.astype(np.float32) @ x.astype(np.float64)) < 1e-5


def test_bell_plain_fp64_matches_jax():
    """Under x64 the JAX package returns fp64 for fp64 operands; so does
    the plain version."""
    j, p = _both_bell(_poisson(9, 11), 8, np.float64)
    x = np.random.default_rng(64).standard_normal((p.shape[1], 5))
    got = tbsr.bell_spmm(p, t(x))
    want = _jax_bell(j, x)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(n_(got), want, rtol=1e-12, atol=1e-12)


def test_bell_plain_bf16_operands_fp32_out():
    """tests/test_kernels.py:770-795: bf16 blocks and bf16 X, fp32 out.
    The operands are rounded from the same fp32 numbers on both sides."""
    n, bs, k = 128, 16, 32
    rng = np.random.default_rng(42)
    dense = sp.random(n // bs, n // bs, 0.4, random_state=7).toarray()
    blocks = np.kron((dense != 0), np.ones((bs, bs)))
    s = sp.csr_matrix(blocks * rng.standard_normal((n, n)))
    j, p = _both_bell(s, bs)
    x = rng.standard_normal((n, k)).astype(np.float32)
    y32 = n_(tbsr.bell_spmm(p, t(x)))
    y16 = tbsr.bell_spmm(p.astype(torch.bfloat16), t(x).to(torch.bfloat16))
    assert y16.dtype == torch.float32
    want = np.asarray(jbsr.bell_spmm(j.astype(jnp.bfloat16),
                                     jnp.asarray(x, jnp.bfloat16),
                                     interpret=True))
    assert want.dtype == np.float32
    assert _maxrel(n_(y16), want) <= 1e-5
    rel = np.linalg.norm(n_(y16) - y32) / np.linalg.norm(y32)
    assert rel < 3e-2


def test_bell_engine_and_shape_errors():
    j, p = _both_bell(_poisson(), 8)
    x = t(np.ones((p.shape[1], 2), np.float32))
    # "prefetch" (K12) computes K11's Y, in chunks of 256 block rows.
    y = tbsr.bell_spmm(p, x, engine="prefetch")
    assert torch.equal(y, tbsr.bell_spmm(p, x, engine="resident"))
    want = np.asarray(jbsr.bell_spmm(j, jnp.asarray(n_(x)), interpret=True,
                                     engine="prefetch"))
    assert _maxrel(n_(y), want) <= 1e-5
    with pytest.raises(ValueError, match="unknown engine"):
        tbsr.bell_spmm(p, x, engine="mxu")
    with pytest.raises(ValueError, match="x must be"):
        tbsr.bell_spmm(p, x[:-1])
    assert torch.equal(tbsr.bell_spmm(p, x, engine="resident"),
                       tbsr.bell_spmm(p, x, engine="dma"))


# -- solves --------------------------------------------------------------------

def _formats(a_csr_j, a_csr_t, fmt):
    if fmt == "bsr":
        return jty.bsr_from_csr(a_csr_j, 8), tty.bsr_from_csr(a_csr_t, 8)
    return a_csr_j.to_coo(), a_csr_t.to_coo()


@pytest.mark.parametrize("fmt", ["bsr", "coo"])
def test_cg_solve_matches_jax(fmt):
    """tests/test_cg.py:87-109's system in fp64: equal iteration counts, x
    within 1e-10; auto_solve routes it to the loop."""
    jc, tc = jpoisson.poisson2d(12, 12), tpoisson.poisson2d(12, 12,
                                                            device=CPU)
    j, p = _formats(jc, tc, fmt)
    n = p.shape[0]
    b = np.cos(np.arange(n) * 0.37)
    want = cgx.cg_solve(j, jnp.asarray(b), tol=1e-12, maxiter=1000)
    got = cgx_torch.cg_solve(p, t(b), tol=1e-12, maxiter=1000)
    assert bool(got.converged)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(n_(got.x), np.asarray(want.x), rtol=1e-10,
                               atol=1e-10)
    assert cgx_torch.select_backend(p, t(b)) == "xla"
    routed = cgx_torch.auto_solve(p, t(b), tol=1e-12, maxiter=1000)
    assert torch.equal(routed.x, got.x)


@pytest.mark.parametrize("fmt", ["bsr", "coo"])
def test_cg_solve_multi_matches_jax(fmt):
    jc, tc = jpoisson.poisson2d(9, 8), tpoisson.poisson2d(9, 8, device=CPU)
    j, p = _formats(jc, tc, fmt)
    b = np.random.default_rng(3).standard_normal((p.shape[0], 3))
    want = cgx.cg_solve_multi(j, jnp.asarray(b), tol=1e-10, backend="xla")
    got = result_to_numpy(cgx_torch.auto_solve(p, t(b), tol=1e-10))
    np.testing.assert_array_equal(got["iterations"],
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=1e-10,
                               atol=1e-12)
    assert cgx_torch.select_backend(p, t(b)) == "xla"


# -- interop ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["coo", "bsr", "bell", "bell_bf16"])
def test_interop_block_formats(kind):
    jc = jty.csr_from_scipy(_poisson(6, 8))
    j = {"coo": lambda: jc.to_coo(), "bsr": lambda: jty.bsr_from_csr(jc, 4),
         "bell": lambda: jbsr.bell_from_bsr(jty.bsr_from_csr(jc, 4)),
         "bell_bf16": lambda: jbsr.bell_from_bsr(
             jty.bsr_from_csr(jc, 4)).astype(jnp.bfloat16)}[kind]()
    p = operator_from_cgx(j, device=CPU)
    assert type(p).__name__ == type(j).__name__ and p.shape == j.shape
    if kind == "bell_bf16":
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            p.values.float().numpy(), np.asarray(j.values, np.float32))
    else:
        assert p.dtype == torch.float64
        np.testing.assert_array_equal(n_(p.values), np.asarray(j.values))
    for name in ("row_indices", "col_indices", "indptr", "block_cols"):
        if hasattr(j, name):
            np.testing.assert_array_equal(n_(getattr(p, name)),
                                          np.asarray(getattr(j, name)))
    if kind == "bell_bf16":
        assert p.block_cols.dtype == torch.int32
        x = np.random.default_rng(0).standard_normal(
            (p.shape[1], 2)).astype(np.float32)
        want = np.asarray(jbsr.bell_spmm(j, jnp.asarray(x, jnp.bfloat16),
                                         interpret=True))
        got = tbsr.bell_spmm(p, t(x).to(torch.bfloat16))
        assert _maxrel(n_(got), want) <= 1e-5
    elif kind != "bell":
        if kind == "bsr":
            assert p.blocksize == 4
        x = np.random.default_rng(0).standard_normal(p.shape[1])
        np.testing.assert_allclose(
            n_(spmv(p, t(x))), np.asarray(jops.spmv(j, jnp.asarray(x))),
            rtol=1e-12, atol=1e-12)


# -- the legacy 4-line format -------------------------------------------------

def _legacy_system(nx=7, ny=9, seed=0):
    vals, cols, indptr, n = jpoisson.poisson2d_csr_arrays(nx, ny)
    b = np.random.default_rng(seed).standard_normal(n) / 3.0
    return vals, cols, indptr, n, b


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_legacy_roundtrip_across_packages(tmp_path, writer):
    """A file written by one package and read by the other gives equal
    arrays (and equal files from both writers)."""
    vals, cols, indptr, n, b = _legacy_system()
    ja = jty.CSRMatrix.from_arrays(vals, cols, indptr, (n, n))
    ta = tty.CSRMatrix.from_arrays(vals, cols, indptr, (n, n), device=CPU)
    path_t, path_j = tmp_path / "port.txt", tmp_path / "jax.txt"
    tlegacy.write_legacy(str(path_t), ta, t(b))
    jlegacy.write_legacy(str(path_j), ja, jnp.asarray(b))
    assert path_t.read_text() == path_j.read_text()
    path = path_t if writer == "port" else path_j
    ra, rb = (jlegacy.read_legacy(str(path)) if writer == "port"
              else tlegacy.read_legacy(str(path), device=CPU))
    np.testing.assert_array_equal(n_(ra.values), vals)
    np.testing.assert_array_equal(n_(ra.col_indices), cols)
    np.testing.assert_array_equal(n_(ra.indptr), indptr)
    np.testing.assert_array_equal(n_(rb), b)
    assert ra.shape == (n, n)


def test_legacy_fixed_count_solve_matches_jax(tmp_path):
    """The C program's trajectory: ``tol=0`` and ``max_iter + 1`` updates
    (cgx/solve/cg.py:6-11), from the same file through both readers."""
    vals, cols, indptr, n, b = _legacy_system(9, 8, seed=1)
    path = str(tmp_path / "ab.txt")
    tlegacy.write_legacy(path, tty.CSRMatrix.from_arrays(
        vals, cols, indptr, (n, n), device=CPU), t(b))
    ja, jb = jlegacy.read_legacy(path)
    ta, tb = tlegacy.read_legacy(path, device=CPU)
    max_iter = 20
    want = cgx.cg_solve(ja, jb, tol=0.0, maxiter=max_iter + 1)
    got = cgx_torch.cg_solve(ta, tb, tol=0.0, maxiter=max_iter + 1)
    assert int(got.iterations) == int(want.iterations) == max_iter + 1
    np.testing.assert_allclose(n_(got.x), np.asarray(want.x), rtol=1e-12,
                               atol=1e-12)

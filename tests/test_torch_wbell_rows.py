"""The row layout that K7 and K9 read (cgx_torch.sparse.wbell.WBellRows)
against the slot planes it is built from and against cgx, on the CPU.

The layout keeps each internal row's nonzeros in walk order (plane order,
then j) and its plain version (``rows_product``) rounds every product and
sum on its own, as the plane walk does; the plane walk's extra terms are
exact ±0 products, so the two agree bit for bit on finite x, and through
the plane walk with cgx's kernels (interpret mode).  Same seeded inputs and
the thermal2 stand-in at scale 0.004 (4,912 rows), as
tests/test_torch_wbell.py."""
import dataclasses

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
from cgx.io import suitesparse as jss  # noqa: E402
from cgx.kernels import wbell as jkw  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.io import suitesparse as tss  # noqa: E402
from cgx_torch.kernels import wbell as tkw  # noqa: E402
from cgx_torch.sparse import wbell as tsw  # noqa: E402
from torch_parity import n_, t  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def thermal():
    """The stand-in in both packages, fp32 and bf16 planes, seeded x, and
    cgx's products (interpret mode): k = 1, k = 3, and k = 3 on bf16."""
    aj = jss.standin("thermal2", scale=0.004)
    at = tss.standin("thermal2", scale=0.004, device=CPU)
    wj = cgx.wbell_from_csr(aj)
    wj16 = cgx.wbell_from_csr(aj, value_dtype=jnp.bfloat16)
    wt = cgx_torch.wbell_from_csr(at, device=CPU)
    wt16 = cgx_torch.wbell_from_csr(at, device=CPU,
                                    value_dtype=torch.bfloat16)
    x = np.random.default_rng(21).standard_normal(
        (3, wt.nt, 8, 128)).astype(np.float32)
    return dict(at=at, wt=wt, wt16=wt16, x=x,
                y1=np.asarray(jkw.wbell_spmv(wj, jnp.asarray(x[0]))),
                y3=np.asarray(jkw.wbell_spmm(wj, jnp.asarray(x))),
                y3_16=np.asarray(jkw.wbell_spmm(wj16, jnp.asarray(x))))


def _entries(rows):
    """Every stored slot: (position, slot rank, x index, value, real),
    where position q of group g is ``1024·g + q`` and real marks the slots
    that hold an entry (non-zero value)."""
    sptr = rows.sptr.long()
    nst = int(sptr[-1])
    sgroup = torch.repeat_interleave(torch.arange(rows.nt), sptr[1:]
                                     - sptr[:-1])
    width = (rows.sbase[1:] - rows.sbase[:-1]) // 32
    slc = torch.repeat_interleave(torch.arange(nst * 32), width * 32)
    within = torch.arange(rows.slots) - rows.sbase[slc]
    lane, rank = within % 32, within // 32
    st = slc // 32
    pos = sgroup[st] * 1024 + (slc % 32) * 32 + lane
    c = rows.cols.long()
    if rows.cols.dtype == torch.int16:
        c = c & 0xFFFF
    col = rows.x0.long()[st] + c
    return pos, st, rank, col, rows.values, rows.values != 0


def _permuted_col(col):
    """Internal x index 1024·G + 128·j + m → permuted column 8·(128·G + m)
    + j."""
    return 8 * (128 * (col >> 10) + (col & 127)) + ((col >> 7) & 7)


@pytest.mark.parametrize("k,bf16", [(1, False), (3, False), (3, True)])
@pytest.mark.parametrize("backend", ["resident", "windowed"])
def test_rows_product_matches_planes_and_cgx(thermal, k, bf16, backend):
    """K7's and K9's plain versions over their row layouts equal the plane
    walk's and cgx's kernels bit for bit, bf16 planes upcast."""
    w = thermal["wt16" if bf16 else "wt"]
    x = t(thermal["x"][:k])
    rows = w.rows if backend == "resident" else w.windowed_rows
    got = tkw.rows_product(rows, x)
    assert torch.equal(got, tkw.wbell_resident_reference(w, x))
    assert torch.equal(got, tkw.wbell_windowed_reference(w, x))
    assert torch.equal(got, tkw.wbell_spmm(w, x, backend=backend))
    ref = (thermal["y3_16"] if bf16 else
           thermal["y1"][None] if k == 1 else thermal["y3"])
    np.testing.assert_array_equal(n_(got), ref[:k])


@pytest.mark.parametrize("backend", ["resident", "windowed"])
def test_rows_hold_the_permuted_matrix_in_walk_order(thermal, backend):
    """Each internal row holds exactly its permuted CSR row's nonzeros, in
    ascending permuted column (the walk order), with the CSR's values;
    the windowed layout splits them into stages in that order."""
    w, at = thermal["wt"], thermal["at"]
    rows = w.rows if backend == "resident" else w.windowed_rows
    pos, st, rank, col, val, real = _entries(rows)
    row = rows.rowmap.long()[pos]
    # internal row 1024·g + 128·i + l is permuted row 8·(128·g + l) + i
    prow = 8 * (128 * (row >> 10) + (row & 127)) + ((row >> 7) & 7)
    span = int(rank.max()) + 1
    order = torch.argsort((prow * (int(rows.sptr[-1]) + 1) + st) * span
                          + rank)                          # walk order
    prow, col, val = (v[order][real[order]] for v in (prow, col, val))
    assert rows.nnz == int(real.sum()) == at.nnz
    pcol = _permuted_col(col)
    s = sp.csr_matrix((n_(at.values), n_(at.col_indices), n_(at.indptr)),
                      shape=at.shape)
    perm = n_(w.perm)
    ap = s[perm][:, perm].tocsr()
    ap.sort_indices()
    coo = ap.tocoo()
    np.testing.assert_array_equal(n_(prow), coo.row)
    np.testing.assert_array_equal(n_(pcol), coo.col)
    np.testing.assert_array_equal(n_(val), coo.data.astype(np.float32))
    # within a row the permuted columns ascend
    same = prow[1:] == prow[:-1]
    assert bool((pcol[1:][same] > pcol[:-1][same]).all())


def test_row_order_and_slices(thermal):
    """σ: within each group the rows sort by count, longest first; a
    slice is as wide as its longest row; rowmap permutes each group."""
    rows = thermal["wt"].rows
    pos, st, rank, col, val, real = _entries(rows)
    nrows = rows.nt * 1024
    cnt = torch.bincount(pos[real], minlength=nrows)
    rm = rows.rowmap.long().reshape(rows.nt, 1024)
    assert torch.equal(torch.sort(rm, 1).values,
                       torch.arange(nrows).reshape(rows.nt, 1024))
    c = cnt.reshape(rows.nt, 1024)
    assert bool((c[:, 1:] <= c[:, :-1]).all())
    width = ((rows.sbase[1:] - rows.sbase[:-1]) // 32).reshape(-1, 32)
    assert torch.equal(width, c.reshape(-1, 32).max(1).values.reshape(
        width.shape))
    assert rows.slots < 1.1 * rows.nnz          # 2 % padding at 0.004


@pytest.mark.parametrize("backend", ["resident", "windowed"])
def test_padding_and_byte_count(thermal, backend):
    """Padding slots hold value 0 and a column inside x and inside their
    stage's window; every column is; the byte count is the arrays'."""
    w = thermal["wt"]
    rows = w.rows if backend == "resident" else w.windowed_rows
    pos, st, rank, col, val, real = _entries(rows)
    assert bool((val[~real] == 0).all())
    x0, xlen = rows.x0.long()[st], rows.xlen.long()[st]
    assert bool(((col >= x0) & (col < x0 + xlen)).all())
    assert int(col.max()) < rows.nt * 1024
    assert bool((rows.x0 % 32 == 0).all()) and bool((rows.xlen % 4 == 0)
                                                     .all())
    assert rows.cols.dtype == torch.int16          # 16-bit offsets fit
    assert rows.window == int(rows.xlen.max())
    want = sum(v.numel() * v.element_size() for v in (
        rows.values, rows.cols, rows.sbase, rows.rowmap, rows.sptr, rows.x0,
        rows.xlen))
    assert rows.nbytes == want
    assert rows.call_bytes(4) == want + 2 * 4 * rows.nt * 1024 * 4
    assert rows.windowed == (backend == "windowed")


def test_windowed_stages_follow_window_starts(thermal):
    """K9's layout has one stage per run of planes with one window start,
    each stage's window inside that start's span of groups."""
    w = thermal["wt"]
    rows = w.windowed_rows
    plane, og, ga = w.windowed_steps()
    nz = w.values.reshape(w.values.shape[0], -1).ne(0).any(1)[plane]
    og, ga = og[nz], ga[nz]
    runs = 1 + int(((og[1:] != og[:-1]) | (ga[1:] != ga[:-1])).sum())
    assert int(rows.sptr[-1]) == runs
    assert rows.window <= w.span * 1024
    assert int(w.rows.sptr[-1]) == w.nt                # one a group


def test_raw_arrays_build_the_cached_layout(thermal):
    """wbell_resident_raw's raw arrays give the cached layout field for
    field, and the product through it."""
    w = thermal["wt"]
    keep = w.values.reshape(w.values.shape[0], -1).ne(0).any(1)
    walk = tsw.group_walk(w.p_og, keep, w.nt)
    raw = tsw.row_layout(w.values, w.lc, walk, w.p_og, w.p_ga, w.nt)
    for f in dataclasses.fields(raw):
        a, b = getattr(raw, f.name), getattr(w.rows, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    x = t(thermal["x"][:2])
    assert torch.equal(tkw.wbell_resident_raw(w.p_og, w.p_ga, w.lc,
                                              w.values, x),
                       tkw.wbell_spmm(w, x))


def test_layout_lands_on_the_matrix_device(thermal):
    w = thermal["wt"]
    for rows in (w.rows, w.windowed_rows):
        for f in dataclasses.fields(rows):
            v = getattr(rows, f.name)
            if isinstance(v, torch.Tensor):
                assert v.device == w.device, f.name
        assert rows.values.dtype == w.values.dtype
    assert w.rows is w.rows                  # built once per matrix
    assert thermal["wt16"].rows.values.dtype == torch.bfloat16


def test_explicit_zero_entries_give_the_same_product():
    """Stored zeros add blocks to the planes but nothing to the row
    layout: the same layout entries and the same product (natural order,
    no balancing sort, so both matrices share one permutation)."""
    a = sp.random(3000, 3000, density=0.002, random_state=4, format="csr")
    a = sp.csr_matrix((a + a.T) + sp.eye(3000) * 4.0)
    z = sp.random(3000, 3000, density=0.001, random_state=5, format="coo")
    with_zeros = sp.csr_matrix(
        (np.concatenate([a.tocoo().data, np.zeros(z.nnz)]),
         (np.concatenate([a.tocoo().row, z.row]),
          np.concatenate([a.tocoo().col, z.col]))), shape=a.shape)
    with_zeros.sum_duplicates()
    assert with_zeros.nnz > a.nnz
    kw = dict(order="natural", balance_window=0, device=CPU)
    w0 = cgx_torch.wbell_from_csr(a, **kw)
    w1 = cgx_torch.wbell_from_csr(with_zeros, **kw)
    assert w1.values.shape[0] >= w0.values.shape[0]
    assert w1.rows.nnz == w0.rows.nnz == a.nnz
    v = t(np.random.default_rng(3).standard_normal(3000).astype(np.float32))
    y0, y1 = tkw.wbell_matvec(w0, v), tkw.wbell_matvec(w1, v)
    assert torch.equal(y0, y1)
    assert torch.equal(tkw.wbell_spmv(w1, w1.to_internal(v),
                                      backend="windowed"),
                       w1.to_internal(y1))


def test_wide_columns_where_a_group_spans_more_than_16_bits(thermal,
                                                           monkeypatch):
    """Where a group's columns span more than the 16-bit limit, the
    resident layout stores absolute int32 columns (x0 = 0) and its
    product stays the same; the windowed layout cuts its stages to the
    limit, keeps 16-bit offsets, and its product stays the same."""
    w = thermal["wt"]
    stages = int(w.windowed_rows.sptr[-1])
    monkeypatch.setattr(tsw, "ROW_OFFSET_LIMIT", 1024)
    rows = tsw.row_layout(w.values, w.lc, w.resident_walk, w.p_og, w.p_ga,
                          w.nt)
    assert rows.cols.dtype == torch.int32
    assert int(rows.x0.abs().sum()) == 0
    x = t(thermal["x"][:2])
    assert torch.equal(tkw.rows_product(rows, x),
                       tkw.rows_product(w.rows, x))
    cut = tsw.rows_from_steps(w.values, w.lc, *w.windowed_steps(), w.nt,
                              windowed=True)
    assert cut.cols.dtype == torch.int16 and cut.window <= 1024
    assert int(cut.sptr[-1]) > stages
    assert torch.equal(tkw.rows_product(cut, x),
                       tkw.rows_product(w.rows, x))


@pytest.fixture(scope="module")
def scattered():
    """A random symmetric matrix of 36,000 rows (36 groups) in natural
    order: each row draws x from the whole matrix, so a window start's
    run of planes draws from as wide a window as the build's span."""
    n, m = 36_000, 78_000
    rng = np.random.default_rng(8)
    r = sp.csr_matrix((rng.random(m), (rng.integers(0, n, m),
                                       rng.integers(0, n, m))), shape=(n, n))
    return sp.csr_matrix((r + r.T) + sp.eye(n) * 4.0)


@pytest.mark.parametrize("span", [32, 64])
def test_windowed_layout_cuts_spans_past_shared_memory(scattered, span):
    """At a span whose windows would not fit K9's two shared-memory
    buffers, the windowed layout cuts each run of one window start by
    column into parts of at most STAGE_WINDOW_GROUPS groups of x, and K9's
    plain version still equals both plane walks bit for bit."""
    w = cgx_torch.wbell_from_csr(scattered, span=span, order="natural",
                                 balance_window=0, device=CPU)
    rows = w.windowed_rows
    plane, og, ga = w.windowed_steps()
    nz = w.values.reshape(w.values.shape[0], -1).ne(0).any(1)[plane]
    og, ga = og[nz], ga[nz]
    runs = 1 + int(((og[1:] != og[:-1]) | (ga[1:] != ga[:-1])).sum())
    assert int(rows.sptr[-1]) > runs                   # some runs were cut
    assert rows.window == tsw.STAGE_WINDOW_GROUPS * 1024
    assert rows.nnz == scattered.nnz
    x = t(np.random.default_rng(span).standard_normal(
        (2, w.nt, 8, 128)).astype(np.float32))
    got = tkw.rows_product(rows, x)
    assert torch.equal(got, tkw.wbell_windowed_reference(w, x))
    assert torch.equal(got, tkw.wbell_resident_reference(w, x))
    assert torch.equal(got, tkw.wbell_spmm(w, x, backend="windowed"))


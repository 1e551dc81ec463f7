"""The row layouts of P1, K8 and P3 against the plane walks they replace and
against the JAX package, on the CPU.

P1 (``tier_spmm``) and K8 (``wbell_spmm_tiered``) read the row layout of
their class-major planes in their own walks; P3 (``half_spmv``) a segmented
row layout of its 4×8 half-block planes, whose flag words mark each entry
that continues its (row, plane) segment.  Each layout's plain version
(``rows_product``) keeps the walk's order and rounding, so it equals the
plane walk bit for bit on finite x.  The same seeded numpy data goes to the
JAX prototypes (``experiments/*.py``, interpret mode) and to the port; the
port's entry points take CPU tensors through their plain versions (no
launch is counted).  Sizes as tests/test_torch_protos.py: the thermal2
stand-in at scale 0.004 (4,912 rows), tests/test_wbell.py:474's n = 2000
matrix and a random matrix of five groups."""
import dataclasses
import importlib.util
import os

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
from cgx.io import suitesparse as jss  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.experiments import halfblock_proto as tp3  # noqa: E402
from cgx_torch.experiments import tier_proto as tp1  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.kernels import wbell as tkw  # noqa: E402
from cgx_torch.sparse import wbell as tsw  # noqa: E402
from torch_parity import n_, t  # noqa: E402

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _experiment(name):
    """The JAX package's prototype module ``experiments/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_rows_{name}",
        os.path.join(ROOT, "experiments", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref():
    return {name: _experiment(name) for name in
            ("tier_proto", "halfblock_proto")}


def _launches():
    return (tkw.wbell_resident_launches, tkw.wbell_tiered_launches,
            tp1.tier_spmm_launches, tp3.half_spmv_launches)


@pytest.fixture(autouse=True)
def _no_launch_on_the_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = _launches()
    yield
    assert _launches() == before


def _matrix(case):
    """scipy CSR of each case: the thermal2 stand-in at scale 0.004,
    tests/test_wbell.py:474's (A + Aᵀ) + 10 I at n = 2000, and a random
    SPD matrix of five groups (n = 5000)."""
    if case == "thermal":
        aj = jss.standin("thermal2", scale=0.004)
        return sp.csr_matrix((np.asarray(aj.values, np.float64),
                              np.asarray(aj.col_indices),
                              np.asarray(aj.indptr)), shape=aj.shape)
    n, density, shift = {"random": (2000, 0.004, 10.0),
                         "five_groups": (5000, 0.002, 12.0)}[case]
    r = sp.random(n, n, density=density, random_state=7 if n == 2000 else n,
                  format="csr")
    return sp.csr_matrix((r + r.T) + sp.eye(n) * shift)


@pytest.fixture(scope="module")
def ops():
    """Per case: scipy, cgx's WBELL and the port's copy of it (interop)."""
    out = {}
    for case in ("thermal", "random", "five_groups"):
        s = _matrix(case)
        wj = cgx.wbell_from_csr(s)
        out[case] = dict(s=s, wj=wj, wt=operator_from_cgx(wj, device=CPU))
    return out


def _x(nt, k, seed):
    return np.random.default_rng(seed).standard_normal(
        (k, nt, 8, 128)).astype(np.float32)


def _maxrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _half(s, nt):
    """P3's planes of ``s`` (span 16), packed, their walk and layout."""
    v, lc, og, ga, _, _ = tp3.build_halfblock(s, 16, device=CPU)
    packed = (og << 16) | ga
    walk = tp3.half_walk(packed, lc, v, nt, 16)
    return v, lc, packed, walk, tp3.half_rows(packed, lc, v, nt, walk)


def _flags(rows):
    """(segment flag, real) of every stored slot of a segmented layout:
    slot ``sbase + 32·t + e`` has bit e of word ``sbase / 32 + t``."""
    slot = torch.arange(rows.slots)
    word = rows.flags.long()[slot // 32] & 0xFFFFFFFF
    return ((word >> (slot % 32)) & 1) == 1, rows.values != 0


# -- (a) P1 ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("case", ["thermal", "random"])
def test_p1_rows_equal_the_stored_walk(ref, ops, case, k):
    """P1's row layout keeps the class-major walk's order: its product
    equals tier_spmm_reference bit for bit, and lies within 1e-5 of the
    peak of the reference's kernel (interpret mode) and of K7."""
    wj, wt = ops[case]["wj"], ops[case]["wt"]
    v, l, pg, steps = tp1.build_tiers(wt, 8)
    jv, jl, jpg, jsteps = ref["tier_proto"].build_tiers(wj, 8)
    x = _x(wt.nt, k, 30 + k)
    rows = tp1.tier_rows(pg, l, v, wt.nt)
    assert not rows.segmented and rows.nnz == ops[case]["s"].nnz
    got = tp1.tier_spmm(pg, l, v, t(x), steps=steps, splane=8, rows=rows)
    assert torch.equal(got, tkw.rows_product(rows, t(x)))
    assert torch.equal(got, tp1.tier_spmm_reference(pg, l, v, t(x),
                                                    steps=steps, splane=8))
    want = np.asarray(ref["tier_proto"].tier_spmm(
        jpg, jl, jv, jnp.asarray(x), steps=jsteps, splane=8, interpret=True))
    assert _maxrel(n_(got), want) <= 1e-5
    assert _maxrel(n_(got), n_(tkw.wbell_spmm(wt, t(x)))) <= 1e-5


# -- (b) K8 ----------------------------------------------------------------------

@pytest.mark.parametrize("case,bf16", [("thermal", False), ("thermal", True),
                                       ("random", False),
                                       ("five_groups", False)])
def test_k8_rows_are_k7s(ops, case, bf16):
    """The tier plan's walk is K7's plane order with the columns unmoved,
    so the row layout of its planes in that walk has the matrix's arrays:
    the plan holds the matrix's layout, and K8 equals K7's plain version
    and its own plane walk bit for bit."""
    s = ops[case]["s"]
    wt = (cgx_torch.wbell_from_csr(s, device=CPU, value_dtype=torch.bfloat16)
          if bf16 else ops[case]["wt"])
    plan = tkw.build_tier_plan(wt)
    assert plan.rows is wt.rows
    own = tkw.tiered_rows(plan.packed, plan.lc, plan.values, plan.walk,
                          plan.nt)
    for f in dataclasses.fields(tsw.WBellRows):
        got, want = getattr(own, f.name), getattr(wt.rows, f.name)
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype, f.name
            assert torch.equal(got, want), f.name
        else:
            assert got == want, f.name
    x = t(_x(wt.nt, 3, 40))
    y = tkw.wbell_spmm_tiered(plan, x)
    assert torch.equal(y, tkw.rows_product(wt.rows, x))
    assert torch.equal(y, tkw.wbell_tiered_reference(plan, x))


# -- (c) P3 ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["thermal", "random", "five_groups"])
def test_p3_segmented_rows_equal_the_plane_walk(ref, ops, case):
    """P3's segmented product equals half_reference (the plane walk) bit
    for bit, and lies within 1e-5 of the peak of the reference's kernel
    (interpret mode) and of the fp64 CSR product."""
    s, wj, wt = ops[case]["s"], ops[case]["wj"], ops[case]["wt"]
    v, lc, packed, walk, rows = _half(s, wt.nt)
    assert rows.segmented and rows.nnz == s.nnz
    xv = np.random.default_rng(50).standard_normal(s.shape[0]).astype(
        np.float32)
    xi = np.asarray(wj.to_internal(jnp.asarray(xv)))[None]
    got = tp3.half_spmv(packed, lc, v, t(xi), span=16, splane=64, rows=rows)
    assert torch.equal(got, tp3.half_reference(packed, lc, v, t(xi), span=16,
                                               splane=64, walk=walk))
    jv, jl, jog, jga, _, _ = ref["halfblock_proto"].build_halfblock(s)
    want = np.asarray(ref["halfblock_proto"].half_spmv(
        (jog << 16) | jga, jl, jv, jnp.asarray(xi), span=16, splane=8,
        interpret=True))
    assert _maxrel(n_(got), want) <= 1e-5
    truth = s @ xv.astype(np.float64)
    y = n_(wt.from_internal(got[0])).astype(np.float64)
    assert np.abs(y - truth).max() <= 1e-5 * np.abs(truth).max()


# -- (d) dense blocks, where the segments matter -----------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_p3_segments_matter_on_dense_blocks(k):
    """Dense 8×8 blocks give 8-entry segments: the segmented product
    equals the plane walk bit for bit, and the same entries summed
    straight into the row's sum (the flags dropped) do not."""
    rng = np.random.default_rng(60)
    nb = 300
    pattern = sp.random(nb, nb, density=0.01, random_state=61, format="csr")
    pattern = ((pattern + pattern.T) + sp.eye(nb)).tocsr()
    a = sp.kron(pattern, np.ones((8, 8)), format="csr")
    a.data = rng.standard_normal(a.nnz)
    wt = cgx_torch.wbell_from_csr(a, device=CPU)
    v, lc, packed, walk, rows = _half(a, wt.nt)
    assert rows.cols.dtype == torch.int16
    x = t(_x(wt.nt, k, 62 + k))
    got = tkw.rows_product(rows, x)
    assert torch.equal(got, tp3.half_reference(packed, lc, v, x, span=16,
                                               splane=64, walk=walk))
    straight = dataclasses.replace(rows, flags=None)
    y = tkw.rows_product(straight, x)
    assert not torch.equal(y, got)
    assert _maxrel(n_(y), n_(got)) <= 1e-5


# -- (e) the flags beside both column encodings -------------------------------

@pytest.mark.parametrize("encoding", ["16-bit", "int32", "bf16 values"])
def test_p3_flags_beside_both_column_encodings(ops, monkeypatch, encoding):
    """The flag words (one a slice and slot, bit e for lane e) mark exactly
    the entries that continue a (row, plane) segment, beside 16-bit column
    offsets, int32 indices (forced by a small offset range) and bf16
    values alike; the product is the plane walk's in each."""
    s, wt = ops["thermal"]["s"], ops["thermal"]["wt"]
    if encoding == "int32":
        monkeypatch.setattr(tsw, "ROW_OFFSET_LIMIT", 1024)
    v, lc, packed, walk, rows = _half(s, wt.nt)
    if encoding == "bf16 values":
        v = v.to(torch.bfloat16)
        rows = tp3.half_rows(packed, lc, v, wt.nt, walk)
        assert rows.values.dtype == torch.bfloat16
    assert rows.cols.dtype == (torch.int32 if encoding == "int32"
                               else torch.int16)
    assert rows.flags.dtype == torch.int32
    assert rows.flags.numel() * 32 == rows.slots
    flag, real = _flags(rows)
    # One segment per (plane, row i, lane) whose half-block row holds a
    # nonzero: the unflagged real entries.
    segments = int(v[walk[0].long()].ne(0).any(2).sum())
    assert int((real & ~flag).sum()) == segments
    assert int((real & flag).sum()) == rows.nnz - segments
    assert not bool((flag & ~real).any())          # padding is unflagged
    x = t(_x(wt.nt, 2, 70))
    assert torch.equal(tkw.rows_product(rows, x),
                       tp3.half_reference(packed, lc, v, x, span=16,
                                          splane=64, walk=walk))


# -- (f) bytes ----------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_layout_bytes_are_k7s(ops, k):
    """P1's, K8's and P3's layouts hold the same nonzeros in the same rows
    as K7's: each one's bytes a call within 10 % of K7's."""
    s, wt = ops["thermal"]["s"], ops["thermal"]["wt"]
    v, l, pg, _ = tp1.build_tiers(wt, 8)
    k7 = wt.rows.call_bytes(k)
    plan = tkw.build_tier_plan(wt)
    for rows in (tp1.tier_rows(pg, l, v, wt.nt),
                 tkw.tiered_rows(plan.packed, plan.lc, plan.values,
                                 plan.walk, plan.nt), _half(s, wt.nt)[4]):
        assert rows.nnz == wt.rows.nnz
        assert abs(rows.call_bytes(k) - k7) <= 0.1 * k7

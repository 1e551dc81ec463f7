"""The port's last five TPU kernels against the JAX package on the CPU: the
column-stacked WBELL SpMM K10, the chunked block-ELL engine K12, and the
prototypes P1–P3 of ``experiments/`` (the tiered single call, the paired
slots, the 4×8 half-blocks).  The same seeded numpy data goes to both
packages; the JAX package's Pallas kernels run in interpret mode, as its
own tests run them, and the port's entry points take CPU tensors through
their plain versions (no launch is counted).  ``experiments/`` has no
``__init__.py``: its modules are loaded from their files."""
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
from cgx.kernels import bsr as jbsr  # noqa: E402
from cgx.kernels import wbell as jkw  # noqa: E402
from cgx.sparse import types as jty  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.experiments import bell_pair_proto as tp2  # noqa: E402
from cgx_torch.experiments import halfblock_proto as tp3  # noqa: E402
from cgx_torch.experiments import tier_proto as tp1  # noqa: E402
from cgx_torch.interop import operator_from_cgx  # noqa: E402
from cgx_torch.kernels import bsr as tbsr  # noqa: E402
from cgx_torch.kernels import wbell as tkw  # noqa: E402
from cgx_torch.sparse import types as tty  # noqa: E402
from torch_parity import n_, t  # noqa: E402

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _experiment(name):
    """The JAX package's prototype module ``experiments/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref():
    return {name: _experiment(name) for name in
            ("tier_proto", "bell_pair_proto", "halfblock_proto")}


def _maxrel(got, ref_):
    got, ref_ = np.asarray(got, np.float64), np.asarray(ref_, np.float64)
    return float(np.abs(got - ref_).max() / np.abs(ref_).max())


def _launches():
    return (tkw.wbell_stacked_launches, tkw.wbell_tiered_launches,
            tbsr.bell_spmm_launches, tbsr.bell_prefetch_launches,
            tp1.tier_spmm_launches, tp2.bell_pair_launches,
            tp3.half_spmv_launches)


@pytest.fixture(autouse=True)
def _no_launch_on_the_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = _launches()
    yield
    assert _launches() == before


def _random_2000():
    """tests/test_wbell.py:474's matrix: (A + Aᵀ) + 10 I, n = 2000."""
    a = sp.random(2000, 2000, density=0.004, random_state=7, format="csr")
    return sp.csr_matrix((a + a.T) + sp.eye(2000) * 10.0)


@pytest.fixture(scope="module")
def thermal():
    """The thermal2 stand-in at scale 0.004 (4,912 rows): scipy, cgx's
    WBELL and the port's copy of it (interop)."""
    aj = jss.standin("thermal2", scale=0.004)
    s = sp.csr_matrix((np.asarray(aj.values, np.float64),
                       np.asarray(aj.col_indices), np.asarray(aj.indptr)),
                      shape=aj.shape)
    wj = cgx.wbell_from_csr(aj)
    return dict(s=s, wj=wj, wt=operator_from_cgx(wj, device=CPU))


# -- K10: the column-stacked WBELL SpMM ----------------------------------------

def test_k10_plain_equals_cgx_stacked():
    """K10's plain version against cgx's wbell_spmm_stacked (interpret) on
    tests/test_wbell.py:474's case, k = 3: equal, as cgx's K10 equals its
    K7 and the port's plain K7 equals cgx's; and equal to the port's K7."""
    a = _random_2000()
    wj = cgx.wbell_from_csr(a)
    wt = cgx_torch.wbell_from_csr(a, device=CPU)
    x = np.random.default_rng(42).standard_normal((2000, 3)).astype(
        np.float32)
    xb = np.stack([np.asarray(wj.to_internal(x[:, j])) for j in range(3)])
    want = np.asarray(jkw.wbell_spmm_stacked(wj, jkw.to_stacked(
        jnp.asarray(xb))))
    got = tkw.wbell_spmm_stacked(wt, tkw.to_stacked(t(xb)))
    np.testing.assert_array_equal(n_(got), want)
    assert torch.equal(tkw.from_stacked(got), tkw.wbell_spmm(wt, t(xb)))


@pytest.mark.parametrize("k", [1, 4])
def test_k10_layout_helpers_match_cgx(k):
    xb = np.random.default_rng(k).standard_normal((k, 5, 8, 128)).astype(
        np.float32)
    xs = tkw.to_stacked(t(xb))
    np.testing.assert_array_equal(n_(xs), np.asarray(jkw.to_stacked(
        jnp.asarray(xb))))
    assert tuple(xs.shape) == (5, k * 8, 128)
    # Exact inverses, both ways.
    assert torch.equal(tkw.from_stacked(xs), t(xb))
    assert torch.equal(tkw.to_stacked(tkw.from_stacked(xs)), xs)


def test_k10_refuses_bad_layout_and_wide_nt(thermal):
    wt = thermal["wt"]
    x = torch.zeros((wt.nt, 8, 128))
    with pytest.raises(ValueError, match="stacked layout"):
        tkw.wbell_spmm_stacked(wt, x[:, :7])
    with pytest.raises(ValueError, match="stacked layout"):
        tkw.wbell_spmm_stacked(wt, x[None])
    with pytest.raises(ValueError, match="65536"):
        tkw.wbell_spmm_stacked(dataclasses.replace(wt, nt=1 << 16), x)


# -- K12: bell_spmm(engine="prefetch") ----------------------------------------

def _chunked_bell(nbr, seed, dtype=np.float32):
    """A block-ELL of ``nbr`` block rows of bs 8, wb 2 (a diagonal and an
    off-diagonal block; the last rows hold one), in both packages."""
    rng = np.random.default_rng(seed)
    pattern = sp.eye(nbr) + sp.eye(nbr, k=3)
    s = sp.csr_matrix(sp.kron(pattern, np.ones((8, 8))).multiply(
        rng.standard_normal((nbr * 8, nbr * 8))), dtype=dtype)
    j = jbsr.bell_from_bsr(jty.bsr_from_csr(jty.csr_from_scipy(s), 8))
    p = tbsr.bell_from_bsr(tty.bsr_from_csr(tty.csr_from_scipy(s, device=CPU),
                                            8))
    x = rng.standard_normal((nbr * 8, 5)).astype(np.float32)
    return j, p, x


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k12_plain_matches_cgx_prefetch(dtype):
    """260 block rows: two chunks of the JAX package's 256 (256 and 4).
    The port's "prefetch" equals its "resident" bit for bit and cgx's
    prefetch engine within fp32 summation order (1e-5 of the peak)."""
    j, p, x = _chunked_bell(260, 3)
    xj, xt = jnp.asarray(x), t(x)
    if dtype == "bf16":
        j, p = j.astype(jnp.bfloat16), p.astype(torch.bfloat16)
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    assert p.wb == 2 and p.values.shape[0] > tbsr.PREFETCH_ROWS
    got = tbsr.bell_spmm(p, xt, engine="prefetch")
    assert got.dtype == torch.float32
    assert torch.equal(got, tbsr.bell_spmm(p, xt, engine="resident"))
    want = np.asarray(jbsr.bell_spmm(j, xj, interpret=True,
                                     engine="prefetch"))
    assert _maxrel(n_(got), want) <= 1e-5


@pytest.mark.parametrize("chunk", [7, 64])
def test_k12_chunks_fill_their_rows(monkeypatch, chunk):
    """Ragged chunks (the last one short) write each its own rows of one
    Y: equal to the unchunked product bit for bit."""
    _, p, x = _chunked_bell(50, 4)
    monkeypatch.setattr(tbsr, "PREFETCH_ROWS", chunk)
    assert torch.equal(tbsr.bell_spmm(p, t(x), engine="prefetch"),
                       tbsr.bell_spmm_reference(p, t(x)))
    assert torch.equal(tbsr.bell_prefetch_reference(p, t(x)[:, :1])[:, 0],
                       tbsr.bell_spmv(p, t(x)[:, 0]))


# -- P2: the paired-slot block-ELL SpMM ----------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_p2_plain_matches_cgx(ref, dtype):
    """The reference's interpret size (64, 4, 16, 64): the port's paired
    product against experiments/bell_pair_proto.py in interpret mode and
    against K11's plain version, within fp32 summation order."""
    rng = np.random.default_rng(0)
    nbr, wb, bs, k = 64, 4, 16, 64
    vals = rng.standard_normal((nbr, wb, bs, bs)).astype(np.float32)
    cols = rng.integers(0, nbr, (nbr, wb)).astype(np.int32)
    xb = rng.standard_normal((nbr, bs, k)).astype(np.float32)
    jv, jx, tv, tx = (jnp.asarray(vals), jnp.asarray(xb), t(vals), t(xb))
    if dtype == "bf16":
        jv, jx = jv.astype(jnp.bfloat16), jx.astype(jnp.bfloat16)
        tv, tx = tv.to(torch.bfloat16), tx.to(torch.bfloat16)
    want = np.asarray(ref["bell_pair_proto"].bell_spmm_paired(
        jnp.asarray(cols), jv, jx, k=k, interpret=True))
    got = tp2.bell_spmm_paired(t(cols), tv, tx, k=k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (nbr, bs, k)
    assert _maxrel(n_(got), want) <= 1e-5
    a = tbsr.BlockELL(values=tv, block_cols=t(cols),
                      shape=(nbr * bs, nbr * bs))
    k11 = tbsr.bell_spmm_reference(a, tx.reshape(-1, k))
    assert _maxrel(n_(got).reshape(-1, k), n_(k11)) <= 1e-5


def test_p2_refuses_odd_wb_and_bad_shapes():
    vals = torch.zeros((4, 3, 8, 8))
    cols = torch.zeros((4, 3), dtype=torch.int32)
    xb = torch.zeros((4, 8, 2))
    with pytest.raises(ValueError, match="even"):
        tp2.bell_spmm_paired(cols, vals, xb, k=2)
    with pytest.raises(ValueError, match="xb must be"):
        tp2.bell_spmm_paired(cols[:, :2], vals[:, :2], xb, k=3)
    with pytest.raises(ValueError, match="block_cols"):
        tp2.bell_spmm_paired(cols[:3, :2], vals[:, :2], xb, k=2)


# -- P1: the tiered single call ------------------------------------------------

@pytest.mark.parametrize("case", ["thermal", "random"])
def test_p1_build_tiers_equal(ref, thermal, case):
    """The port's build_tiers on the port's copy of cgx's WBELL (interop)
    against the reference's on cgx's: the same arrays and steps."""
    if case == "thermal":
        wj, wt = thermal["wj"], thermal["wt"]
    else:
        wj = cgx.wbell_from_csr(_random_2000())
        wt = operator_from_cgx(wj, device=CPU)
    v, l, pg, steps = ref["tier_proto"].build_tiers(wj, 8)
    tv, tl, tpg, tsteps = tp1.build_tiers(wt, 8)
    assert tsteps == steps
    for got, want in ((tv, v), (tl, l), (tpg, pg)):
        assert n_(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(n_(got), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3])
def test_p1_tier_spmm_matches_cgx(ref, thermal, k):
    """tier_spmm's plain version walks each group's planes in stored
    (class-major) order, as the reference's grid: equal to it in interpret
    mode, and to K7 within fp32 summation order (1e-5 of the peak)."""
    wj, wt = thermal["wj"], thermal["wt"]
    v, l, pg, steps = ref["tier_proto"].build_tiers(wj, 8)
    tv, tl, tpg, tsteps = tp1.build_tiers(wt, 8)
    x = np.random.default_rng(11).standard_normal(
        (k, wt.nt, 8, 128)).astype(np.float32)
    want = np.asarray(ref["tier_proto"].tier_spmm(
        pg, l, v, jnp.asarray(x), steps=steps, splane=8, interpret=True))
    got = tp1.tier_spmm(tpg, tl, tv, t(x), steps=tsteps, splane=8)
    np.testing.assert_array_equal(n_(got), want)
    assert torch.equal(got, tp1.tier_spmm_reference(
        tpg, tl, tv, t(x), steps=tsteps, splane=8))
    assert _maxrel(n_(got), n_(tkw.wbell_spmm(wt, t(x)))) <= 1e-5


def test_p1_refuses_mismatched_steps(thermal):
    wt = thermal["wt"]
    tv, tl, tpg, steps = tp1.build_tiers(wt, 8)
    x = torch.zeros((1, wt.nt, 8, 128))
    with pytest.raises(ValueError, match="planes for steps"):
        tp1.tier_spmm(tpg, tl, tv, x, steps=(steps[0] + 1,) + steps[1:],
                      splane=8)
    with pytest.raises(ValueError, match="expected"):
        tp1.tier_spmm(tpg, tl, tv, x[0], steps=steps, splane=8)


# -- P3: the 4×8 half-blocks ---------------------------------------------------

@pytest.mark.parametrize("case,span", [("thermal", 16), ("random", 16),
                                       ("random", 1)])
def test_p3_build_halfblock_equal(ref, thermal, case, span):
    s = thermal["s"] if case == "thermal" else _random_2000()
    want = ref["halfblock_proto"].build_halfblock(s, span=span)
    got = tp3.build_halfblock(s, span, device=CPU)
    for g, w in zip(got[:4], want[:4]):
        assert n_(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(n_(g), np.asarray(w))
    assert got[4] == want[4] and got[5] == want[5]
    assert n_(got[1]).max() >> 14 <= 1          # the half bit is bit 14


def test_p3_half_spmv_matches_cgx(ref, thermal):
    """half_spmv's plain version against the reference's kernel in
    interpret mode (equal), and against scipy's fp64 product through the
    8×8 build's permutation (the reference's bar, 1e-5 of the peak)."""
    s, wj, wt = thermal["s"], thermal["wj"], thermal["wt"]
    jv, jl, jog, jga, _, _ = ref["halfblock_proto"].build_halfblock(s)
    tv, tl, tog, tga, _, _ = tp3.build_halfblock(s, 16, device=CPU)
    v = np.random.default_rng(0).standard_normal(s.shape[0]).astype(
        np.float32)
    xi = np.asarray(wj.to_internal(jnp.asarray(v)))[None]
    want = np.asarray(ref["halfblock_proto"].half_spmv(
        (jog << 16) | jga, jl, jv, jnp.asarray(xi), span=16, splane=8,
        interpret=True))
    got = tp3.half_spmv((tog << 16) | tga, tl, tv, t(xi), span=16, splane=8)
    np.testing.assert_array_equal(n_(got), want)
    y = n_(wt.from_internal(got[0])).astype(np.float64)
    truth = s @ v.astype(np.float64)
    assert np.abs(y - truth).max() <= 1e-5 * np.abs(truth).max()


def test_p3_refuses_a_span_other_than_the_build(thermal):
    tv, tl, tog, tga, _, _ = tp3.build_halfblock(thermal["s"], 16,
                                                 device=CPU)
    x = torch.zeros((1, thermal["wt"].nt, 8, 128))
    packed = (tog << 16) | tga
    with pytest.raises(ValueError, match="span"):
        tp3.half_spmv(packed, tl, tv, x, span=1, splane=8)
    with pytest.raises(ValueError, match="multiple"):
        tp3.half_spmv(packed, tl, tv[:-1], x, span=16, splane=8)


@pytest.mark.parametrize("name", ["tier_proto", "bell_pair_proto",
                                  "halfblock_proto"])
def test_proto_main_needs_a_card(name):
    """A prototype's main() has no CPU mode: without a card it exits
    non-zero before it builds anything (with one, the card tests run it)."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", f"cgx_torch.experiments.{name}", "thermal2",
         "0.001"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "needs a CUDA card" in proc.stderr

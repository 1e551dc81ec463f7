"""The host side of K1's and K10's redesigns, on the CPU.

K1 marches along x: each thread owns one (j, k) column of four z-values (a
float4) or one (the scalar form) and walks a chunk of i.  This file mirrors
the kernel in Python with its block and chunk read from
``cgx_torch/csrc/stencil.cu`` itself: its plan (``march_plan``) must cover
every row once, and its arithmetic, thread by thread in torch
(``march_reference``: lane shuffles, a warp's end loads, the registers
along i), must equal the first design's tap order bit for bit and agree
with cgx's Pallas kernel in interpret mode.  The card's tests hold the
kernel itself against its first design.

K10 runs K7's row kernel over K7's row layout with x and y in the stacked
layout: its row map (``Stacked::at``, mirrored by ``stacked_index``) is
held against ``to_stacked``, and the row layout's product, restacked, is
held against cgx's ``wbell_spmm_stacked`` in interpret mode bit for bit,
over 16-bit and int32 columns.
"""
import pathlib
import re

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import cgx  # noqa: E402
from cgx.kernels import wbell as jkw  # noqa: E402
from cgx.kernels.stencil import stencil3d_spmv_pallas  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.kernels import stencil as k1  # noqa: E402
from cgx_torch.kernels import wbell as tkw  # noqa: E402
from cgx_torch.sparse import wbell as tsw  # noqa: E402
from torch_parity import n_, seeded, t  # noqa: E402

COEFFS = (6.5, -1.25, -0.75, -1.5)     # centre, x, y, z: all distinct
SHAPES = [(5, 7, 6), (37, 41, 53), (16, 24, 32), (128, 128, 128)]
FORMS = [(dims, w) for dims in SHAPES for w in (1, 4)
         if dims[2] % w == 0]


# The march's CUDA source: the mirror below runs with the kernel's own
# block and chunk, read from it.
STENCIL_CU = (pathlib.Path(k1.__file__).resolve().parents[1] / "csrc"
              / "stencil.cu").read_text()


def _cu_constant(name):
    """A ``constexpr int`` of the march's CUDA source."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         STENCIL_CU).group(1))


MARCH_THREADS = _cu_constant("kMarchThreads")
MARCH_CHUNK = _cu_constant("kChunk")


def march_width(nz, x_ptr=0, y_ptr=0):
    """The z-values a thread owns, as ``cgx_stencil3d_march`` chooses: 4 (a
    float4) where ``nz % 4 == 0`` and x and y are 16-byte aligned, else 1
    (the scalar form)."""
    return 4 if nz % 4 == 0 and x_ptr % 16 == 0 and y_ptr % 16 == 0 else 1


def march_grid(nx, ny, nz, w):
    """The march's grid ``(columns' blocks, chunks of i)``: one thread a
    (j, k) column of ``w`` z-values, MARCH_THREADS a block, MARCH_CHUNK
    rows of i a thread."""
    ncols = ny * (nz // w)
    return -(-ncols // MARCH_THREADS), -(-nx // MARCH_CHUNK)


def march_plan(nx, ny, nz, w):
    """Every thread of the march as the kernel derives it from its index:
    per column thread ``col`` (blockIdx.x·MARCH_THREADS + threadIdx.x) its
    ``lane``, whether it is ``active`` (threads past the last column
    shadow it and store nothing), its ``j`` and first z-value ``k0``; per
    chunk (blockIdx.y) its first row ``i0`` and its ``rows``."""
    gx, gy = march_grid(nx, ny, nz, w)
    nq = nz // w
    ncols = ny * nq
    col = np.arange(gx * MARCH_THREADS)
    j, q = np.divmod(np.minimum(col, ncols - 1), nq)
    i0 = np.arange(gy) * MARCH_CHUNK
    return {"lane": col & 31, "active": col < ncols, "j": j, "k0": q * w,
            "i0": i0, "rows": np.minimum(MARCH_CHUNK, nx - i0)}


def march_reference(x, nx, ny, nz, coeffs, w):
    """The march's arithmetic in torch, thread by thread as the kernel runs
    it (``march_plan``, ``w`` its form): each row's x at i−1, i, i+1 from
    its column, its z neighbours from its own vector or the lane
    neighbour's (a warp's ends from x), its y neighbours from x, each tap
    in ``stencil_row``'s order rounded on its own from 0."""
    plan = march_plan(nx, ny, nz, w)
    cc, cx, cy, cz = (torch.tensor(c, dtype=torch.float32)
                      for c in coeffs)
    cf = (cc, cz, cz, cy, cy, cx, cx)
    lane = torch.from_numpy(plan["lane"])
    active = torch.from_numpy(plan["active"])
    j = torch.from_numpy(plan["j"])[:, None]
    k = torch.from_numpy(plan["k0"])[:, None] + torch.arange(w)
    p = j * nz + k                                    # (columns, w)
    plane = ny * nz
    y = torch.empty_like(x)
    first, last = lane == 0, lane == 31
    z_lo, z_hi = k[:, 0] > 0, k[:, -1] + 1 < nz

    def column(i):
        return x[i * plane + p] if 0 <= i < nx else torch.zeros_like(
            p, dtype=x.dtype)

    for i0, rows in zip(plan["i0"].tolist(), plan["rows"].tolist()):
        prev, cur = column(i0 - 1), column(i0)
        for i in range(i0, i0 + rows):
            nxt = column(i + 1)
            r = i * plane + p
            # __shfl_up_sync / __shfl_down_sync by one lane; a lane without
            # a partner keeps its own value, the warp's ends load theirs.
            zl = torch.cat([cur[:1, -1], cur[:-1, -1]])
            zl = torch.where(first, cur[:, -1], zl)
            zl = torch.where(first & z_lo, x[(r[:, 0] - 1).clamp(min=0)], zl)
            zr = torch.cat([cur[1:, 0], cur[-1:, 0]])
            zr = torch.where(last, cur[:, 0], zr)
            zr = torch.where(last & z_hi,
                             x[(r[:, -1] + 1).clamp(max=x.numel() - 1)], zr)
            up = torch.cat([cur[:, 1:], zr[:, None]], 1)
            down = torch.cat([zl[:, None], cur[:, :-1]], 1)
            yp = x[(r + nz).clamp(max=x.numel() - 1)]
            ym = x[(r - nz).clamp(min=0)]
            acc = torch.zeros_like(cur) + cf[0] * cur
            for c, inside, v in (
                    (cf[1], k + 1 < nz, up), (cf[2], k > 0, down),
                    (cf[3], j + 1 < ny, yp), (cf[4], j > 0, ym),
                    (cf[5], i + 1 < nx, nxt), (cf[6], i > 0, prev)):
                acc = torch.where(torch.as_tensor(inside), acc + c * v, acc)
            y[r[active]] = acc[active]
            prev, cur = cur, nxt
    return y


def stacked_index(r, nrhs):
    """Where column c of internal row ``r`` lies in the stacked layout
    ``(nt, nrhs·8, 128)``, flat: ``((r >> 10)·nrhs + c)·1024 + (r & 1023)``
    for c = 0 .. nrhs−1, shape ``(nrhs, *r.shape)`` (K10's row map,
    ``Stacked::at`` in ``csrc/wbell.cu``)."""
    c = torch.arange(nrhs).reshape((nrhs,) + (1,) * r.dim())
    return ((r >> 10) * nrhs + c) * 1024 + (r & 1023)


def _tap_order(x, nx, ny, nz, coeffs):
    """The first design's row (``cgx::stencil_row``): from 0, the taps in
    ``_TAPS7``'s order, each product and sum rounded on its own, taps
    outside the grid skipped."""
    cc, cx, cy, cz = (torch.tensor(c, dtype=torch.float32) for c in coeffs)
    g = x.reshape(nx, ny, nz)
    idx = torch.meshgrid(torch.arange(nx), torch.arange(ny),
                         torch.arange(nz), indexing="ij")
    acc = torch.zeros_like(g)
    for tap, c in zip(k1._TAPS7, (cc, cz, cz, cy, cy, cx, cx)):
        at = [i + d for i, d in zip(idx, tap)]
        inside = torch.ones_like(g, dtype=torch.bool)
        for a, n in zip(at, (nx, ny, nz)):
            inside &= (a >= 0) & (a < n)
        v = g[tuple(a.clamp(0, n - 1) for a, n in zip(at, (nx, ny, nz)))]
        acc = torch.where(inside, acc + c * v, acc)
    return acc.reshape(-1)


# -- K1: the march ------------------------------------------------------------

@pytest.mark.parametrize("dims,w", FORMS)
def test_march_plan_covers_every_row_once(dims, w):
    """Thread → (j, k-quad, i-chunk): every row of the grid is written by
    exactly one active thread, a thread's z-values lie in one z line, and
    a warp's lane ± 1 holds column ± 1 (the shuffles' partners)."""
    nx, ny, nz = dims
    plan = march_plan(nx, ny, nz, w)
    act = plan["active"]
    j, k0 = plan["j"][act], plan["k0"][act]
    assert (k0 % w == 0).all() and (k0 + w <= nz).all()
    assert (np.diff(plan["lane"]) % 32 == 1).all()   # lanes count columns
    counts = np.zeros(nx * ny * nz, np.int64)
    for i0, rows in zip(plan["i0"], plan["rows"]):
        assert 1 <= rows <= MARCH_CHUNK
        i = np.arange(i0, i0 + rows)
        row = ((i[:, None, None] * ny + j[None, :, None]) * nz
               + k0[None, :, None] + np.arange(w)[None, None, :])
        np.add.at(counts, row.reshape(-1), 1)
    assert (counts == 1).all()
    gx, gy = march_grid(nx, ny, nz, w)
    assert gx * MARCH_THREADS == plan["active"].size
    assert act.sum() == ny * (nz // w)
    assert gy == len(plan["i0"]) and plan["i0"][-1] < nx


@pytest.mark.parametrize("dims,w", FORMS)
def test_march_mirror_equals_first_design_order(dims, w):
    """The march's arithmetic, thread by thread, equals the first design's
    tap order bit for bit (so the kernel can equal ``_before_spmv``)."""
    nx, ny, nz = dims
    x = t(seeded(nx * ny * nz, seed=11, dtype=np.float32))
    want = _tap_order(x, nx, ny, nz, COEFFS)
    assert torch.equal(march_reference(x, nx, ny, nz, COEFFS, w), want)


@pytest.mark.parametrize("dims,w", [f for f in FORMS
                                    if f[0] != (128, 128, 128)])
def test_march_mirror_near_cgx_pallas(dims, w):
    """Against cgx's K1 (interpret mode): within 1e-6 · max|y| (fp32, the
    same seven terms summed in another order)."""
    nx, ny, nz = dims
    x = seeded(nx * ny * nz, seed=12, dtype=np.float32)
    want = np.asarray(stencil3d_spmv_pallas(
        jnp.asarray(x), nx=nx, ny=ny, nz=nz, coeffs=COEFFS, interpret=True))
    got = n_(march_reference(t(x), nx, ny, nz, COEFFS, w))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_march_width_follows_shape_and_alignment():
    """The float4 form needs nz % 4 == 0 and both vectors 16-byte aligned;
    anything else takes the scalar form."""
    assert re.search(r"vec = nz % 4 == 0 &&\s*reinterpret_cast<uintptr_t>"
                     r"\(x\) % 16 == 0 &&\s*reinterpret_cast<uintptr_t>"
                     r"\(y\) % 16 == 0;", STENCIL_CU)
    assert march_width(32, 256, 512) == 4
    assert march_width(53, 256, 512) == 1
    assert march_width(32, 256 + 4, 512) == 1    # x a view at offset 1
    assert march_width(32, 256, 512 + 8) == 1
    assert march_grid(128, 128, 128, 4) == (
        128 * 32 // MARCH_THREADS, -(-128 // MARCH_CHUNK))
    assert march_grid(37, 41, 53, 1) == (
        -(-41 * 53 // MARCH_THREADS), -(-37 // MARCH_CHUNK))


def test_march_coefficients_packed_once_in_tap_order():
    """The host call packs the taps once per coefficient tuple, in
    ``stencil_row``'s order: centre, z+, z−, y+, y−, x+, x−."""
    packed = k1._packed_coeffs(COEFFS)
    assert packed is k1._packed_coeffs(tuple(COEFFS))
    assert list(packed) == [6.5, -1.5, -1.5, -0.75, -0.75, -1.25, -1.25]


def test_k1_on_the_cpu_takes_the_plain_version():
    """A CPU tensor takes the plain version: no launch is counted."""
    x = t(seeded(5 * 7 * 6, seed=13, dtype=np.float32))
    before = k1.stencil3d_spmv_launches
    y = k1.stencil3d_spmv(x, nx=5, ny=7, nz=6, coeffs=COEFFS)
    assert k1.stencil3d_spmv_launches == before
    assert torch.equal(y, k1.stencil3d_spmv_reference(x, 5, 7, 6, COEFFS))


# -- K10: the stacked product over K7's row layout ---------------------------

def _matrix(case):
    """tests/test_torch_cuda.py's WBELL cases: one group and five groups of
    1024 internal rows (scipy, seeded)."""
    n, density = {"one_group": (700, 0.01), "five_groups": (5000, 0.002)}[
        case]
    r = sp.random(n, n, density=density, random_state=n, format="csr")
    return sp.csr_matrix((r + r.T) + sp.eye(n) * (2.0 + density * n))


def _operands(case, k):
    a = _matrix(case)
    wj = cgx.wbell_from_csr(a)
    wt = cgx_torch.wbell_from_csr(a, device="cpu")
    x = np.random.default_rng(k).standard_normal((a.shape[0], k)).astype(
        np.float32)
    xb = np.stack([np.asarray(wj.to_internal(x[:, c])) for c in range(k)])
    want = np.asarray(jkw.wbell_spmm_stacked(wj, jkw.to_stacked(
        jnp.asarray(xb))))
    return wt, t(xb), want


@pytest.mark.parametrize("k", [1, 3, 9])
def test_stacked_index_is_the_stacked_layout(k):
    """``stacked_index`` (the kernel's ``Stacked::at`` row map) finds
    column c of internal row r where ``to_stacked`` puts it."""
    nt = 3
    xb = torch.arange(k * nt * 1024).reshape(k, nt, 8, 128)
    flat = tkw.to_stacked(xb).reshape(-1)
    r = torch.arange(nt * 1024)
    at = stacked_index(r, k)
    assert at.shape == (k, nt * 1024)
    want = torch.arange(k)[:, None] * (nt * 1024) + r
    assert torch.equal(flat[at], want)
    assert torch.equal(torch.sort(at.reshape(-1)).values,
                       torch.arange(k * nt * 1024))


@pytest.mark.parametrize("case,k", [("one_group", 3), ("one_group", 9),
                                    ("five_groups", 3), ("five_groups", 9)])
def test_k10_row_layout_equals_cgx_stacked(case, k):
    """The row layout's product on the stacked columns, restacked (what K10
    now computes), equals cgx's ``wbell_spmm_stacked`` (interpret) bit for
    bit; the wrapper's plain version (the plane walk) agrees."""
    wt, xb, want = _operands(case, k)
    xs = tkw.to_stacked(xb)
    got = tkw.to_stacked(tkw.rows_product(wt.rows, tkw.from_stacked(xs)))
    np.testing.assert_array_equal(n_(got), want)
    assert torch.equal(tkw.wbell_spmm_stacked(wt, xs), got)


def test_k10_row_layout_int32_columns(monkeypatch):
    """Over a row layout with absolute int32 columns (x0 = 0): equal to
    cgx's ``wbell_spmm_stacked`` and to the 16-bit layout bit for bit."""
    wt, xb, want = _operands("five_groups", 4)
    monkeypatch.setattr(tsw, "ROW_OFFSET_LIMIT", 1024)
    wide = tsw.row_layout(wt.values, wt.lc, wt.resident_walk, wt.p_og,
                          wt.p_ga, wt.nt)
    assert wide.cols.dtype == torch.int32 and int(wide.x0.abs().max()) == 0
    got = tkw.to_stacked(tkw.rows_product(wide, xb))
    np.testing.assert_array_equal(n_(got), want)
    assert torch.equal(got, tkw.to_stacked(tkw.rows_product(wt.rows, xb)))

"""The host side of K4's and K3 B's redesigns, on the CPU.

The rows each thread of the redesigned sweeps loads together
(``fused_engine.sweep_groups``: two rows in flight in K4, ``B_ROWS`` in
K3 B) against K3's per-thread order; K3 B's rows-in-flight plain version
(``kernel_b_rows_reference``, its sums in the kernel's orders) against
``FusedCG.kernel_b_reference`` bit for bit; K4's grid (``launch_grid``)
at the smoke's sizes; the per-tier stream floors the smoke prints; and
the no-alias check of kernel B's wrapper.  None of them needs JAX or the
CUDA library.
"""
import os
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from cgx_torch.kernels import fused_engine as k3  # noqa: E402
from cgx_torch.kernels import fused_semiresident as k4  # noqa: E402

TAPS7 = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
         (1, 0, 0), (-1, 0, 0))
SMS = 132


def _k3_rows(g, n, threads=256):
    """K3's partition: thread u of virtual block vb takes vb·threads + u
    + m·g·threads < n, in order."""
    step = g * threads
    return {(vb, u): list(range(vb * threads + u, n, step))
            for vb in range(g) for u in range(threads)}


@pytest.mark.parametrize("g,n,rows", [
    (3, 1000, 2), (3, 1000, 4), (5, 4099, 2), (5, 4099, 4), (2, 513, 1),
    (7, 256 * 7 * 3 + 5, 4), (4, 100, 2), (2, 256 * 2 * 9, 4)])
def test_sweep_groups_keep_k3_order(g, n, rows):
    """Every row once, in K3's per-thread order; each group at most
    ``rows`` rows a step apart, and only a thread's last full group or its
    single rows after it may be short."""
    groups = k3.sweep_groups(g, n, rows)
    want = _k3_rows(g, n)
    assert groups.keys() == want.keys()
    seen = []
    step = g * 256
    for key, gs in groups.items():
        assert [r for grp in gs for r in grp] == want[key]
        for grp in gs:
            assert 1 <= len(grp) <= rows
            assert all(b - a == step for a, b in zip(grp, grp[1:]))
        seen.extend(r for grp in gs for r in grp)
    assert sorted(seen) == list(range(n))


def test_sweep_groups_put_rows_in_flight():
    """Past the first rows·step rows every thread has a full group: the
    loads of ``rows`` rows go out before any store."""
    g, rows = 3, 4
    n = g * 256 * rows * 5
    for gs in k3.sweep_groups(g, n, rows).values():
        assert [len(grp) for grp in gs] == [rows] * 5


def _engine(dtype, weighted, dims=(11, 13, 17)):
    n = int(np.prod(dims))
    w = None
    if weighted:
        w = torch.from_numpy(np.random.default_rng(5).uniform(
            0.5, 2.0, n).astype(np.float32))
    return k3.FusedCG(*dims, TAPS7, dtype=dtype,
                      coeffs=(6.0,) + (-1.0,) * 6, weight=w)


@pytest.mark.parametrize("g", [1, 3, 7])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_b_rows_reference_equals_plain(dtype, weighted, g):
    """The plain version of K3 B with its rows in flight (two in bf16,
    one in fp32) over K3's partition (n = 2431, not a multiple of 256; 1,
    3 or 7 blocks) equals the plain kernel B bit for bit: x', r', p' and
    the two sums."""
    eng = _engine(dtype, weighted)
    rng = np.random.default_rng(7)
    p = torch.from_numpy(rng.standard_normal(eng.n).astype(
        np.float32)).to(dtype)
    r = torch.from_numpy(rng.standard_normal(eng.n).astype(
        np.float32)).to(dtype)
    x = (0.5 * p.float()).to(dtype)
    q, pq, qq = eng.kernel_a_reference(p)
    rz = torch.sum(r.double() ** 2).float()
    got = k3.kernel_b_rows_reference(eng, rz, pq, qq, x, r, p, q, g,
                                     k3.B_ROWS[dtype])
    want = eng.kernel_b_reference(rz, pq, qq, x, r, p, q)
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and torch.equal(u, v)


def test_block_tree_is_the_kernels_order():
    """The fold's tree adds each warp's xor butterfly, then the warps in
    order: on values whose fp64 sum depends on the order it gives the
    butterfly's result, not the left-to-right one."""
    v = torch.zeros(256, dtype=torch.float64)
    v[0], v[16], v[1] = 1e16, -1e16, 1.0
    # Lane 0: (v0 + v16) + ... = 0 + 1 exactly; left to right gives 0.
    assert float(k3._block_tree(v[None])[0]) == 1.0
    assert (v[0] + v[1]) + v[16] == 0.0
    parts = torch.arange(1, 1001, dtype=torch.float64)
    assert float(k3._fold(parts)) == 500500.0


@pytest.mark.parametrize("ntaps,ga,gb,cap,want", [
    # 7 taps (const 160³/216³/288³, DIA-7): K3's grids and K4's cap are 8
    # blocks an SM; 27 taps (DIA-27): A's 4, B's 8, K4's cap 4.
    (7, 8 * SMS, 8 * SMS, 8 * SMS, 8 * SMS),
    (27, 4 * SMS, 8 * SMS, 4 * SMS, 4 * SMS),
    (7, 8 * SMS, 8 * SMS, 6 * SMS, 4 * SMS),
    (27, 4 * SMS, 8 * SMS, 3 * SMS, 4 * SMS)])
def test_k4_launch_grid_at_the_smoke_sizes(ntaps, ga, gb, cap, want):
    """K4's grid is ``launch_grid`` of K3's grids within its cap: every
    block sweeps as many of K3's virtual blocks as every other."""
    if 2 * cap < max(ga, gb):
        with pytest.raises(ValueError, match="no grid"):
            k4.launch_grid(ga, gb, cap, SMS)
        return
    grid = k4.launch_grid(ga, gb, cap, SMS)
    assert grid == want and ga % grid == 0 and gb % grid == 0
    assert k4._cached_grid(ga, gb, cap, SMS) == grid


@pytest.mark.parametrize("dims,mode,streams,us", [
    ((160, 160, 160), "rpq", 9, 44.0), ((216, 216, 216), "rp", 7, 84.2),
    ((288, 288, 288), "p", 7, 199.7)])
def test_k4_stream_floors(dims, mode, streams, us):
    """The per-tier stream floors the smoke prints beside K4's times, at
    3.35 TB/s: the tier the card's plan gives each size."""
    n = int(np.prod(dims))
    assert k4.STREAMS[mode] == streams
    assert round(chip_smoke.floor_us(k4.STREAMS[mode], n), 1) == us
    if mode == "rpq":
        assert k4.sr_mode(*dims, TAPS7) == "rpq"


def test_no_alias_check_refuses_shared_storage():
    base = torch.zeros(100)
    other = torch.zeros(100)
    k3.check_no_alias("K", x=base, r=other, w=None)
    for a, b in ((base, base), (base, base[10:20]), (base[:50], base[50:]),
                 (base, base.view(10, 10))):
        with pytest.raises(ValueError, match="share storage"):
            k3.check_no_alias("K", x=a, r=other, p=b)
    with pytest.raises(ValueError, match="q and w"):
        k3.check_no_alias("K", x=base, q=other, w=other)


@pytest.mark.parametrize("g,fit,want", [(1056, 1056, 1056), (1056, 2000, 1056),
                                        (1056, 792, 528), (528, 1056, 528),
                                        (1056, 1, 1), (7, 3, 3)])
def test_even_grid(g, fit, want):
    grid = k3.even_grid(g, fit)
    assert grid == want and grid <= min(g, fit)
    per = -(-g // grid)
    assert -(-g // per) == grid


def test_first_designs_need_a_card():
    """The same-run "before" of K4 has no CPU mode; kernel B keeps two
    rows in flight in bf16 vectors and one in fp32 (``BRows`` in
    fused_engine.cu)."""
    g = k4.make_sr_geometry(4, 5, 6, TAPS7, mode="rpq")
    b = torch.ones(g.n)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        k4._before_call(g, b, coeffs=(6.0,) + (-1.0,) * 6)
    from cgx_torch.kernels import _build

    src = (_build.CSRC / "fused_engine.cu").read_text()
    assert k3.B_ROWS == {torch.float32: 1, torch.bfloat16: 2}
    assert "struct BRows<bf16> {\n  static constexpr int value = 2;" in src
    assert "struct BRows {  // kernel_b2's rows of a thread in flight\n" \
        "  static constexpr int value = 1;" in src


@pytest.mark.parametrize("ntaps,planes,mode,first", [
    (7, False, "rpq", False), (7, True, "rpq", True), (7, True, "rp", False),
    (7, True, "p", False), (27, True, "rpq", False), (27, False, "p", False)])
def test_k4_design_by_instance(ntaps, planes, mode, first):
    """Only plane operators of at most 7 taps in the rpq tier keep the
    first design's kernel, where the redesign measured slower."""
    taps = TAPS7 if ntaps == 7 else tuple(
        (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
        for dz in (-1, 0, 1))
    dims = (4, 5, 6)
    coeffs = (None,) * ntaps if planes else (1.0,) * ntaps
    pl = torch.ones(ntaps, 120) if planes else None
    eng = k3.FusedCG(*dims, taps, coeffs=coeffs, planes=pl)
    g = k4.make_sr_geometry(*dims, taps, mode=mode,
                            n_planes=ntaps if planes else 0)
    want = k4._FIRST_DESIGN if first else k4._REDESIGN
    assert k4._design_for(g, eng) == want


def _c_entries(src: str):
    """``{name: [argtype, ...]}`` of the ``extern "C"`` functions of a CUDA
    source: a pointer parameter is ``c_void_p``, any other ``c_int``."""
    import ctypes
    import re

    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                           for p in params]
    return out


@pytest.mark.parametrize("source", [
    "bsr.cu", "fused_engine.cu", "fused_multi.cu", "onepass.cu",
    "resident_cg.cu", "semiresident.cu", "stencil.cu", "wbell.cu"])
def test_c_entries_match_their_bindings(source):
    """Every C entry point of a kernel source is bound with the arguments
    it declares, in number and kind: ctypes passes whatever it is told."""
    from cgx_torch.kernels import _build

    entries = _c_entries((_build.CSRC / source).read_text())
    assert entries
    for name, argtypes in entries.items():
        assert _build._SIGNATURES[name] == argtypes, name


def test_every_binding_has_an_entry():
    """No binding names an entry point that no source declares."""
    from cgx_torch.kernels import _build

    names = set()
    for cu in _build.CSRC.glob("*.cu"):
        names |= set(_c_entries(cu.read_text()))
    assert set(_build._SIGNATURES) == names

"""The host side of K2's and K6's redesigns, on the CPU.

K2 (two phases): the p buffers of :func:`pingpong_step` and the exit
buffer of :func:`pingpong_exit`, through :func:`two_phase_reference` (the
CPU path of ``resident_cg_call``), held against the textbook recurrence
:func:`resident_cg_reference` bit for bit, and K2's default grid.  K6:
the grid that :func:`launch_grid` picks.  Both: the node the kernels carry
from row to row (``carried_nodes``) against ``divmod``, and the stream
counts ``chip_smoke.py`` prints.  None of them needs the CUDA library.
"""
import os
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import cgx_torch  # noqa: E402
from cgx_torch.io.poisson import poisson3d_dia27  # noqa: E402
from cgx_torch.kernels import fused_dia_cg as fdia  # noqa: E402
from cgx_torch.kernels import fused_onepass as k6  # noqa: E402
from cgx_torch.kernels import fused_resident as k2  # noqa: E402
from cgx_torch.kernels.fused_cg import stencil_taps  # noqa: E402
from cgx_torch.kernels.stencil import carried_nodes  # noqa: E402
from torch_parity import scaled_dia_data, seeded, t  # noqa: E402


def _case(op):
    """``(spec, b, kwargs)`` of a small K2 solve on the CPU."""
    if op in ("p3d", "27point", "2d"):
        a = {"p3d": lambda: cgx_torch.poisson3d_stencil(9, 8, 7),
             "27point": lambda: cgx_torch.poisson3d_27point(6, 7, 5),
             "2d": lambda: cgx_torch.poisson2d_stencil(13, 11)}[op]()
        b = t(seeded(a.shape[0], seed=81, dtype=np.float32))
        return stencil_taps(a), b, {}
    if op == "dia27":
        a = poisson3d_dia27(7, 6, 8, variable=True, seed=3, device="cpu")
    else:
        data, offs, shape = scaled_dia_data(8, 7, 6, seed=4)
        a = cgx_torch.DIAMatrix(data=t(data.astype(np.float32)),
                                offsets=offs, shape=shape)
    nx, ny, nz, taps, coeffs, planes, e, w, sym = fdia.dia_prep(
        a, torch.float32, jacobi=op != "dia7_plain")
    b = t(seeded(a.shape[0], seed=82, dtype=np.float32))
    return ((nx, ny, nz, taps, coeffs), b if e is None else e * b,
            dict(planes=planes, weight=w, sym=sym))


def _equal(got, want):
    assert int(got[3]) == int(want[3])
    for u, v in zip(got[:3] + got[4:5], want[:3] + want[4:5]):
        assert torch.equal(u, v)


OPS = ["p3d", "27point", "2d", "dia7", "dia27", "dia7_plain"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("maxiter", [0, 1, 2, 7, 4000])
def test_two_phase_dataflow_equals_textbook_recurrence(op, maxiter):
    """x, r, the exit p, the count and (rz, rw) of the CPU path equal the
    textbook recurrence bit for bit, at every stopping point: p comes back
    as r after no iteration and as r + β·p_old from either buffer."""
    spec, b, kw = _case(op)
    got = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=maxiter, **kw)
    _equal(got, k2.resident_cg_reference(spec, b, tol=1e-6, maxiter=maxiter,
                                         **kw))
    if maxiter == 0:
        assert torch.equal(got[2], got[1])


@pytest.mark.parametrize("op", ["p3d", "dia27"])
@pytest.mark.parametrize("split", [0, 1, 6, 7])
def test_two_phase_resume_equals_one_call(op, split):
    """A solve stopped after ``split`` iterations (even and odd: the newest
    p in either buffer) and resumed equals one call bit for bit."""
    spec, b, kw = _case(op)
    full = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=4000, **kw)
    x, r, p, k, rz, _ = k2.resident_cg_call(spec, b, tol=1e-6,
                                            maxiter=split, **kw)
    assert int(k) == split
    rest = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=4000,
                               resume=(x, r, p, rz[0], rz[1]), **kw)
    assert split + int(rest[3]) == int(full[3])
    for u, v in zip(rest[:3] + rest[4:5], full[:3] + full[4:5]):
        assert torch.equal(u, v)
    again = k2.resident_cg_call(spec, b, tol=1e-6, maxiter=0,
                                resume=(x, r, p, rz[0], rz[1]), **kw)
    assert torch.equal(again[2], p)


def test_two_phase_warm_start_equals_textbook():
    spec, b, _ = _case("p3d")
    x0 = t(0.1 * seeded(b.shape[0], seed=83, dtype=np.float32))
    _equal(k2.resident_cg_call(spec, b, x0, tol=1e-6, maxiter=4000),
           k2.resident_cg_reference(spec, b, x0, tol=1e-6, maxiter=4000))


@pytest.mark.parametrize("resume", [False, True])
def test_pingpong_plan_reads_only_written_buffers(resume):
    """Every iteration reads r or a buffer that holds the newest p_new (or,
    on resume, the given p), writes the other one, and the exit forms p
    from the buffer that the last iteration wrote."""
    written = {0} if resume else set()
    newest = 0 if resume else "r"
    for k in range(9):
        read, write = k2.pingpong_step(k, resume)
        assert read == newest and write != read
        assert read == "r" or read in written
        written.add(write)
        newest = write
        assert k2.pingpong_exit(k + 1, resume) == newest
    assert k2.pingpong_exit(0, resume) == (None if resume else "r")


@pytest.mark.parametrize("dims", [(224, 224, 224), (192, 192, 192),
                                  (128, 128, 128), (37, 41, 53),
                                  (61, 1, 67), (5, 7, 6)])
@pytest.mark.parametrize("grid", [1056, 528, 924, 1])
def test_carried_nodes_match_divmod(dims, grid):
    """The kernels' carried node equals two divisions a row, over a
    thread's grid-stride rows (K2) and a virtual block's rows (K6), from
    seeded first rows."""
    nx, ny, nz = dims
    n = nx * ny * nz
    step = grid * 256
    rng = np.random.default_rng(grid + n)
    for row0 in list(rng.integers(0, min(step, n), 6)) + [0, step - 1]:
        row0 = int(row0)
        count = max(1, (n - row0 + step - 1) // step)
        got = carried_nodes(row0, step, count, ny, nz)
        rows = range(row0, row0 + count * step, step)
        want = [(row // (ny * nz), row // nz % ny, row % nz) for row in rows]
        assert got == want


@pytest.mark.parametrize("ga,gb,cap", [
    (1056, 1056, 1056), (1056, 1056, 792), (1056, 1056, 660),
    (924, 924, 528), (924, 1056, 1056), (792, 1056, 1056),
    (792, 792, 1056), (264, 264, 132), (1056, 528, 1056)])
def test_launch_grid_balances_the_sweeps(ga, gb, cap):
    """The grid fits the card, keeps half of K3's parallelism and a block
    per SM, and spends no more slots than any other such grid; where some
    grid divides both partitions, every block sweeps as many virtual blocks
    as every other."""
    sms = 132
    grid = k6.launch_grid(ga, gb, cap, sms)
    assert min(sms, cap) <= grid <= cap and 2 * grid >= max(ga, gb)

    def slots(g):
        return g * (-(-ga // g) + -(-gb // g))

    others = [g for g in range(min(sms, cap), cap + 1)
              if 2 * g >= max(ga, gb)]
    assert slots(grid) == min(map(slots, others))
    if any(ga % g == 0 and gb % g == 0 for g in others):
        assert ga % grid == 0 and gb % grid == 0
        for part in (ga, gb):
            counts = {len(range(blk, part, grid)) for blk in range(grid)}
            assert counts == {part // grid}


def test_launch_grid_prefers_the_larger_grid():
    # 1056 and 528 both split 1056 evenly: the larger keeps more rows in
    # flight.  An uneven split loses to an even one: 792 to 528.
    assert k6.launch_grid(1056, 1056, 1056, 132) == 1056
    assert k6.launch_grid(1056, 1056, 792, 132) == 528
    with pytest.raises(ValueError, match="no grid"):
        k6.launch_grid(1056, 1056, 100, 132)


@pytest.mark.parametrize("n_planes,weighted,three,streams", [
    (0, False, False, 10), (0, False, True, 11), (3, True, False, 14),
    (3, True, True, 15), (13, True, False, 24), (13, True, True, 25),
    (6.5, True, False, 17.5), (1.5, True, True, 13.5)])
def test_iteration_streams(n_planes, weighted, three, streams):
    assert k2.iteration_streams(n_planes, weighted, three) == streams


def test_stream_floors_the_smoke_prints():
    """K2's 10 and 11 streams (and 8, q recomputed) at 128³ and 224³, K6's
    6 and 7 (the function's and the kernel's) at 224³, over 3.35 TB/s."""
    n128, n224 = 128 ** 3, 224 ** 3
    assert round(chip_smoke.floor_us(k2.iteration_streams(), n128), 1) == 25.0
    assert round(chip_smoke.floor_us(k2.iteration_streams(three_phase=True),
                                     n128), 1) == 27.5
    assert round(chip_smoke.floor_us(8, n128), 1) == 20.0
    assert round(chip_smoke.floor_us(8, n224), 1) == 107.4
    assert round(chip_smoke.floor_us(k2.iteration_streams(), n224), 1) == 134.2
    assert round(chip_smoke.floor_us(11, n224), 1) == 147.6
    assert (k6.STREAMS, k6.DEVICE_STREAMS) == (6, 7)
    assert round(chip_smoke.floor_us(k6.STREAMS, n224), 1) == 80.5


H100 = dict(sms=132, l2_bytes=50 * 1024 * 1024)


@pytest.mark.parametrize("dims,planes_mode,full,want", [
    ((96, 96, 96), False, 792, 660), ((128, 128, 128), False, 792, 660),
    ((144, 144, 144), False, 792, 792), ((224, 224, 224), False, 792, 792),
    ((128, 128, 128), True, 1056, 1056), ((128, 128, 128), False, 528, 528),
    ((8, 8, 8), False, 132, 132)])
def test_default_grid(dims, planes_mode, full, want):
    """The constant mode launches 5 blocks an SM when its five vectors fit
    the L2 (128³: 41.9 MB of the H100's 50 MiB), else its full grid; the
    planes mode always its full grid; never more than the full grid."""
    n = dims[0] * dims[1] * dims[2]
    assert k2.default_grid(full, n, planes_mode=planes_mode, **H100) == want


def test_resident_grid_sweep_needs_a_card():
    """The grid sweep behind ``default_grid`` has no CPU mode: without a
    card it exits with code 2 before it builds anything."""
    import subprocess

    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", "cgx_torch.experiments.resident_grid_sweep"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "needs a CUDA card" in proc.stderr

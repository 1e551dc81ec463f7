"""K11's plan and its edge shapes on the CPU: which path ``bell_plan`` takes
for each shape, that every plan fits the card (shared memory, threads, grid),
the alignment rule, the plain version against cgx's block-ELL kernel in
interpret mode at the new paths' edge shapes, and ``tensor_from_numpy``'s
default device."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cgx.kernels import bsr as jbsr  # noqa: E402
from cgx_torch.interop import tensor_from_numpy  # noqa: E402
from cgx_torch.kernels import bsr as tbsr  # noqa: E402
from torch_parity import n_, t  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("bs,k,dtype,aligned,path", [
    (64, 256, F32, True, "tiled"),      # B1
    (64, 512, F32, True, "tiled"),      # B1, k = 512
    (64, 256, BF16, True, "mma"),       # B2
    (8, 1, F32, True, "rows"),          # B3, bell_spmv
    (8, 4, F32, True, "rows"),          # B3, k = 4
    (8, 256, BF16, True, "general"),    # bf16 blocks under 16
    (37, 64, F32, True, "general"),     # an odd block
    (64, 256, F32, False, "general"),   # an unaligned pointer
    (64, 256, BF16, False, "general"),
    (64, 130, F32, True, "general"),    # X's rows off 16 bytes
    (64, 8, F32, True, "general"),      # fp32, k < 16, beyond rows' range
    (8, 32, F32, True, "general"),      # a tiled block of 4 threads
    (8, 64, F32, True, "tiled"),        # 8 threads
    (16, 16, F32, True, "general"),     # 4 threads
    (24, 16, F32, True, "tiled"),       # 6 threads
])
def test_bell_plan_paths(bs, k, dtype, aligned, path):
    plan = tbsr.bell_plan(bs, k, dtype, aligned)
    assert plan.path == path
    # P2 (two slots per round) takes K11's path.
    assert tbsr.bell_plan(bs, k, dtype, aligned, slots=2).path == path


def test_bell_plan_at_the_records_shapes():
    """The tiles the design names: B1 in 128-column tiles of 128 threads
    (8×8 patches) with one cp.async stage of 49 KB (four blocks an SM); B2
    in one 256-column tile of 8 warps; B3 in blocks of 32 block rows.  The
    tiled path's smallest blocks go to the general path."""
    b1 = tbsr.bell_plan(64, 256, F32, True)
    assert (b1.tile, b1.threads, b1.smem, b1.col_tiles) == (
        128, 128, 64 * (68 + 128) * 4, 2)
    assert b1.grid(512) == (1024, 1)
    b2 = tbsr.bell_plan(64, 256, BF16, True)
    assert (b2.tile, b2.threads, b2.col_tiles) == (256, 256, 1)
    b3 = tbsr.bell_plan(8, 1, F32, True)
    assert (b3.threads, b3.row_block, b3.smem) == (256, 32, 0)
    assert b3.grid(262144) == (8192, 1)
    # A tiled block of 2 threads is left to the general path, but can be
    # forced (the sweep's yardstick).
    assert tbsr.bell_plan(8, 16, F32, True).path == "general"
    assert tbsr.bell_plan(8, 16, F32, True, path="tiled").threads == 2
    # bs 128 with two slots per round fits a 64-column tile.
    p2 = tbsr.bell_plan(128, 256, F32, True, slots=2)
    assert p2.tile == 64 and p2.smem <= tbsr.SMEM_MAX


@pytest.mark.parametrize("slots", [1, 2])
def test_bell_plans_fit_the_card(slots):
    """Every plan over bs 1-128, k in {1, 3, 16, 64, 130, 512, 1024}, both
    dtypes and both alignments fits: shared memory <= 227 KB, threads <=
    1024, grid.y <= 65535 and grid.x < 2^31 at 262,144 block rows; a tile's
    columns cover k."""
    for bs in range(1, tbsr.MAX_BLOCKSIZE + 1):
        for k in (1, 3, 16, 64, 130, 512, 1024):
            for dtype in (F32, BF16):
                for aligned in (True, False):
                    p = tbsr.bell_plan(bs, k, dtype, aligned, slots=slots)
                    what = (bs, k, dtype, aligned, p)
                    assert 0 <= p.smem <= tbsr.SMEM_MAX, what
                    assert 1 <= p.threads <= 1024, what
                    gx, gy = p.grid(262144)
                    assert gy <= 65535 and gx < 2 ** 31, what
                    if p.path != "rows":
                        assert p.col_tiles * p.tile >= k, what


@pytest.mark.parametrize("path,bs,k,dtype", [
    ("tiled", 64, 256, BF16), ("mma", 64, 256, F32), ("rows", 8, 12, F32),
    ("tiled", 64, 256, F32), ("bogus", 8, 8, F32)])
def test_bell_plan_forced_path(path, bs, k, dtype):
    """A forced path the shape takes is planned; any other raises.  The
    general path takes every shape."""
    if path == "tiled" and dtype == F32:
        assert tbsr.bell_plan(bs, k, dtype, True, path=path).path == path
        with pytest.raises(ValueError, match="does not take"):
            tbsr.bell_plan(bs, k, dtype, False, path=path)
    else:
        with pytest.raises(ValueError, match="does not take"):
            tbsr.bell_plan(bs, k, dtype, True, path=path)
    assert tbsr.bell_plan(bs, k, dtype, True, path="general").path == \
        "general"


def test_k12_chunks_keep_the_base_alignment():
    """K12's chunks start at multiples of 256 block rows, so their offsets
    into values and y keep a 16-byte aligned base aligned at any bs, k and
    dtype; a sliced x does not."""
    for bs in (1, 3, 8, 37, 64, 128):
        for k in (1, 3, 130):
            for item in (2, 4):
                r0 = tbsr.PREFETCH_ROWS
                assert (r0 * 3 * bs * bs * item) % 16 == 0
                assert (r0 * bs * k * 4) % 16 == 0
    x = torch.zeros(65)
    assert tbsr.operands_aligned(x.data_ptr(), x[4:].data_ptr())
    assert not tbsr.operands_aligned(x.data_ptr(), x[1:].data_ptr())


def _random_bell(nbr, wb, bs, seed):
    """Seeded block-ELL arrays: wb distinct sorted block columns per row,
    every third row padded (zero blocks pointing at column 0)."""
    rng = np.random.default_rng(seed)
    cols = np.sort(np.stack([rng.choice(nbr, wb, replace=False)
                             for _ in range(nbr)]), axis=1).astype(np.int32)
    vals = rng.standard_normal((nbr, wb, bs, bs)).astype(np.float32)
    for i in range(0, nbr, 3):
        vals[i, 1 + i % (wb - 1):] = 0.0
        cols[i, 1 + i % (wb - 1):] = 0
    return vals, cols


@pytest.mark.parametrize("nbr,wb,bs,k,dtype", [
    (6, 3, 32, 130, "bf16"),     # the mma path's shape with a ragged k
    (37, 4, 8, 4, "fp32"),       # the rows path over 37 block rows
])
def test_bell_plain_matches_jax_at_edge_shapes(nbr, wb, bs, k, dtype):
    """K11's plain version against cgx's block-ELL kernel in interpret
    mode, from the same numpy operands (bf16 rounded from the same fp32
    numbers on both sides); fp32 out in both."""
    vals, cols = _random_bell(nbr, wb, bs, 7 + bs + k)
    x = np.random.default_rng(k).standard_normal(
        (nbr * bs, k)).astype(np.float32)
    shape = (nbr * bs, nbr * bs)
    j = jbsr.BlockELL(jnp.asarray(vals), jnp.asarray(cols), shape)
    p = tbsr.BlockELL(values=t(vals), block_cols=t(cols), shape=shape)
    xj, xt = jnp.asarray(x), t(x)
    if dtype == "bf16":
        j, p = j.astype(jnp.bfloat16), p.astype(BF16)
        xj, xt = xj.astype(jnp.bfloat16), xt.to(BF16)
    want = np.asarray(jbsr.bell_spmm(j, xj, interpret=True))
    got = tbsr.bell_spmm(p, xt)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(n_(got) - want).max()) <= 1e-5 * scale


def test_bell_sweep_needs_a_card():
    """The sweep of the tiled path against the general path has no CPU
    mode: without a card it exits with code 2 before it builds anything."""
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", "cgx_torch.experiments.bell_sweep"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "needs a CUDA card" in proc.stderr


def test_tensor_from_numpy_defaults_to_the_card():
    """Like its siblings, ``tensor_from_numpy`` puts data on the card
    unless the caller asks for the CPU: without a card the bare call
    raises, and ``device="cpu"`` copies."""
    v = np.arange(5.0)
    if torch.cuda.is_available():
        assert tensor_from_numpy(v).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tensor_from_numpy(v)
    got = tensor_from_numpy(v, device="cpu")
    assert got.device.type == "cpu" and np.array_equal(n_(got), v)

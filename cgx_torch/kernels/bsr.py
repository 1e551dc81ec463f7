"""K11 and K12: the block-ELL SpMM — the CUDA kernel and its plain versions.

Counterpart of :mod:`cgx.kernels.bsr`.  :class:`BlockELL` stores every
block row as exactly ``wb`` dense ``(bs, bs)`` blocks (padding blocks are
zero and point at block column 0); :func:`bell_from_bsr` builds it from a
:class:`~cgx_torch.sparse.types.BSRMatrix`.  :func:`bell_spmm` computes
``Y = A @ X`` through K11 (``cgx_torch/csrc/bsr.cu``), which replaces both
TPU functions, ``_bell_spmm_dma`` and ``_bell_spmm_resident``: they
compute the same ``Y`` and differ only in where ``X`` sits in VMEM.  So
the engines ``"auto"``, ``"resident"`` and ``"dma"`` all launch K11, and
the VMEM and SMEM caps that chose between them on the TPU
(``_BELL_RESIDENT_VMEM_CAP``, ``_BELL_RESIDENT_MAX_IDS``) are not ported.

``engine="prefetch"`` is K12 (``_bell_spmm_prefetch``): the JAX package
runs it per chunk of :data:`PREFETCH_ROWS` block rows, because the TPU's
SMEM holds the scalar-prefetched id table of at most that many rows.  K12
computes K11's ``Y`` and differs from it only in those two TPU matters
(where ``X`` sits in VMEM, and the chunks), so it has no device code of its
own: the port keeps the chunk loop and launches K11's kernel once per
chunk, at pointer offsets into ``values``, ``block_cols`` and one
preallocated ``Y``.  Its ``Y`` equals K11's bit for bit;
``bell_prefetch_launches`` counts its launches (one per chunk) and
:func:`bell_prefetch_reference` is its plain version, chunked the same way.

The wrapper launches K11 for a CUDA tensor and takes the plain version
:func:`bell_spmm_reference` only for a CPU tensor.  K11 takes float32
values with float32 ``X`` or bfloat16 with bfloat16, ``bs`` up to 128, and
returns float32; the plain version takes any dtype.  As in the JAX
package the output is float32 when ``X``'s item size is below 4 bytes
(a wide accumulator), else ``X``'s dtype.

K11 has four paths, all hand-written CUDA, and :func:`bell_plan` chooses
one from ``(bs, k, dtype)`` and whether the operands' pointers are 16-byte
aligned, never from the number of block rows or slots: ``"tiled"``
(float32 register tiles, bs a multiple of 8, k >= 16), ``"mma"`` (bfloat16
on the tensor cores, bs a multiple of 16), ``"rows"`` (float32, bs <= 16
and k <= 8) and ``"general"`` (every other shape, and any unaligned
pointer).  The tiled path's blocks of 2 to 4 threads (bs 8 with k <= 32,
bs 16 with k 16) lose to the general path and are left to it;
:mod:`cgx_torch.experiments.bell_sweep` times the two paths over bs and
k.  ``bell_tiled_launches``, ``bell_mma_launches``,
``bell_rows_launches`` and ``bell_general_launches`` count K11's launches
by path; ``bell_spmm_launches`` is their sum.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = ["BlockELL", "BellPlan", "bell_from_bsr", "bell_plan",
           "bell_spmm", "bell_spmv", "bell_spmm_reference",
           "bell_prefetch_reference", "bell_spmm_launches",
           "bell_tiled_launches", "bell_mma_launches", "bell_rows_launches",
           "bell_general_launches", "bell_path_launches",
           "bell_prefetch_launches",
           "MAX_BLOCKSIZE", "PATHS", "PREFETCH_ROWS", "SMEM_MAX"]

# Kernel launches so far (a run resets them to show that it used the kernel).
# K11's by path; bell_spmm_launches is their sum.  K12's chunks and P2 count
# on their own counters.
bell_spmm_launches = 0
bell_tiled_launches = 0
bell_mma_launches = 0
bell_rows_launches = 0
bell_general_launches = 0
bell_prefetch_launches = 0
# The largest block K11 takes: the general path's shared memory holds one
# (bs, bs) block and one (bs, 64) tile of X.
MAX_BLOCKSIZE = 128
# K12's chunk of block rows (the JAX package's _MAX_PREFETCH_ROWS).
PREFETCH_ROWS = 256
_ENGINES = ("auto", "resident", "dma", "prefetch")
# K11's paths, in the C entry's numbering.
PATHS = ("general", "tiled", "mma", "rows")
# Shared memory a block may use on the H100 (227 KB).
SMEM_MAX = 232448
_MAX_THREADS = 256        # the general, tiled and mma paths' blocks
_ROWS_THREADS = 256       # the rows path's block, at most
_TILED_PAD = 4            # fp32 words of padding per staged value row
# The fewest threads of a tiled block that the plan chooses: at 2-4 the
# general path was 1.2-2.4x faster (bell_sweep on the H100).
_TILED_MIN_THREADS = 5
_MMA_PAD = 8              # bf16 elements of padding per staged row
_MMA_STAGES = 2           # the mma path's cp.async ring


@dataclass(frozen=True, eq=False)
class BlockELL:
    """Block-ELL matrix: ``wb`` dense blocks in every block row."""

    values: torch.Tensor      # (n_block_rows, wb, bs, bs)
    block_cols: torch.Tensor  # (n_block_rows, wb) int32
    shape: Tuple[int, int]

    @property
    def blocksize(self) -> int:
        return self.values.shape[-1]

    @property
    def wb(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def astype(self, dtype) -> "BlockELL":
        return dataclasses.replace(self, values=self.values.to(dtype))


def bell_from_bsr(a) -> BlockELL:
    """Convert a :class:`~cgx_torch.sparse.types.BSRMatrix` to block-ELL,
    on the BSR's device.  The slot of every block is computed on the host
    in numpy, as the JAX package computes it; padding blocks are zero and
    point at block column 0, and ``wb`` is the longest block row (at
    least 1)."""
    dev = a.values.device
    indptr = a.indptr.cpu().numpy()
    bs = a.blocksize
    nbr = len(indptr) - 1
    counts = np.diff(indptr)
    wb = max(int(counts.max()), 1) if nbr else 1
    rows = np.repeat(np.arange(nbr, dtype=np.int64), counts)
    slots = np.arange(int(indptr[-1]), dtype=np.int64) \
        - np.repeat(indptr[:-1].astype(np.int64), counts)
    out_cols = np.zeros((nbr, wb), dtype=np.int32)
    out_cols[rows, slots] = a.col_indices.cpu().numpy()
    values = torch.zeros((nbr, wb, bs, bs), dtype=a.values.dtype, device=dev)
    values[torch.from_numpy(rows).to(dev),
           torch.from_numpy(slots).to(dev)] = a.values
    return BlockELL(values=values, block_cols=torch.from_numpy(out_cols)
                    .to(dev), shape=a.shape)


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.element_size() < 4 else x.dtype


def bell_spmm_reference(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """K11's plain version on any device: ``Y[i] = Σ_j values[i, j] @
    Xb[cols[i, j]]``, slot by slot in order, in the output dtype (float32
    for 16-bit ``X``).  One slot at a time bounds the gather's memory."""
    nbr, wb, bs, _ = a.values.shape
    k = x.shape[1]
    out = _out_dtype(x)
    xb = x.reshape(-1, bs, k).to(out)
    cols = a.block_cols.long()
    y = torch.zeros((nbr, bs, k), dtype=out, device=x.device)
    for j in range(wb):
        y += torch.matmul(a.values[:, j].to(out), xb[cols[:, j]])
    return y.reshape(nbr * bs, k)


def bell_prefetch_reference(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """K12's plain version on any device: :func:`bell_spmm_reference` per
    chunk of :data:`PREFETCH_ROWS` block rows, each written into its rows of
    one ``Y``."""
    nbr, _, bs, _ = a.values.shape
    y = torch.empty((nbr * bs, x.shape[1]), dtype=_out_dtype(x),
                    device=x.device)
    for r0 in range(0, nbr, PREFETCH_ROWS):
        r1 = min(r0 + PREFETCH_ROWS, nbr)
        part = dataclasses.replace(a, values=a.values[r0:r1],
                                   block_cols=a.block_cols[r0:r1])
        y[r0 * bs:r1 * bs] = bell_spmm_reference(part, x)
    return y


@dataclass(frozen=True)
class BellPlan:
    """How K11's CUDA entry runs one call: the path, the column tile (the
    rows path: ``k``), the threads per block, the dynamic shared memory in
    bytes, the block rows per CUDA block and the column tiles across
    ``k``."""

    path: str
    tile: int
    threads: int
    smem: int
    row_block: int
    col_tiles: int

    def grid(self, nbr: int) -> Tuple[int, int]:
        """The launch grid over ``nbr`` block rows: ``(nbr, col_tiles)``
        on the general path; one dimension on the others (the column tile
        fastest, so a block row's tiles run side by side).  The C entry
        launches this grid after checking it against its own."""
        if self.path == "general":
            return nbr, self.col_tiles
        return -(-nbr // self.row_block) * self.col_tiles, 1


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _mma_ni(bs: int) -> int:
    """n-tiles of 8 columns per warp on the mma path (at most 64 fp32
    accumulators a thread)."""
    mi = bs // 16
    return 8 if mi <= 2 else (4 if mi <= 4 else 2)


def _tiled_tile(k: int) -> int:
    """The tiled path's widest column tile for ``k`` columns."""
    return 128 if k > 64 else 64 if k > 32 else 32 if k > 16 else 16


def _takes(path: str, bs: int, k: int, bf16: bool, aligned: bool) -> bool:
    """Whether ``path``'s kernel runs the shape."""
    if path == "general":
        return True
    if not aligned:
        return False
    if path == "mma":
        return bf16 and bs % 16 == 0 and k % 8 == 0
    if path == "rows":
        return not bf16 and bs <= 16 and k <= 8
    return not bf16 and bs % 8 == 0 and k >= 16 and k % 4 == 0


def bell_plan(bs: int, k: int, dtype, aligned: bool, *, slots: int = 1,
              path: str | None = None) -> BellPlan:
    """The plan of a K11 call over ``(bs, bs)`` blocks of ``dtype`` and
    ``k`` columns, with ``slots`` slots staged per round (1 for K11 and
    K12, 2 for P2).  ``aligned``: whether values, x and y start at 16-byte
    boundaries; where they do not, the general path.  ``path`` forces a
    path whose kernel runs the shape (the tests', the smoke's and the
    sweep's yardstick); it raises ``ValueError`` for one that does not.  A
    pure function: the C entry recomputes the threads, the shared memory
    and the grid and refuses a plan that disagrees."""
    bf16 = dtype == torch.bfloat16
    if path is None:
        path = next(p for p in ("mma", "rows", "tiled", "general")
                    if _takes(p, bs, k, bf16, aligned) and not (
                        p == "tiled" and (bs // 8) * (_tiled_tile(k) // 8)
                        < _TILED_MIN_THREADS))
    elif path not in PATHS or not _takes(path, bs, k, bf16, aligned):
        raise ValueError(f"bell_plan: the {path!r} path does not take bs "
                         f"{bs}, k {k}, {dtype}, aligned {aligned}")
    if path == "general":
        kt = _pow2_at_least(min(k, 64))
        threads = min(max(_pow2_at_least(bs * kt), 32), _MAX_THREADS)
        smem = (bs * (slots * bs + 1) + slots * bs * kt) * 4
        return BellPlan(path, kt, threads, smem, 1, -(-k // kt))
    if path == "rows":
        rpc = _ROWS_THREADS // bs
        return BellPlan(path, k, rpc * bs, 0, rpc, 1)
    if path == "tiled":
        # The widest column tile whose one cp.async stage fits.
        kt = _tiled_tile(k)
        while slots * (bs * (bs + _TILED_PAD) + bs * kt) * 4 > SMEM_MAX:
            kt //= 2     # bs 128 with two slots a round: kt 64
        smem = slots * (bs * (bs + _TILED_PAD) + bs * kt) * 4
        return BellPlan(path, kt, (bs // 8) * (kt // 8), smem, 1,
                        -(-k // kt))
    wn = 8 * _mma_ni(bs)
    nw = 1
    while nw < 8 and nw * wn < k:
        nw *= 2
    while True:
        kt = nw * wn
        smem = _MMA_STAGES * slots * (bs * (bs + _MMA_PAD)
                                      + bs * (kt + _MMA_PAD)) * 2
        if smem <= SMEM_MAX or nw == 1:
            return BellPlan(path, kt, 32 * nw, smem, 1, -(-k // kt))
        nw //= 2


def checked_operands(what: str, values: torch.Tensor, cols: torch.Tensor,
                     x: torch.Tensor):
    """The contiguous ``(values, cols, x)`` of a block-ELL kernel call, after
    the checks of what K11's CUDA kernel takes."""
    pair = (values.dtype, x.dtype)
    if pair not in ((torch.float32, torch.float32),
                    (torch.bfloat16, torch.bfloat16)):
        raise TypeError(f"{what}: the CUDA kernel takes float32 values "
                        "with float32 x or bfloat16 with bfloat16, got "
                        f"{pair[0]} and {pair[1]}")
    bs = values.shape[-1]
    if bs > MAX_BLOCKSIZE:
        raise ValueError(f"{what}: the CUDA kernel takes blocks up to "
                         f"{MAX_BLOCKSIZE}, got {bs}")
    if cols.dtype != torch.int32:
        raise ValueError(f"{what}: block_cols must be int32")
    if values.device != x.device or cols.device != x.device:
        raise ValueError(f"{what}: the operands must lie on {x.device}")
    return values.contiguous(), cols.contiguous(), x.contiguous()


def operands_aligned(*ptrs: int) -> bool:
    """Whether every pointer sits on a 16-byte boundary (the tiled, mma
    and rows paths' 16-byte copies and float4 reads need it)."""
    return all(p % 16 == 0 for p in ptrs)


def launch_rows(fn: str, what: str, values, cols, x, y, r0: int, r1: int,
                *, slots: int = 1, plan: BellPlan | None = None):
    """Launch C entry ``fn`` (K11's kernel, ``slots`` 1, or P2's, 2) on
    block rows ``r0 .. r1`` of checked operands: pointer offsets into
    ``values``, ``cols`` and ``y`` (float32, ``(nbr·bs, k)``), no copies.
    ``plan`` defaults to :func:`bell_plan`'s for the shape and the
    pointers' alignment.  Returns the plan launched, or None for an empty
    ``y`` (no launch)."""
    from cgx_torch.kernels import _build

    _, wb, bs, _ = values.shape
    k = x.shape[1]
    if r1 <= r0 or k == 0:
        return None
    vp = values.data_ptr() + r0 * wb * bs * bs * values.element_size()
    yp = y.data_ptr() + r0 * bs * k * y.element_size()
    if plan is None:
        plan = bell_plan(bs, k, values.dtype,
                         operands_aligned(vp, x.data_ptr(), yp), slots=slots)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(
            vp, cols.data_ptr() + r0 * wb * cols.element_size(),
            x.data_ptr(), yp, r1 - r0, wb, bs, k,
            int(x.dtype == torch.bfloat16), PATHS.index(plan.path),
            plan.tile, plan.threads, plan.smem, *plan.grid(r1 - r0), stream)
    _build.check(rc, f"{what} launch ({plan.path} path)")
    return plan


def _launch(a: BlockELL, x: torch.Tensor, chunk: int,
            plan: BellPlan | None = None):
    """Launch K11's entry over ``a`` in chunks of ``chunk`` block rows;
    return ``Y`` (float32) and the plans launched."""
    values, cols, x = checked_operands("bell_spmm", a.values, a.block_cols,
                                       x)
    nbr, _, bs, _ = values.shape
    y = torch.empty((nbr * bs, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    plans = [launch_rows("cgx_bell_spmm", "bell_spmm", values, cols, x, y,
                         r0, min(r0 + chunk, nbr), plan=plan)
             for r0 in range(0, nbr, chunk)]
    return y, [p for p in plans if p is not None]


def bell_path_launches() -> dict:
    """K11's launches so far by path: ``{"tiled": n, "mma": n, "rows": n,
    "general": n}``."""
    return {p: globals()[f"bell_{p}_launches"] for p in PATHS}


def _k11(a: BlockELL, x: torch.Tensor,
         plan: BellPlan | None = None) -> torch.Tensor:
    """K11 on the card, one launch, counted on its path; ``plan`` forces a
    path (the tests' and the smoke's yardstick: not a :func:`bell_spmm`
    option)."""
    global bell_spmm_launches
    y, plans = _launch(a, x, max(a.values.shape[0], 1), plan)
    for p in plans:
        bell_spmm_launches += 1
        globals()[f"bell_{p.path}_launches"] += 1
    return y


def bell_spmm(a: BlockELL, x: torch.Tensor, *,
              engine: str = "auto") -> torch.Tensor:
    """``Y = A @ X`` for block-ELL ``A`` and dense ``X: (m, k)``, ``m`` =
    ``a.shape[1]``.  ``engine``: ``"auto"``, ``"resident"`` or ``"dma"``
    (K11, one launch), or ``"prefetch"`` (K12: K11's kernel once per chunk
    of :data:`PREFETCH_ROWS` block rows); all give the same ``Y``."""
    global bell_prefetch_launches
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"bell_spmm: x must be ({a.shape[1]}, k), got "
                         f"{tuple(x.shape)}")
    prefetch = engine == "prefetch"
    if x.device.type == "cpu":
        return (bell_prefetch_reference if prefetch
                else bell_spmm_reference)(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"bell_spmm: unsupported device {x.device}")
    if not prefetch:
        return _k11(a, x)
    y, plans = _launch(a, x, PREFETCH_ROWS)
    bell_prefetch_launches += len(plans)
    return y


def bell_spmv(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through the SpMM with a single right-hand side."""
    return bell_spmm(a, x[:, None])[:, 0]

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
(a wide accumulator), else ``X``'s dtype.  ``bell_spmm_launches`` counts
launches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = ["BlockELL", "bell_from_bsr", "bell_spmm", "bell_spmv",
           "bell_spmm_reference", "bell_prefetch_reference",
           "bell_spmm_launches", "bell_prefetch_launches", "MAX_BLOCKSIZE",
           "PREFETCH_ROWS"]

# Kernel launches so far (a run resets them to show that it used the kernel).
bell_spmm_launches = 0
bell_prefetch_launches = 0
# The largest block K11 takes: its shared memory holds one (bs, bs) block
# and one (bs, 64) tile of X.
MAX_BLOCKSIZE = 128
# K12's chunk of block rows (the JAX package's _MAX_PREFETCH_ROWS).
PREFETCH_ROWS = 256
_ENGINES = ("auto", "resident", "dma", "prefetch")


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


def launch_rows(fn: str, what: str, values, cols, x, y, r0: int,
                r1: int) -> int:
    """Launch C entry ``fn`` (K11's kernel or P2's) on block rows ``r0 ..
    r1`` of checked operands: pointer offsets into ``values``, ``cols``
    and ``y`` (float32, ``(nbr·bs, k)``), no copies.  Returns the number
    of launches (0 for an empty ``y``)."""
    from cgx_torch.kernels import _build

    _, wb, bs, _ = values.shape
    k = x.shape[1]
    if r1 <= r0 or k == 0:
        return 0
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(
            values.data_ptr() + r0 * wb * bs * bs * values.element_size(),
            cols.data_ptr() + r0 * wb * cols.element_size(), x.data_ptr(),
            y.data_ptr() + r0 * bs * k * y.element_size(), r1 - r0, wb, bs,
            k, int(x.dtype == torch.bfloat16), stream)
    _build.check(rc, f"{what} launch")
    return 1


def _launch(a: BlockELL, x: torch.Tensor, chunk: int):
    """Launch K11 over ``a`` in chunks of ``chunk`` block rows; return ``Y``
    (float32) and the number of launches."""
    values, cols, x = checked_operands("bell_spmm", a.values, a.block_cols,
                                       x)
    nbr, _, bs, _ = values.shape
    y = torch.empty((nbr * bs, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    launches = sum(launch_rows("cgx_bell_spmm", "bell_spmm", values, cols, x,
                               y, r0, min(r0 + chunk, nbr))
                   for r0 in range(0, nbr, chunk))
    return y, launches


def bell_spmm(a: BlockELL, x: torch.Tensor, *,
              engine: str = "auto") -> torch.Tensor:
    """``Y = A @ X`` for block-ELL ``A`` and dense ``X: (m, k)``, ``m`` =
    ``a.shape[1]``.  ``engine``: ``"auto"``, ``"resident"`` or ``"dma"``
    (K11, one launch), or ``"prefetch"`` (K12: K11's kernel once per chunk
    of :data:`PREFETCH_ROWS` block rows); all give the same ``Y``."""
    global bell_spmm_launches, bell_prefetch_launches
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
    nbr = a.values.shape[0]
    y, launches = _launch(a, x, PREFETCH_ROWS if prefetch else max(nbr, 1))
    if prefetch:
        bell_prefetch_launches += launches
    else:
        bell_spmm_launches += launches
    return y


def bell_spmv(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through the SpMM with a single right-hand side."""
    return bell_spmm(a, x[:, None])[:, 0]

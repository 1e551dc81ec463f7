"""K11: the block-ELL SpMM — the CUDA kernel and its plain version.

Counterpart of :mod:`cgx.kernels.bsr`.  :class:`BlockELL` stores every
block row as exactly ``wb`` dense ``(bs, bs)`` blocks (padding blocks are
zero and point at block column 0); :func:`bell_from_bsr` builds it from a
:class:`~cgx_torch.sparse.types.BSRMatrix`.  :func:`bell_spmm` computes
``Y = A @ X`` through K11 (``cgx_torch/csrc/bsr.cu``), which replaces both
TPU functions, ``_bell_spmm_dma`` and ``_bell_spmm_resident``: they
compute the same ``Y`` and differ only in where ``X`` sits in VMEM.  So
the engines ``"auto"``, ``"resident"`` and ``"dma"`` all launch K11, and
the VMEM and SMEM caps that chose between them on the TPU
(``_BELL_RESIDENT_VMEM_CAP``, ``_BELL_RESIDENT_MAX_IDS``,
``_MAX_PREFETCH_ROWS``) are not ported.  ``"prefetch"``, the chunked
scalar-prefetch kernel K12, is not ported yet and raises.

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
           "bell_spmm_reference", "bell_spmm_launches", "MAX_BLOCKSIZE"]

# Kernel launches so far (a run resets it to show that it used the kernel).
bell_spmm_launches = 0
# The largest block K11 takes: its shared memory holds one (bs, bs) block
# and one (bs, 64) tile of X.
MAX_BLOCKSIZE = 128
_ENGINES = ("auto", "resident", "dma")


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


def _launch(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Check the operands, launch K11 and return ``Y`` (float32)."""
    from cgx_torch.kernels import _build

    pair = (a.values.dtype, x.dtype)
    if pair not in ((torch.float32, torch.float32),
                    (torch.bfloat16, torch.bfloat16)):
        raise TypeError("bell_spmm: the CUDA kernel takes float32 values "
                        "with float32 x or bfloat16 with bfloat16, got "
                        f"{pair[0]} and {pair[1]}")
    nbr, wb, bs, _ = a.values.shape
    if bs > MAX_BLOCKSIZE:
        raise ValueError(f"bell_spmm: the CUDA kernel takes blocks up to "
                         f"{MAX_BLOCKSIZE}, got {bs}")
    if a.block_cols.dtype != torch.int32:
        raise ValueError("bell_spmm: block_cols must be int32")
    values = a.values.contiguous()
    cols = a.block_cols.contiguous()
    x = x.contiguous()
    if values.device != x.device or cols.device != x.device:
        raise ValueError(f"bell_spmm: the operands must lie on {x.device}")
    k = x.shape[1]
    y = torch.empty((nbr * bs, k), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cgx_bell_spmm(values.data_ptr(), cols.data_ptr(),
                               x.data_ptr(), y.data_ptr(), nbr, wb, bs, k,
                               int(x.dtype == torch.bfloat16), stream)
    _build.check(rc, "bell_spmm launch")
    return y


def bell_spmm(a: BlockELL, x: torch.Tensor, *,
              engine: str = "auto") -> torch.Tensor:
    """``Y = A @ X`` for block-ELL ``A`` and dense ``X: (m, k)``, ``m`` =
    ``a.shape[1]``.  ``engine``: ``"auto"``, ``"resident"`` or ``"dma"``
    (all K11 on the card); ``"prefetch"`` (K12) is not ported."""
    global bell_spmm_launches
    if engine == "prefetch":
        raise NotImplementedError(
            "bell_spmm: engine 'prefetch' (the chunked scalar-prefetch "
            "kernel) is not ported yet (ROADMAP kernel K12)")
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"bell_spmm: x must be ({a.shape[1]}, k), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return bell_spmm_reference(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"bell_spmm: unsupported device {x.device}")
    y = _launch(a, x)
    bell_spmm_launches += 1
    return y


def bell_spmv(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through the SpMM with a single right-hand side."""
    return bell_spmm(a, x[:, None])[:, 0]

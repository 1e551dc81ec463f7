"""Host-side row partitioner: global sparse matrix → per-shard operators.

Counterpart of :mod:`cgx.dist.partition`.  A :class:`Partition` holds its
arrays in numpy on the host, *stacked* along a leading shard axis as in the
JAX package; :meth:`Partition.local` moves one shard's arrays to its
device as a :class:`LocalPartition`, which the shard-local products
(:func:`cgx_torch.dist.halo.local_matvec`) read.  Two local layouts:

* **Padded ELL** (from CSR): every local row stores ``width`` (value,
  column) slots.  In ``"halo"`` mode the columns are *extended local*
  coordinates (indices into ``[left_halo | local | right_halo]``); in
  ``"allgather"`` mode they stay global.
* **Row-major DIA** (from DIA): ``data_t[i, k] = A[row_i, row_i +
  offsets[k]]``, a few shifted products on the halo-extended vector.

:func:`partition_csr` picks the plan by the JAX package's bandwidth rule:
halo exchange when the band fits one ring step and moves less than an
all-gather of the iterate, else all-gather.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Partition", "LocalPartition", "partition_csr", "partition_dia",
           "pad_vector", "unpad_vector"]


@dataclass(frozen=True)
class LocalPartition:
    """One shard's operator on its device: ``(rows_local, width)`` ELL
    values and int64 columns, or ``(rows_local, n_diags)`` DIA data, with
    the partition's static metadata and the shard's ``rank``."""

    ell_values: Optional[torch.Tensor]
    ell_cols: Optional[torch.Tensor]
    dia_data: Optional[torch.Tensor]
    dia_offsets: Tuple[int, ...]
    kind: str
    mode: str
    n: int
    n_shards: int
    rows_local: int
    halo_lo: int
    halo_hi: int
    rank: int

    @property
    def dtype(self) -> torch.dtype:
        return (self.ell_values if self.kind == "ell" else self.dia_data).dtype

    @property
    def first_row(self) -> int:
        return self.rank * self.rows_local


@dataclass(frozen=True)
class Partition:
    """Row-partitioned operator, stacked along a leading shard axis (host
    numpy arrays).  Exactly one of the ELL (``ell_values``/``ell_cols``)
    and DIA (``dia_data``) groups is set, per ``kind``."""

    ell_values: Optional[np.ndarray]     # (n_shards, rows_local, width)
    ell_cols: Optional[np.ndarray]       # int32; extended-local or global
    dia_data: Optional[np.ndarray]       # (n_shards, rows_local, n_diags)
    dia_offsets: Tuple[int, ...]
    kind: str                            # "ell" | "dia"
    mode: str                            # "halo" | "allgather"
    n: int                               # true dimension
    n_shards: int
    rows_local: int
    halo_lo: int
    halo_hi: int

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.rows_local

    @property
    def dtype(self) -> np.dtype:
        arr = self.ell_values if self.kind == "ell" else self.dia_data
        return arr.dtype

    def local(self, rank: int, device="cuda") -> LocalPartition:
        """Shard ``rank``'s arrays on ``device`` (columns as int64)."""
        from cgx_torch.sparse.types import resolve_device

        dev = resolve_device(device)

        def take(a, dtype=None):
            if a is None:
                return None
            t = torch.from_numpy(np.ascontiguousarray(a[rank]))
            return t.to(device=dev, dtype=dtype)

        return LocalPartition(
            ell_values=take(self.ell_values),
            ell_cols=take(self.ell_cols, torch.int64),
            dia_data=take(self.dia_data), dia_offsets=self.dia_offsets,
            kind=self.kind, mode=self.mode, n=self.n,
            n_shards=self.n_shards, rows_local=self.rows_local,
            halo_lo=self.halo_lo, halo_hi=self.halo_hi, rank=int(rank))


def pad_vector(x, n_padded: int):
    """Zero-pad a global vector (numpy or torch) to the shard-equalised
    length."""
    pad = n_padded - x.shape[0]
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.pad(x, (0, pad))
    return np.pad(x, (0, pad))


def unpad_vector(x, n: int):
    """Strip the shard-equalisation padding off a global vector."""
    return x[:n]


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _band_bounds(rows: np.ndarray, cols: np.ndarray) -> Tuple[int, int]:
    """(halo_lo, halo_hi): the farthest entry below and above the
    diagonal."""
    if len(rows) == 0:
        return 0, 0
    band = cols.astype(np.int64) - rows.astype(np.int64)
    return max(0, -int(band.min())), max(0, int(band.max()))


def partition_csr(a, n_shards: int, mode: str = "auto") -> Partition:
    """Partition a CSR matrix (the port's or any object with ``values``,
    ``col_indices``, ``indptr`` and ``shape``) into ``n_shards`` stacked
    padded-ELL blocks.

    ``mode``: ``"halo"`` | ``"allgather"`` | ``"auto"`` (halo exchange when
    the band fits in one ring step and moves less data than gathering the
    iterate).
    """
    vals = _host(a.values)
    cols = _host(a.col_indices)
    indptr = _host(a.indptr)
    n = int(a.shape[0])
    counts = np.diff(indptr).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)

    rl = -(-n // n_shards)               # rows per shard (ceil)
    n_padded = n_shards * rl
    hlo, hhi = _band_bounds(rows, cols)

    if mode == "auto":
        halo_ok = (max(hlo, hhi) <= rl
                   and (hlo + hhi) < (n_padded - rl))
        mode = "halo" if halo_ok else "allgather"
    if mode not in ("halo", "allgather"):
        raise ValueError(f"unknown mode {mode!r}")

    width = int(counts.max()) if n else 1
    ell_vals = np.zeros((n_padded, width), dtype=vals.dtype)
    slot = (np.concatenate([np.arange(c) for c in counts]) if len(vals)
            else np.zeros(0, dtype=np.int64))

    start = (rows // rl) * rl             # owning shard's first global row
    if mode == "halo":
        hl, hr = hlo, hhi
        loc_cols = cols.astype(np.int64) - start + hl
        if len(loc_cols) and (loc_cols.min() < 0
                              or loc_cols.max() >= hl + rl + hr):
            raise AssertionError("band bounds violated")
        own = np.arange(n_padded, dtype=np.int64) % rl + hl
    else:
        hl = hr = 0
        loc_cols = cols.astype(np.int64)
        own = np.minimum(np.arange(n_padded, dtype=np.int64), n - 1)

    ell_cols = np.tile(own[:, None], (1, width)).astype(np.int32)
    ell_vals[rows, slot] = vals
    ell_cols[rows, slot] = loc_cols.astype(np.int32)
    return Partition(
        ell_values=ell_vals.reshape(n_shards, rl, width),
        ell_cols=ell_cols.reshape(n_shards, rl, width),
        dia_data=None, dia_offsets=(), kind="ell", mode=mode, n=n,
        n_shards=n_shards, rows_local=rl, halo_lo=hl, halo_hi=hr)


def partition_dia(a, n_shards: int) -> Partition:
    """Partition a DIA operator (``data``, ``offsets``, ``shape``) into row
    shards (always halo mode): the row-aligned ``data[k, i]`` transposes
    to ``(rows, n_diags)``; the halo widths are the offsets themselves."""
    data = _host(a.data)                  # (n_diags, n)
    n = int(a.shape[0])
    rl = -(-n // n_shards)
    n_padded = n_shards * rl
    data_t = np.zeros((n_padded, data.shape[0]), dtype=data.dtype)
    data_t[:n] = data.T
    offs = tuple(int(o) for o in a.offsets)
    hl = max(0, -min(offs)) if offs else 0
    hr = max(0, max(offs)) if offs else 0
    return Partition(
        ell_values=None, ell_cols=None,
        dia_data=data_t.reshape(n_shards, rl, -1), dia_offsets=offs,
        kind="dia", mode="halo", n=n, n_shards=n_shards, rows_local=rl,
        halo_lo=hl, halo_hi=hr)

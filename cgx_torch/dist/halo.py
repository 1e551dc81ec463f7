"""Ring halo exchange, the shard-local product, and the counted collectives.

Counterpart of :mod:`cgx.dist.halo`.  Where the JAX package has
``ppermute`` ring steps and ``all_gather`` inside ``shard_map``, the port
sends and receives boundary slices with ``torch.distributed`` point-to-point
operations (NCCL on the cards, gloo on the CPU), all of an exchange in one
``batch_isend_irecv``, and gathers with ``all_gather``.

Every collective of the distributed solvers goes through this module's
:func:`p2p`, :func:`all_reduce` and :func:`all_gather`, which count what
this rank calls: ``sends``, ``recvs``, ``all_reduces`` and
``all_gathers`` (:func:`counters`, :func:`reset_counters`).  The counts are
the port's counterpart of the JAX package's checks on the compiled HLO
(no all-gather in halo mode, two reductions an iteration): a test or a
run reads them around a solve.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from cgx_torch.dist.partition import LocalPartition

__all__ = ["halo_exchange", "local_matvec", "p2p", "all_reduce",
           "sum_over", "all_gather", "counters", "reset_counters",
           "exchange_planes", "ghosted", "cut_ghost_rows", "cut_halo_rows"]

# Collectives this rank has called (point-to-point operations counted one
# by one); a caller sets them to 0 with reset_counters() and reads them.
sends = 0
recvs = 0
all_reduces = 0
all_gathers = 0


def counters() -> dict:
    """The collective counts so far."""
    return {"sends": sends, "recvs": recvs, "all_reduces": all_reduces,
            "all_gathers": all_gathers}


def reset_counters() -> None:
    global sends, recvs, all_reduces, all_gathers
    sends = recvs = all_reduces = all_gathers = 0


def _global(group, r: int) -> int:
    """The default group's rank of ``group``'s rank ``r``."""
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def p2p(ops, group=None, wait: bool = True):
    """Post point-to-point operations ``[(send, tensor, rank), ...]``
    (``send`` True for a send, False for a receive into ``tensor``;
    ``rank`` in ``group``) as one batch.  Every rank must list the
    messages between any two ranks in the same order.  Returns the works
    (already waited on when ``wait``: on the cards that orders the current
    stream after them, on the CPU it blocks)."""
    global sends, recvs
    if not ops:
        return []
    p2p_ops = []
    for is_send, t, r in ops:
        if not t.is_contiguous():
            raise ValueError("p2p: tensors must be contiguous")
        fn = dist.isend if is_send else dist.irecv
        p2p_ops.append(dist.P2POp(fn, t, _global(group, r), group))
        if is_send:
            sends += 1
        else:
            recvs += 1
    works = dist.batch_isend_irecv(p2p_ops)
    if wait:
        for w in works:
            w.wait()
    return works


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place (counted); returns ``t``."""
    global all_reduces
    dist.all_reduce(t, group=group)
    all_reduces += 1
    return t


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks (in place, counted), or ``t``
    as it is when ``group`` is None: the solvers' ``group=`` switch."""
    return t if group is None else all_reduce(t, group)


def all_gather(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x_local`` blocks concatenated in rank order (counted;
    every rank's block has the same shape)."""
    global all_gathers
    size = dist.get_world_size(group)
    x_local = x_local.contiguous()
    parts = [torch.empty_like(x_local) for _ in range(size)]
    dist.all_gather(parts, x_local, group=group)
    all_gathers += 1
    return torch.cat(parts)


def _halo_messages(nl: int, halo_lo: int, halo_hi: int):
    """The ring messages of an exchange, in one fixed order: ``(side,
    shift, lo, hi)`` — the slice ``[lo, hi)`` of the local block goes to
    rank + shift and fills part of the ``side`` halo ("left" from the
    lower ranks, "right" from the higher ones).  A halo wider than one
    block takes several ring steps: whole blocks of the nearer shards and
    the needed tail of the farthest, as the JAX package's
    ``_halo_parts``."""
    msgs = []
    if halo_lo:
        steps = -(-halo_lo // nl)
        rem = halo_lo - (steps - 1) * nl
        msgs.append(("left", steps, nl - rem, nl))
        msgs += [("left", j, 0, nl) for j in range(steps - 1, 0, -1)]
    if halo_hi:
        steps = -(-halo_hi // nl)
        rem = halo_hi - (steps - 1) * nl
        msgs += [("right", -j, 0, nl) for j in range(1, steps)]
        msgs.append(("right", -steps, 0, rem))
    return msgs


def _post_halo(x_local: torch.Tensor, halo_lo: int, halo_hi: int, mesh):
    """Post the ring exchange; ``(works, left_parts, right_parts)``, the
    parts in halo order (filled once the works are waited on)."""
    nl = x_local.shape[0]
    size, rank = mesh.size, mesh.rank
    ops, left, right = [], [], []
    for side, shift, lo, hi in _halo_messages(nl, halo_lo, halo_hi):
        part = x_local[lo:hi]
        to, frm = (rank + shift) % size, (rank - shift) % size
        if to == rank:                    # a ring step onto this shard
            buf = part.clone()
        else:
            buf = torch.empty_like(part)
            ops.append((True, part.contiguous(), to))
            ops.append((False, buf, frm))
        (left if side == "left" else right).append(buf)
    return p2p(ops, mesh.group, wait=False), left, right


def _wait(works) -> None:
    for w in works:
        w.wait()


def halo_exchange(x_local: torch.Tensor, halo_lo: int, halo_hi: int,
                  mesh) -> torch.Tensor:
    """``[left_halo | x_local | right_halo]`` by ring exchange.

    ``left_halo`` is the last ``halo_lo`` entries of the preceding ranks,
    ``right_halo`` the first ``halo_hi`` entries of the following ones,
    cyclically: rank 0's left halo comes from the last rank, as the JAX
    package's ring gives (harmless: a banded matrix never reads those
    slots).  ``mesh``: a :class:`~cgx_torch.dist.launch.RowMesh`."""
    works, left, right = _post_halo(x_local, halo_lo, halo_hi, mesh)
    _wait(works)
    return torch.cat(left + [x_local] + right)


def cut_halo_rows(v: torch.Tensor, rank: int, size: int, halo_lo: int,
                  halo_hi: int) -> torch.Tensor:
    """Shard ``rank`` of ``size``' rows of the whole ``v`` (dim 0, equal
    blocks) with its halos cut from the other shards' rows, cyclically:
    what :func:`halo_exchange` gives that shard, with no traffic."""
    nl = v.shape[0] // size
    idx = torch.arange(rank * nl - halo_lo, (rank + 1) * nl + halo_hi,
                       device=v.device) % v.shape[0]
    return v[idx]


def local_matvec(a_loc: LocalPartition, x_local: torch.Tensor, mesh,
                 overlap: bool = True) -> torch.Tensor:
    """``(A x)`` on this rank's rows.

    All-gather mode: one all-gather of the iterate.  Halo mode: the ring
    exchange of ``halo_lo + halo_hi`` entries; with ``overlap`` the
    receives are posted first, the interior rows (those that read only
    ``x_local``) computed while they travel, then the boundary rows.
    Each row's products and sums are the same in every mode, so the
    result does not depend on ``overlap``."""
    hl, hr = a_loc.halo_lo, a_loc.halo_hi
    if a_loc.mode != "halo":
        x_ext = all_gather(x_local, mesh.group)
        return torch.sum(a_loc.ell_values * x_ext[a_loc.ell_cols], dim=1)

    rl = x_local.shape[0]
    if not overlap or hl + hr >= rl or (hl == 0 and hr == 0):
        x_ext = halo_exchange(x_local, hl, hr, mesh)
        return _rows_matvec(a_loc, x_ext, 0, rl, hl)
    works, left, right = _post_halo(x_local, hl, hr, mesh)
    y_mid = _rows_matvec(a_loc, x_local, hl, rl - hr, 0)
    _wait(works)
    x_ext = torch.cat(left + [x_local] + right)
    y_top = _rows_matvec(a_loc, x_ext, 0, hl, hl)
    y_bot = _rows_matvec(a_loc, x_ext, rl - hr, rl, hl)
    return torch.cat([y_top, y_mid, y_bot])


def _rows_matvec(a_loc: LocalPartition, x_src: torch.Tensor, r0: int,
                 r1: int, base: int) -> torch.Tensor:
    """Rows ``[r0, r1)`` of the local product against ``x_src``, where
    extended column ``c`` is ``x_src[c − halo_lo + base]`` (``base`` is
    ``halo_lo`` for the extended vector, 0 for the bare local block)."""
    hl = a_loc.halo_lo
    nrows = r1 - r0
    if nrows <= 0:
        return torch.zeros(0, dtype=x_src.dtype, device=x_src.device)
    if a_loc.kind == "ell":
        vals = a_loc.ell_values[r0:r1]
        cols = a_loc.ell_cols[r0:r1] - (hl - base)
        return torch.sum(vals * x_src[cols], dim=1)
    data = a_loc.dia_data[r0:r1]
    y = torch.zeros(nrows, dtype=x_src.dtype, device=x_src.device)
    for k, off in enumerate(a_loc.dia_offsets):
        start = r0 + off + base
        y = y + data[:, k] * x_src[start:start + nrows]
    return y


def exchange_planes(buf: torch.Tensor, plane: int, rank: int, size: int,
                    group=None) -> None:
    """Fill the ghost x-planes of a shard's extended buffer from its
    neighbours, in place: the last axis of ``buf`` is ``[ghost | local
    planes | ghost]``, ``plane`` elements a plane.  Not a ring: the first
    and last ranks keep their outer ghost planes (zeros).  The fused
    engines (K3 and K5) call it before each kernel A."""
    if size == 1:
        return
    n_ext = buf.shape[-1]
    ops: List[Tuple[bool, torch.Tensor, int]] = []
    recv: List[Tuple[torch.Tensor, slice]] = []
    flat = buf.dim() == 1

    def piece(sl):
        return buf[..., sl] if flat else buf[..., sl].contiguous()

    if rank > 0:
        ops.append((True, piece(slice(plane, 2 * plane)), rank - 1))
        lo = piece(slice(0, plane)) if flat else torch.empty(
            buf.shape[:-1] + (plane,), dtype=buf.dtype, device=buf.device)
        ops.append((False, lo, rank - 1))
        recv.append((lo, slice(0, plane)))
    if rank < size - 1:
        ops.append((True, piece(slice(n_ext - 2 * plane, n_ext - plane)),
                    rank + 1))
        hi = piece(slice(n_ext - plane, n_ext)) if flat else torch.empty(
            buf.shape[:-1] + (plane,), dtype=buf.dtype, device=buf.device)
        ops.append((False, hi, rank + 1))
        recv.append((hi, slice(n_ext - plane, n_ext)))
    p2p(ops, group)
    if not flat:
        for t, sl in recv:
            buf[..., sl].copy_(t)


def ghosted(v: torch.Tensor, plane: int, rank: int, size: int,
            group: Optional[object] = None) -> torch.Tensor:
    """``v`` (the last axis a shard's rows) with a ghost x-plane on each
    side filled from the neighbours over ``group`` (zeros at the outer
    ranks): the extended layout the fused engines read."""
    shape = v.shape[:-1] + (v.shape[-1] + 2 * plane,)
    buf = torch.zeros(shape, dtype=v.dtype, device=v.device)
    buf[..., plane:plane + v.shape[-1]] = v
    exchange_planes(buf, plane, rank, size, group)
    return buf


def cut_ghost_rows(v: torch.Tensor, rank: int, size: int,
                   plane: int) -> torch.Tensor:
    """Shard ``rank`` of ``size``' rows of the whole-grid ``v`` (its last
    axis) in the same extended layout, the ghost x-planes (``plane``
    elements each) cut from the neighbouring shards' rows, zeros past the
    grid: what :func:`ghosted` fills, with no traffic.  The builders cut a
    shard's coefficient planes so (every rank holds the whole operator)."""
    nl = v.shape[-1] // size
    lo = rank * nl
    ext = torch.zeros(v.shape[:-1] + (nl + 2 * plane,), dtype=v.dtype,
                      device=v.device)
    ext[..., plane:plane + nl] = v[..., lo:lo + nl]
    if rank > 0:
        ext[..., :plane] = v[..., lo - plane:lo]
    if rank < size - 1:
        ext[..., plane + nl:] = v[..., lo + nl:lo + nl + plane]
    return ext.contiguous()

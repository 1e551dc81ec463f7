"""K5: the two-pass CG engine over k right-hand sides — CUDA kernels A and B,
their plain versions, and the multi-RHS fused solvers.

Counterpart of :mod:`cgx.kernels.fused_multi` (``_solve_multi``,
``fused_stencil_cg_multi``, ``fused_dia_cg_multi``).  Per iteration, for
every column j of the block:

  A. ``q_j = Ã p_j`` with ``Σ p_j·q_j`` and ``Σ q_j·q_j``;
  B. ``live = rz_j > 0 and pq_j > 0``, ``α = live ? rz/pq : 0``,
     ``β = live ? (α²·qq − rz)/rz : 0``, then ``x += αp``, ``r −= αq``,
     ``p = r + βp`` with ``Σ r_j²`` and ``Σ r_j²·w`` (one weight vector for
     all columns).

The iteration count is shared: the loop runs until every column meets its
tolerance (or ``maxiter``), and a column that has converged keeps iterating
with the others; only a column whose ``rz`` or ``pq`` reaches 0 is frozen.
``iterations`` is the shared count broadcast to ``(k,)``; the residuals and
``converged`` are per column.  The sums are taken exactly, as K3 takes them
(:mod:`cgx_torch.kernels.fused_engine`): a column of K5 rounds as K3 rounds
it, so the column that exits last follows its single-RHS solve.

The port keeps the block as k flat columns, ``(k, n)`` contiguous (the JAX
package's ``b.T``).  The band-stacked TPU layout (``_to_layout_multi``, the
``bps`` band tiling, VMEM limits) is not ported.  Distribution
(``_exchange_multi`` and the psums of ``_solve_multi``) is K3's
(:mod:`cgx_torch.kernels.fused_engine`): ``group=`` makes the engine a
rank's block of x-planes, P's columns carry a ghost plane on each side
(filled from the neighbour ranks before each kernel A), and the per-column
sums are reduced over the ranks in fp64, once after each kernel.
``plane_dtype=torch.bfloat16`` holds the shared planes in
bf16 (the vectors stay float32); kernel A widens each plane value as it
loads it, so that mode equals the float32 mode on the planes rounded
through bf16, bit for bit.

On a CUDA tensor :meth:`FusedCGMulti.run` launches kernel A and kernel B of
``cgx_torch/csrc/fused_multi.cu`` once per iteration from a Python loop,
with α, β and the shared exit on the device; the host reads one flag per
:data:`~cgx_torch.kernels.fused_engine.CHUNK` iterations.  On a CPU tensor
it takes the plain version, :meth:`FusedCGMulti.run_reference`.
``multi_a_launches`` and ``multi_b_launches`` count the kernels' launches.

Kernel A (``multi_a2``) marches tiles of the grid along x through shared
memory (:func:`march_plan`; :func:`march_reference` mirrors it on the CPU):
q equals the plain version's bit for bit, the sums are taken in the
march's own fixed order.  An operator whose taps reach too far in y or z
for a block's shared memory (:attr:`FusedCGMulti.march` is None) runs the
first kernel A (``multi_a``), which reads its neighbours from global
memory; elsewhere the first kernel A is the same-run "before"
(:func:`_before_kernel_a`, :func:`_before_solve`, counted nowhere).
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from cgx_torch.kernels import _build
from cgx_torch.kernels.fused_cg import stencil_taps, supports
from cgx_torch.kernels.fused_dia_cg import (dia_prep,
                                            wrap_entries_zero_or_none)
from cgx_torch.kernels.fused_engine import (CHUNK, FusedCG, Shard, allsum,
                                            bsq_sum, clamp_threshold,
                                            exact_sums, plane_tap_arrays,
                                            sums64)
from cgx_torch.ops.blas import safe_recip
from cgx_torch.solve.cg import CGResult
from cgx_torch.utils.profiling import (ENGINE, PREP, RESULT, annotate,
                                       host_read)

__all__ = ["FusedCGMulti", "FusedMultiState", "MarchPlan", "march_plan",
           "march_reference", "thresholds",
           "fused_stencil_cg_multi", "fused_dia_cg_multi",
           "multi_a_launches", "multi_b_launches", "multi_a_bf16_launches"]

# Kernel launches so far (a run resets them to show which kernels it used);
# multi_a_bf16_launches counts kernel A's bf16-plane mode among them.
multi_a_launches = 0
multi_b_launches = 0
multi_a_bf16_launches = 0

# The device control block (fused_multi.cu): header words, then five float
# arrays of k columns in this order.
_IT, _DONE, _MAXIT, _HEAD = 0, 1, 2, 8
_RZ, _RW, _PQ, _QQ, _TOL = range(5)

# Kernel A's designs in fused_multi.cu: the first kernel A (multi_a) and
# the march (multi_a2).
_FIRST_DESIGN, _MARCH = 0, 1

# Kernel A's march: threads a block, columns a pass, the x-planes a block
# marches over when the card is not known, and csrc/fused_multi.cu's build
# knobs: the ring's slots of staged x-planes (kSlots), the nodes a thread
# takes in a plane (kRows) and the blocks an SM (kBlocksPerSm); the shared
# memory a block may take (the H100's 227 KB).
TILE_THREADS = 256
COLS = 4
MARCH_LEN = 16
MARCH_SLOTS = 4
MARCH_ROWS = 2
MARCH_BLOCKS_PER_SM = 4
SMEM_LIMIT = 232448


@dataclass(frozen=True)
class MarchPlan:
    """The tiles of kernel A's march (``cgx::MarchPlan``): ``tj`` lines of
    ``tk`` nodes a block, ``rows`` of them a thread (``tj / rows`` lines
    apart), ``length`` x-planes, staged halos ``hj`` lines and ``hk`` nodes
    (a multiple of 4) on each side."""

    tj: int
    tk: int
    rows: int
    length: int
    hj: int
    hk: int
    tiles_j: int
    tiles_k: int
    chunks: int

    @property
    def grid(self) -> int:
        return self.tiles_j * self.tiles_k * self.chunks

    @property
    def smem_bytes(self) -> int:
        """The ring: MARCH_SLOTS slots of COLS columns' staged x-planes,
        fp32."""
        return (MARCH_SLOTS * COLS * (self.tj + 2 * self.hj)
                * (self.tk + 2 * self.hk) * 4)


def march_plan(nx: int, ny: int, nz: int, taps, tj: Optional[int] = None,
               length: Optional[int] = None,
               blocks: Optional[int] = None) -> MarchPlan:
    """Kernel A's tiles for an nx × ny × nz grid and its taps: by default
    ``tj`` = 2 × min(8, the power of two at or above ``ny``) lines of
    ``512 / tj`` nodes, :data:`MARCH_ROWS` (2) nodes a thread; the halos
    the largest ``|dy|`` and ``|dk|`` (rounded up to 4).  The planes a
    block marches over: ``length``, else as many as let the tiles × chunks
    fill ``blocks`` (the blocks the card runs at once) in one wave, else
    :data:`MARCH_LEN`."""
    rows = MARCH_ROWS
    if tj is None:
        tj = rows * min(8, 1 << max(ny - 1, 0).bit_length())
    if tj % rows or TILE_THREADS % (tj // rows):
        raise ValueError(f"march_plan: tj={tj} lines in {rows} rows a "
                         f"thread do not tile {TILE_THREADS} threads")
    tk = TILE_THREADS * rows // tj
    tiles = -(-ny // tj) * -(-nz // tk)
    if length is None:
        length = (MARCH_LEN if blocks is None
                  else -(-nx // max(1, blocks // tiles)))
    length = min(int(length), nx)
    if tk % 4 or length < 1:
        raise ValueError(f"march_plan: tk={tk} (a multiple of 4) and "
                         f"length={length} (>= 1)")
    hj = max(abs(dy) for _, dy, _ in taps)
    hk = -(-max(abs(dk) for _, _, dk in taps) // 4) * 4
    plan = MarchPlan(tj=tj, tk=tk, rows=rows, length=length, hj=hj, hk=hk,
                     tiles_j=-(-ny // tj), tiles_k=-(-nz // tk),
                     chunks=-(-nx // length))
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"fused multi kernel A: taps reaching {hj} lines "
                         f"and {hk} nodes need {plan.smem_bytes} bytes of "
                         f"shared memory a block, more than {SMEM_LIMIT}")
    return plan


def march_block(plan: MarchPlan, b: int, nx: int):
    """Block ``b``'s tile and chunk as the kernel takes them (k tiles
    fastest, then j tiles, then chunks): ``(i0, i1, j0, k0)``, planes
    ``i0 … i1 − 1``."""
    tkx = b % plan.tiles_k
    tjx = (b // plan.tiles_k) % plan.tiles_j
    ic = b // (plan.tiles_k * plan.tiles_j)
    i0 = ic * plan.length
    return i0, min(i0 + plan.length, nx), tjx * plan.tj, tkx * plan.tk


def march_flat(plan: MarchPlan, ny: int, nz: int, ip, j0: int, k0: int,
               line, elem):
    """The flat index the kernel copies into element ``elem`` of staged
    line ``line`` of x-plane ``ip`` of a block at ``(j0, k0)``."""
    return (ip * ny + j0 - plan.hj + line) * nz + k0 - plan.hk + elem


def march_reference(eng, p: torch.Tensor, plan: MarchPlan):
    """Kernel A's march on the CPU: ``(Q, Σ p·q, Σ q·q)``.  Block by block
    (tile and chunk) the x-planes i0 − 1 … i1 of the tile and its halo are
    copied from ``p`` by flat index as the kernel stages them (elements
    outside ``[0, n)`` left NaN, so a read there shows), each row's taps
    are read from that stage at (dx, dy, dk) from the node with the first
    kernel A's masks, products and sums in tap order, and each node sums its
    rows in fp64 along the march (the block tree and the fold are plain
    fp64 sums here).  On a shard ``p`` is the extended block (ghost planes
    on each side) and the stage and the masks take the shard's span
    (:meth:`~cgx_torch.kernels.fused_engine.FusedCG.span`), as the
    kernel's do: a chunk at the first or last local plane stages the
    ghost plane."""
    n, nx, ny, nz = eng.n, eng.nx, eng.ny, eng.nz
    k = p.shape[0]
    lo, hi, xlo, xhi, _ = eng.span()
    p_base = 0 if eng.shard is None else eng.plane
    if eng.planes_ext is not None:
        planes, w_base = eng.planes_ext.float(), eng.plane
    else:
        planes, w_base = (None if eng.planes is None
                          else eng.planes.float()), 0
    sym = eng.sym
    q = torch.empty((k, n), dtype=p.dtype)
    pq = torch.zeros(k, dtype=torch.float64)
    qq = torch.zeros(k, dtype=torch.float64)
    lines, width = plan.tj + 2 * plan.hj, plan.tk + 2 * plan.hk
    jx = torch.arange(plan.tj)[:, None]
    kx = torch.arange(plan.tk)[None, :]
    pl_index, pi = [], 0
    for c in eng.coeffs:
        pl_index.append(None if c is not None else pi)
        pi += c is None
    for b in range(plan.grid):
        i0, i1, j0, k0 = march_block(plan, b, nx)
        ii = torch.arange(i0, i1)[:, None, None]
        # The stage: planes i0 - 1 .. i1, lines, elements.
        flat = march_flat(plan, ny, nz,
                          torch.arange(i0 - 1, i1 + 1)[:, None, None],
                          j0, k0, torch.arange(lines)[None, :, None],
                          torch.arange(width)[None, None, :])
        inside = (flat >= lo) & (flat < hi)
        stage = torch.full((k,) + tuple(flat.shape), float("nan"))
        stage[:, inside] = p[:, flat[inside] + p_base]
        j = j0 + jx
        kk = k0 + kx
        row = (ii * ny + j) * nz + kk
        live = ((j < ny) & (kk < nz)).expand(row.shape)

        def at(dx, dy, dk):
            return stage[:, ii - i0 + 1 + dx, jx + plan.hj + dy,
                         kx + plan.hk + dk]

        acc = torch.zeros((k,) + tuple(row.shape))
        for t, ((dx, dy, dk), c) in enumerate(zip(eng.taps,
                                                  eng.coeffs)):
            ok = ((ii + dx >= xlo) & (ii + dx < xhi) & (j + dy >= 0)
                  & (j + dy < ny) & (kk + dk >= 0) & (kk + dk < nz))
            if c is not None:
                x = at(dx, dy, dk)
                if planes is None:
                    acc = torch.where(ok, acc + c * x, acc)
                elif dx == 0 and dy == 0 and dk == 0:
                    acc = acc + c * x
                else:
                    acc = acc + torch.where(ok, c * x, 0.0)
                continue
            w = planes[pl_index[t]]
            off = (dx * ny + dy) * nz + dk
            fwd = (row + off >= lo) & (row + off < hi)
            rc = row.clamp(0, n - 1) + w_base
            term = torch.where(fwd, w[rc] * at(dx, dy, dk), 0.0)
            if sym and off != 0:
                m = row - off
                mir = (m >= lo) & (m < hi)
                term = torch.where(
                    mir, term + w[m.clamp(lo, hi - 1) + w_base]
                    * at(-dx, -dy, -dk), term)
            acc = acc + term
        q[:, row[live]] = acc[:, live]
        qd = acc.double()
        pd = at(0, 0, 0).double()
        pq += torch.where(live, qd * pd, 0.0).sum(dim=(1, 2, 3))
        qq += torch.where(live, qd * qd, 0.0).sum(dim=(1, 2, 3))
    return q, pq.float(), qq.float()


def thresholds(b: torch.Tensor, tol: float, atol: float,
               weight: Optional[torch.Tensor] = None,
               shard: Optional[Shard] = None) -> torch.Tensor:
    """Per column of ``b`` (``(k, n)``) the single-RHS exit threshold
    :func:`~cgx_torch.kernels.fused_engine.threshold`, ``(k,)`` fp32 (on a
    shard of a group, the k sums summed over the ranks at once)."""
    s = torch.stack([bsq_sum(b[j], weight) for j in range(b.shape[0])])
    return clamp_threshold(allsum(s, shard), tol, atol)


def _col_sums64(r: torch.Tensor, weight) -> torch.Tensor:
    """``(2, k)`` fp64: each column's :func:`sums64`."""
    return torch.stack([sums64(r[j], weight) for j in range(r.shape[0])],
                       dim=1)


@dataclass(frozen=True, eq=False)
class FusedMultiState:
    """CG state of the engine for k columns (the chunk unit of
    init/run/result)."""

    x: torch.Tensor    # (k, n)
    r: torch.Tensor    # (k, n)
    p: torch.Tensor    # (k, n)
    rz: torch.Tensor   # (2, k) fp32: [solve-space Σr̃², weighted Σr̃²·w]
    k: torch.Tensor    # int32, shared by the columns


class FusedCGMulti(FusedCG):
    """The two-pass solver for one operator and a block of right-hand
    sides, in the solve space.  Constructed as
    :class:`~cgx_torch.kernels.fused_engine.FusedCG` (taps, constant
    coefficients or planes, ``weight``, ``sym``); ``matvec`` is the plain
    operator on one column.  Blocks are ``(k, n)``: row j is column j."""

    # -- the two kernels -------------------------------------------------

    def kernel_a_ext_reference(self, p_ext: torch.Tensor):
        """Plain kernel A of a shard: ``(Q, [Σ p·q, Σ q·q])`` from the
        extended block ``(k, n + 2·ny·nz)``, the sums ``(2, k)`` this
        rank's, fp64 and unrounded, each column as K3's."""
        cols = [FusedCG.kernel_a_ext_reference(self, p_ext[j])
                for j in range(p_ext.shape[0])]
        return (torch.stack([c[0] for c in cols]),
                torch.stack([c[1] for c in cols], dim=1))

    def kernel_b_ext_reference(self, rz, sums_a, x, r, p, q):
        """Plain kernel B of a shard: p·q and q·q from ``sums_a`` (``(2,
        k)`` fp64, summed over the ranks) rounded once, then
        :meth:`kernel_b_reference`'s update; ``(X', R', P', (2, k) sums)``,
        the sums this rank's, fp64 and unrounded."""
        x, r, p = self._update_reference(rz, sums_a[0].float(),
                                         sums_a[1].float(), x, r, p, q)
        return x, r, p, _col_sums64(r, self.weight)

    def kernel_a_reference(self, p: torch.Tensor):
        """Plain kernel A: ``(Q, Σ p·q, Σ q·q)``, the sums ``(k,)`` exact
        to fp32, each column as K3's plain version computes it (on a shard
        of a group: the ghost planes of the block exchanged at once, the
        sums summed over the ranks)."""
        if self.shard is not None:
            q, s = self.kernel_a_ext_reference(self.ghosted(p))
            s = allsum(s, self.shard).float()
            return q, s[0], s[1]
        cols = [FusedCG.kernel_a_reference(self, p[j])
                for j in range(p.shape[0])]
        return (torch.stack([c[0] for c in cols]),
                torch.stack([c[1] for c in cols]),
                torch.stack([c[2] for c in cols]))

    def kernel_b_reference(self, rz, pq, qq, x, r, p, q):
        """Plain kernel B: ``(X', R', P', Σ r'², Σ r'²·w)``, the sums
        ``(k,)``; a column with ``rz`` or ``pq`` at 0 is frozen.  On a
        shard of a group the sums are summed over the ranks."""
        x, r_new, p_new = self._update_reference(rz, pq, qq, x, r, p, q)
        if self.shard is not None:
            s = allsum(_col_sums64(r_new, self.weight), self.shard).float()
            return x, r_new, p_new, s[0], s[1]
        sums = [exact_sums(r_new[j], self.weight) for j in range(x.shape[0])]
        return (x, r_new, p_new,
                torch.stack([s[0] for s in sums]),
                torch.stack([s[1] for s in sums]))

    def _update_reference(self, rz, pq, qq, x, r, p, q):
        """Kernel B's update with the live freeze: ``(X', R', P')``."""
        zero = torch.zeros_like(rz)
        one = torch.ones_like(rz)
        live = (rz > 0) & (pq > 0)
        alpha32 = torch.where(live, rz / torch.where(pq > 0, pq, one), zero)
        beta = torch.where(live, (alpha32 * alpha32 * qq - rz)
                           / torch.where(rz > 0, rz, one), zero)
        alpha = alpha32.to(x.dtype)[:, None]
        beta = beta.to(p.dtype)[:, None]
        x = x + alpha * p
        r_new = r - alpha * q
        return x, r_new, r_new + beta * p

    def kernel_a(self, p: torch.Tensor):
        """Kernel A once: ``(Q, Σ p·q, Σ q·q)``.  A CPU tensor takes the
        plain version; on a CUDA tensor the sums are the kernel's own."""
        if p.device.type == "cpu":
            return self.kernel_a_reference(p)
        if self.shard is not None:
            q, s = self.kernel_a_ext(self.ghosted(p))
            s = allsum(s, self.shard).float()
            return q, s[0], s[1]
        return self._kernel_a_call(p, self.a_design(), count=True)

    def kernel_a_ext(self, p_ext: torch.Tensor):
        """Kernel A of a shard once, in the cross-rank mode, from the
        extended block ``(k, n + 2·ny·nz)`` (ghost planes filled): ``(Q,
        (2, k) sums)``, the sums this rank's, fp64 and unrounded.  A CPU
        tensor takes the plain version."""
        if p_ext.device.type == "cpu":
            return self.kernel_a_ext_reference(p_ext)
        k, dev = p_ext.shape[0], p_ext.device
        x_like = torch.empty((k, self.n), dtype=p_ext.dtype, device=dev)
        design = self.a_design()
        lib, ga, _ = self._setup(x_like, design)
        self._check_ext(p_ext, k)
        ctl, _ = self._ctl(k, dev)
        ctl[_MAXIT] = 2 ** 31 - 1
        part = torch.empty(2 * k * ga, dtype=torch.float64, device=dev)
        sums = torch.zeros(4 * k, dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            self._launch_a(lib, self._a_args(
                self._interior(p_ext), x_like, part, ga, ctl, design,
                ldp=p_ext.shape[1], sums=sums))
        return x_like, sums[:2 * k].reshape(2, k).clone()

    def kernel_b_ext(self, rz, sums_a, x, r, p, q):
        """Kernel B of a shard once, in the cross-rank mode, on copies of
        ``X, R, P``: p·q and q·q from ``sums_a`` (``(2, k)`` fp64, summed
        over the ranks); ``(X', R', P', (2, k) sums)``, the sums this
        rank's, fp64 and unrounded.  A CPU tensor takes the plain
        version."""
        if x.device.type == "cpu":
            return self.kernel_b_ext_reference(rz, sums_a, x, r, p, q)
        lib, _, gb = self._setup(x, self.a_design())
        k, dev = x.shape[0], x.device
        x, r, p = x.clone(), r.clone(), p.clone()
        ctl, f = self._ctl(k, dev)
        self._field(f, _RZ).copy_(torch.as_tensor(rz, dtype=torch.float32,
                                                  device=dev))
        ctl[_MAXIT] = 2 ** 31 - 1
        sums = torch.zeros(4 * k, dtype=torch.float64, device=dev)
        sums[:2 * k] = sums_a.reshape(-1).to(device=dev, dtype=torch.float64)
        part = torch.empty(2 * k * gb, dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            self._launch_b(lib, self._b_args(x, r, p, q, part, gb, ctl,
                                             sums=sums))
        return x, r, p, sums[2 * k:].reshape(2, k).clone()

    def _interior(self, p_ext: torch.Tensor) -> torch.Tensor:
        """The first local row of column 0 of an extended block (a view
        that the C entries read with P's column stride)."""
        return p_ext[:, self.plane:]

    def _check_ext(self, p_ext: torch.Tensor, k: int) -> None:
        if (tuple(p_ext.shape) != (k, self.n + 2 * self.plane)
                or not p_ext.is_contiguous()
                or p_ext.dtype != torch.float32):
            raise ValueError(f"FusedCGMulti: expected a contiguous float32 "
                             f"block ({k}, {self.n + 2 * self.plane}) in "
                             f"the ghost layout, got {tuple(p_ext.shape)}")

    def _kernel_a_call(self, p: torch.Tensor, design: int, count: bool):
        """One launch of kernel A in ``design`` (counted if ``count``):
        ``(Q, Σ p·q, Σ q·q)``."""
        lib, ga, _ = self._setup(p, design)
        q = torch.empty_like(p)
        ctl, f = self._ctl(p.shape[0], p.device)
        part = torch.empty(2 * p.shape[0] * ga, dtype=torch.float64,
                           device=p.device)
        with torch.cuda.device(p.device):
            self._launch_a(lib, self._a_args(p, q, part, ga, ctl, design),
                           count=count)
        return q, self._field(f, _PQ).clone(), self._field(f, _QQ).clone()

    def kernel_b(self, rz, pq, qq, x, r, p, q):
        """Kernel B once on copies of ``X, R, P``: ``(X', R', P', Σ r'²,
        Σ r'²·w)``.  A CPU tensor takes the plain version."""
        if x.device.type == "cpu":
            return self.kernel_b_reference(rz, pq, qq, x, r, p, q)
        lib, _, gb = self._setup(x, self.a_design())
        k, dev = x.shape[0], x.device
        x, r, p = x.clone(), r.clone(), p.clone()
        ctl, f = self._ctl(k, dev)
        for fld, v in ((_RZ, rz), (_PQ, pq), (_QQ, qq)):
            self._field(f, fld).copy_(torch.as_tensor(v, dtype=torch.float32,
                                                      device=dev))
        ctl[_MAXIT] = 2 ** 31 - 1
        part = torch.empty(2 * k * gb, dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            self._launch_b(lib, self._b_args(x, r, p, q, part, gb, ctl))
        return (x, r, p, self._field(f, _RZ).clone(),
                self._field(f, _RW).clone())

    # -- chunked-stepping primitives -------------------------------------

    def init(self, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None) -> FusedMultiState:
        """Initial state from the solve-space block ``b`` (``(k, n)``);
        ``x0`` goes through kernel A (``R₀ = B − Ã·X₀``)."""
        return self._init(b, x0, self.kernel_a)

    def _init(self, b, x0, kernel_a) -> FusedMultiState:
        b = b.to(self.dtype).contiguous()
        if x0 is None:
            x, r = torch.zeros_like(b), b
        else:
            x = x0.to(self.dtype).contiguous().clone()
            r = b - kernel_a(x)[0]
        if self.shard is not None:
            rz = allsum(_col_sums64(r, self.weight), self.shard).float()
        else:
            sums = [exact_sums(r[j], self.weight) for j in range(b.shape[0])]
            rz = torch.stack([torch.stack([s[0] for s in sums]),
                              torch.stack([s[1] for s in sums])])
        return FusedMultiState(x=x, r=r, p=r, rz=rz,
                               k=torch.zeros((), dtype=torch.int32,
                                             device=b.device))

    def run(self, state: FusedMultiState, upto: int,
            tol_sq) -> FusedMultiState:
        """Advance until ``k == upto`` or every column's weighted
        ``Σr²·w ≤ tol_sq`` (``(k,)``).  A CPU state takes the plain
        version."""
        if state.x.device.type == "cpu":
            return self.run_reference(state, upto, tol_sq)
        return self._run_cuda(state, int(upto), tol_sq)

    def run_reference(self, state: FusedMultiState, upto: int,
                      tol_sq) -> FusedMultiState:
        """Plain version of :meth:`run`: the same two passes as a Python
        loop with one host read per iteration (any device)."""
        x, r, p = state.x, state.r, state.p
        rz, rw = state.rz[0], state.rz[1]
        with annotate(ENGINE):
            k = host_read(state.k, int)
            while k < upto and host_read(torch.any(rw > tol_sq), bool):
                q, pq, qq = self.kernel_a_reference(p)
                x, r, p, rz, rw = self.kernel_b_reference(rz, pq, qq, x, r,
                                                          p, q)
                k += 1
        return FusedMultiState(x=x, r=r, p=p, rz=torch.stack([rz, rw]),
                               k=torch.tensor(k, dtype=torch.int32,
                                              device=x.device))

    def result(self, state: FusedMultiState, tol_sq) -> CGResult:
        """Package a :class:`CGResult`: ``x`` is ``(n, k)`` (a view of the
        ``(k, n)`` block), ``iterations`` the shared count as ``(k,)`` (a
        ``cgx.result`` span)."""
        k = state.x.shape[0]
        with annotate(RESULT):
            return CGResult(x=state.x.T,
                            iterations=state.k.reshape(1).expand(k).clone(),
                            residual_norm_sq=state.rz[1],
                            converged=state.rz[1] <= tol_sq,
                            history=torch.zeros(0, dtype=torch.float32,
                                                device=state.x.device))

    # -- monolithic solve ---------------------------------------------------

    def solve(self, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
              atol: float = 0.0, maxiter: int = 1000) -> CGResult:
        """Batched CG on the solve-space block ``b`` (``(k, n)``; the
        caller applies any scaling)."""
        return self._solve(b, x0, tol, atol, maxiter, self.kernel_a,
                           self.run)

    def solve_reference(self, b: torch.Tensor, x0=None, *,
                        tol: float = 1e-6, atol: float = 0.0,
                        maxiter: int = 1000) -> CGResult:
        """:meth:`solve` through the plain versions only (any device)."""
        return self._solve(b, x0, tol, atol, maxiter,
                           self.kernel_a_reference, self.run_reference)

    def _solve(self, b, x0, tol, atol, maxiter, kernel_a, run) -> CGResult:
        with annotate(PREP):
            tol_sq = thresholds(b, tol, atol, self.weight, self.shard)
            st = self._init(b, x0, kernel_a)
        st = run(st, int(maxiter), tol_sq)
        return self.result(st, tol_sq)

    # -- the CUDA path --------------------------------------------------------

    @property
    def march(self) -> Optional[MarchPlan]:
        """Kernel A's tiles: :func:`march_plan` of the grid and taps, with
        :data:`MARCH_ROWS` nodes a thread, its chunks filling the current
        CUDA card's blocks in one wave; None when the taps' halo does not
        fit a block's shared memory (the only refusal of the default
        tiles)."""
        if "_march" not in self.__dict__:
            blocks = None
            if torch.cuda.is_available():
                sms = torch.cuda.get_device_properties(
                    torch.cuda.current_device()).multi_processor_count
                blocks = MARCH_BLOCKS_PER_SM * sms
            try:
                self._march = march_plan(self.nx, self.ny, self.nz,
                                         self.taps, blocks=blocks)
            except ValueError:
                self._march = None
        return self._march

    def a_design(self) -> int:
        """Kernel A's design on the card, by the operator's shape: the
        march where :attr:`march` stages the taps, else the first kernel
        A."""
        return _FIRST_DESIGN if self.march is None else _MARCH

    def _setup(self, v: torch.Tensor, design: int,
               plan: Optional[MarchPlan] = None):
        """Checks, the library and the grids ``(lib, grid_a, grid_b)``:
        kernel A's from the march's tiles (``plan``, default
        :attr:`march`) or, for the first kernel A, its occupancy."""
        if v.device.type != "cuda":
            raise ValueError(f"FusedCGMulti: unsupported device {v.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"FusedCGMulti: the CUDA kernels take float32, "
                            f"got {v.dtype}")
        if v.dim() != 2 or v.shape[1] != self.n or v.shape[0] < 1:
            raise ValueError(f"FusedCGMulti: expected a block of shape (k, "
                             f"{self.n}), got {tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError("FusedCGMulti: the CUDA kernels need a "
                             "contiguous block")
        if self.n >= 2 ** 31:
            raise ValueError(f"FusedCGMulti: {self.n} rows do not fit int32 "
                             f"row indexing")
        for t, name, ok in ((self.planes, "planes",
                             (torch.float32, torch.bfloat16)),
                            (self.weight, "weight", (torch.float32,))):
            if t is not None and (t.device != v.device or t.dtype not in ok):
                raise ValueError(f"FusedCGMulti: {name} must be "
                                 f"{' or '.join(map(str, ok))} on "
                                 f"{v.device}, got {t.dtype} on {t.device}")
        lib = _build.library()
        tj, tk, length = self._plan_fields(design, plan)[:3]
        ga, gb = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib.cgx_multi_a_grid(
            v.device.index, len(self.taps), int(self.planes is not None),
            int(self.sym), self._bf16_flags()[1], design, self.nx, self.ny,
            self.nz, tj, tk, length, ctypes.byref(ga)),
            "multi kernel A grid")
        _build.check(lib.cgx_multi_b_grid(
            v.device.index, int(self.weight is not None), ctypes.byref(gb)),
            "multi kernel B occupancy")
        return lib, ga.value, gb.value

    @staticmethod
    def _ctl(k: int, dev):
        """A zeroed control block for k columns and its float view."""
        ctl = torch.zeros(_HEAD + 5 * k, dtype=torch.int32, device=dev)
        return ctl, ctl.view(torch.float32)

    @staticmethod
    def _field(f: torch.Tensor, fld: int) -> torch.Tensor:
        k = (f.shape[0] - _HEAD) // 5
        return f[_HEAD + fld * k:_HEAD + (fld + 1) * k]

    def _plan_fields(self, design: int, plan: Optional[MarchPlan]):
        """``(tj, tk, length, rows, hj, hk)`` of the march's ``plan``
        (default :attr:`march`) for the C entries; zeros for the first
        kernel A, which takes no plan."""
        if design == _FIRST_DESIGN:
            return (0,) * 6
        mp = self.march if plan is None else plan
        return mp.tj, mp.tk, mp.length, mp.rows, mp.hj, mp.hk

    def _a_args(self, p, q, part, ga, ctl, design,
                plan: Optional[MarchPlan] = None, ldp: Optional[int] = None,
                sums=None):
        """Kernel A's C arguments: P's columns ``ldp`` apart (default n;
        a shard's P points at the first local row of its extended block),
        ``sums`` the cross-rank sums (or None)."""
        taps_c, coef_c, plane_c = plane_tap_arrays(self.taps, self.coeffs)
        tj, tk, length, rows, hj, hk = self._plan_fields(design, plan)
        return (p.data_ptr(), q.data_ptr(), self._planes_ptr(),
                part.data_ptr(), ga, ctl.data_ptr(), p.shape[0], self.nx,
                self.ny, self.nz, len(self.taps), taps_c, coef_c, plane_c,
                int(self.sym), self._bf16_flags()[1], design, tj, tk, rows,
                length, hj, hk, self._span_arg(),
                self.n if ldp is None else int(ldp),
                None if sums is None else sums.data_ptr(),
                torch.cuda.current_stream(p.device).cuda_stream)

    def _b_args(self, x, r, p, q, part, gb, ctl, ldp: Optional[int] = None,
                sums=None):
        return (x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
                None if self.weight is None else self.weight.data_ptr(),
                part.data_ptr(), gb, ctl.data_ptr(), x.shape[0], self.n,
                self.n if ldp is None else int(ldp),
                None if sums is None else sums.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)

    def _launch_a(self, lib, args, count: bool = True) -> None:
        global multi_a_launches, multi_a_bf16_launches
        _build.check(lib.cgx_multi_a(*args), "multi kernel A launch")
        if not count:
            return
        multi_a_launches += 1
        if self.planes is not None and self._bf16_flags()[1]:
            multi_a_bf16_launches += 1

    def _launch_b(self, lib, args, count: bool = True) -> None:
        global multi_b_launches
        _build.check(lib.cgx_multi_b(*args), "multi kernel B launch")
        if count:
            multi_b_launches += 1

    def _run_cuda(self, state: FusedMultiState, upto: int, tol_sq,
                  design: Optional[int] = None,
                  count: bool = True) -> FusedMultiState:
        with annotate(PREP):
            design = self.a_design() if design is None else design
            lib, ga, gb = self._setup(state.x, design)
            k, dev = state.x.shape[0], state.x.device
            for v, name in ((state.r, "r"), (state.p, "p")):
                if v.shape != state.x.shape or not v.is_contiguous():
                    raise ValueError(f"FusedCGMulti state {name}: expected a "
                                     f"contiguous block like x")
            x, r = state.x.clone(), state.r.clone()
            sh, pl, sums, ldp = self.shard, self.plane, None, None
            if sh is not None:
                # The cross-rank mode: P in the ghost layout, fp64 sums.
                if sh.group is None and sh.size > 1:
                    raise ValueError("FusedCGMulti: a shard runs over its "
                                     "process group")
                from cgx_torch.dist import halo

                p_ext = torch.zeros((k, self.n + 2 * pl), dtype=self.dtype,
                                    device=dev)
                p_ext[:, pl:pl + self.n] = state.p
                p, ldp = self._interior(p_ext), p_ext.shape[1]
                sums = torch.zeros(4 * k, dtype=torch.float64, device=dev)
            else:
                p = state.p.clone()
            q = torch.empty_like(x)
            part_a = torch.empty(2 * k * ga, dtype=torch.float64, device=dev)
            part_b = torch.empty(2 * k * gb, dtype=torch.float64, device=dev)
            ctl, f = self._ctl(k, dev)
            rz = state.rz.to(torch.float32)
            tol = torch.as_tensor(tol_sq, dtype=torch.float32,
                                  device=dev).expand(k)
            self._field(f, _RZ).copy_(rz[0])
            self._field(f, _RW).copy_(rz[1])
            self._field(f, _TOL).copy_(tol)
            upto = min(max(upto, 0), 2 ** 31 - 1)
            ctl[_IT] = state.k.to(torch.int32)
            ctl[_MAXIT] = upto
            # The entry test on the device: no host read before the first
            # chunk.
            ctl[_DONE] = (~((state.k < upto) & torch.any(rz[1] > tol))).to(
                torch.int32)
            args_a = self._a_args(p, q, part_a, ga, ctl, design, ldp=ldp,
                                  sums=sums)
            args_b = self._b_args(x, r, p, q, part_b, gb, ctl, ldp=ldp,
                                  sums=sums)
            # At most upto − k (A, B) pairs: B counts the last one and exits
            # (across ranks the next A takes the exit: one pair more).
            budget, launched = upto + (sums is not None), 0
        with annotate(ENGINE), torch.cuda.device(dev):
            while True:
                chunk = min(CHUNK, budget - launched)
                for _ in range(chunk):
                    if sums is None:
                        self._launch_a(lib, args_a, count)
                        self._launch_b(lib, args_b, count)
                        continue
                    halo.exchange_planes(p_ext, pl, sh.rank, sh.size,
                                         sh.group)
                    self._launch_a(lib, args_a, count)
                    halo.all_reduce(sums[:2 * k], sh.group)
                    self._launch_b(lib, args_b, count)
                    halo.all_reduce(sums[2 * k:], sh.group)
                launched += chunk
                if host_read(ctl[_DONE], int):
                    break
                if launched >= budget:
                    raise RuntimeError("FusedCGMulti: the kernels did not "
                                       "reach their exit")
        if sums is not None:
            p = p_ext[:, pl:pl + self.n].contiguous()
        return FusedMultiState(
            x=x, r=r, p=p,
            rz=torch.stack([self._field(f, _RZ), self._field(f, _RW)]).clone(),
            k=ctl[_IT].clone())


def _before_kernel_a(eng: FusedCGMulti, p: torch.Tensor):
    """The first kernel A once (the same-run "before" of the march,
    counted nowhere): ``(Q, Σ p·q, Σ q·q)``."""
    return eng._kernel_a_call(p, _FIRST_DESIGN, count=False)


def _kernel_a_launcher(eng: FusedCGMulti, p: torch.Tensor, design: int,
                       plan: Optional[MarchPlan] = None):
    """A zero-argument launch of kernel A on ``p`` in ``design`` (the
    march on ``plan``, default :attr:`FusedCGMulti.march`), its arguments
    built once, counted nowhere (the smoke's and the tile sweep's timings);
    and the ``Q`` it writes and its grid: ``(run, q, grid)``."""
    lib, ga, _ = eng._setup(p, design, plan)
    q = torch.empty_like(p)
    ctl, _ = eng._ctl(p.shape[0], p.device)
    part = torch.empty(2 * p.shape[0] * ga, dtype=torch.float64,
                       device=p.device)
    args = eng._a_args(p, q, part, ga, ctl, design, plan)

    def run():
        _build.check(lib.cgx_multi_a(*args), "multi kernel A launch")

    return run, q, ga


def _before_solve(eng: FusedCGMulti, b: torch.Tensor, x0=None, *,
                  tol: float = 1e-6, atol: float = 0.0,
                  maxiter: int = 1000) -> CGResult:
    """:meth:`FusedCGMulti.solve` through the first kernel A (the same-run
    "before", counted nowhere)."""
    return eng._solve(b, x0, tol, atol, maxiter,
                      lambda v: eng._kernel_a_call(v, _FIRST_DESIGN,
                                                   count=False),
                      lambda st, upto, tol_sq: eng._run_cuda(
                          st, upto, tol_sq, _FIRST_DESIGN, count=False))


def fused_stencil_cg_multi(s, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                           atol: float = 0.0,
                           maxiter: int = 1000) -> CGResult:
    """Batched fused CG on a constant-coefficient stencil; ``b``: (n, k).

    Semantics of :func:`cgx_torch.solve.block.cg_solve_multi` except that
    the iteration count is shared (the loop runs until every column
    converges; per-column ``converged`` and residuals are reported).
    """
    if b.dim() != 2:
        raise ValueError(f"expected b of shape (n, k), got {tuple(b.shape)}")
    with annotate(PREP):
        spec = stencil_taps(s)
        if spec is None or not supports(s):
            raise ValueError("unsupported operator for the fused multi path")
        nx, ny, nz, taps, coeffs = spec
        eng = FusedCGMulti(nx, ny, nz, taps, dtype=b.dtype, coeffs=coeffs)
    return eng.solve(b.T, None if x0 is None else x0.T, tol=tol, atol=atol,
                     maxiter=int(maxiter))


def fused_dia_cg_multi(d, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
                       atol: float = 0.0, maxiter: int = 1000,
                       jacobi: bool = True, inv_diag=None, plane_dtype=None,
                       assume_symmetric: Optional[bool] = None) -> CGResult:
    """Batched fused Jacobi-PCG (plain CG with ``jacobi=False``) on a banded
    DIA operator; ``b``: (n, k).  The DIA preparation, ``inv_diag`` and
    ``plane_dtype`` are those of
    :func:`cgx_torch.kernels.fused_dia_cg.fused_dia_cg`; the planes are
    shared by the columns."""
    if b.dim() != 2:
        raise ValueError(f"expected b of shape (n, k), got {tuple(b.shape)}")
    with annotate(PREP):
        if wrap_entries_zero_or_none(d) is False:
            raise ValueError("DIA data has nonzero x-plane-crossing entries")
        nx, ny, nz, taps, coeffs, planes, e, weight, sym = dia_prep(
            d, b.dtype, jacobi=jacobi, inv_diag=inv_diag,
            assume_symmetric=assume_symmetric)
        eng = FusedCGMulti(nx, ny, nz, taps, dtype=b.dtype, coeffs=coeffs,
                           planes=planes, weight=weight, sym=sym,
                           plane_dtype=plane_dtype)
        b2 = b.T
        x0_2 = None if x0 is None else x0.T
        if e is not None:
            b2 = b2 * e[None]
            if x0_2 is not None:
                x0_2 = x0_2 * safe_recip(e)[None]
    res = eng.solve(b2, x0_2, tol=tol, atol=atol, maxiter=int(maxiter))
    if e is None:
        return res
    with annotate(RESULT):
        return dataclasses.replace(res, x=res.x * e[:, None])

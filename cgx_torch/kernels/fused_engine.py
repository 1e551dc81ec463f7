"""K3: the two-pass fused CG engine — CUDA kernels A and B + plain versions.

Counterpart of :mod:`cgx.kernels.fused_engine` (``FusedCG``,
``FusedState``).  Per iteration:

  A. ``q = Ã p`` with the partial sums of ``p·q`` and ``q·q``;
  B. ``α = rz/pq``, ``β = (α²·qq − rz)/rz`` (the communication-avoiding
     identity, so that β is known before the pass), then ``x += αp``,
     ``r −= αq``, ``p = r + βp`` with ``Σr²`` and ``Σr²·w``.

The operator is a list of grid taps ``(dx, dy, dk)`` with ``|dx| ≤ 1``,
each with a constant coefficient (boundary masks from index arithmetic) or
``None`` for a per-row coefficient plane (row-aligned DIA convention, the
boundary zeros in the data); ``sym`` applies each plane also at its
mirror tap.  ``weight`` makes ``Σr²·w`` the exit test (the Jacobi-scaled
DIA solve, ``w = diag A``) while β keeps the solve-space ``Σr²``.

The four sums of an iteration (p·q, q·q, Σr², Σr²·w) are taken exactly,
in the kernels and in the plain version alike: fp64 products of the
(widened) vectors summed in fp64 and rounded to fp32 once (the JAX package
sums in fp32).  The CA identity makes the exit iteration sensitive to 1e-7
errors in those sums; see the note in ``fused_engine.cu``.

Mixed precision: the vectors are float32 or bfloat16 (``dtype``) and the
coefficient planes float32 or bfloat16 (``plane_dtype``, default
``dtype``).  The kernels take fp32/fp32, fp32 vectors with bf16 planes,
and bf16 vectors with bf16 planes or none.  Every value is widened to
fp32, kernel A sums a row in fp32 and rounds q once, kernel B rounds α and
β to ``dtype`` and then each updated entry once; the plain versions round
at the same places, so a bf16 mode equals its plain version bit for bit on
the card.  The JAX package rounds every bf16 term instead, so the two
packages agree to a bf16 tolerance.

The port works on flat vectors, as the whole-solve kernel does.  The
JAX package's TPU placement — ``Geometry``/``make_geometry`` (lane blocks,
VMEM windows, ``double_buffer``, halo rows) and ``to_layout`` — is not
ported: the CUDA kernels (``cgx_torch/csrc/fused_engine.cu``) run a flat
grid-stride loop, so :meth:`FusedCG.state_to_flat` and
:meth:`FusedCG.state_from_flat` (the checkpoint files' unscaled flat
state, :mod:`cgx_torch.utils.checkpoint`) only undo and redo the Jacobi
scaling.

Distribution (the JAX package's ``axis_name``): ``FusedCG(..., group=)``
makes the engine one rank's :class:`Shard` of a grid cut into x-plane
blocks, ``nx`` its own planes.  Before each kernel A the boundary planes of
p travel to the neighbour ranks' ghost planes (the layout
``[ghost | planes | ghost]``, :func:`cgx_torch.dist.halo.exchange_planes`;
the outer ranks keep zero ghosts, as the JAX package's non-ring exchange),
and the four sums run in the cross-rank mode of ``fused_engine.cu``: each
rank's fp64 sums, unrounded, one all-reduce of two doubles after each
kernel, rounded to fp32 once.  At one rank that is the single-card
solve bit for bit; across ranks the sums differ only in the order of fp64
additions.  The plain versions take the same form
(:meth:`FusedCG.kernel_a_ext_reference`,
:meth:`FusedCG.kernel_b_ext_reference`).

On a CUDA tensor :meth:`FusedCG.run` launches kernel A and kernel B once
per iteration from a Python loop.  The exit decision, α, β and the history
slot stay on the device (see the source note); the host reads one flag per
chunk of :data:`CHUNK` iterations, and the launches past the exit return at
once.  The redesigned kernels A and B (``kernel_a2``, ``kernel_b2``) keep
K3's partition of the sums, so they equal the first kernels bit for bit;
kernel A reads each row's taps at the carried node with two rows in
flight, kernel B loads :data:`B_ROWS` of a thread's rows (two in bf16
vectors) before it stores any (its vectors must then share no storage:
:func:`check_no_alias`).
Both kernels fold the other's partials once a launch.  The first design of both stays
as the same-run "before" (:func:`_before_kernel_a`, :func:`_before_solve`,
counted nowhere).  On a CPU tensor it takes the plain version,
:meth:`FusedCG.run_reference`, which a CUDA tensor can also be given
explicitly.
``fused_a_launches`` and ``fused_b_launches`` count the kernels' launches,
``fused_a_bf16_launches``, ``fused_b_bf16_launches`` and
``fused_a_bf16_planes_launches`` those of the narrow modes among them.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from cgx_torch.kernels import _build
from cgx_torch.ops.spmv import shifted
from cgx_torch.solve.cg import CGResult
from cgx_torch.sparse.stencil import _shift
from cgx_torch.utils.profiling import (ENGINE, PREP, RESULT, annotate,
                                       host_read)

__all__ = ["FusedCG", "FusedState", "Shard", "tap_matvec", "threshold",
           "plane_tap_arrays", "fused_a_launches", "fused_b_launches",
           "fused_a_bf16_launches", "fused_b_bf16_launches",
           "fused_a_bf16_planes_launches", "CHUNK", "B_ROWS",
           "check_no_alias", "sweep_groups", "even_grid",
           "kernel_b_rows_reference"]

# Kernel launches so far, every mode (a run resets them to show which
# kernels it used), and those of the narrow modes: bf16 vectors (kernels A
# and B), and fp32 vectors with bf16 planes (kernel A; its B is fp32's).
fused_a_launches = 0
fused_b_launches = 0
fused_a_bf16_launches = 0
fused_b_bf16_launches = 0
fused_a_bf16_planes_launches = 0

# Iterations launched between two reads of the device's exit flag.
CHUNK = 32

# Words of the device control block (the struct Ctl in fused_engine.cu).
_RZ, _RW, _K, _PENDING, _DONE, _TOL, _MAXIT, _HLEN, _N_RZ, _N_DONE = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 11)
_PQ, _QQ = 12, 13

# The kernels of fused_engine.cu (its `design`): the first design, kept as
# the same-run "before", and the redesign.
_FIRST_DESIGN, _REDESIGN = 0, 1

# Rows of a thread the redesigned kernel B loads before it stores any, by
# the vector type (BRows in fused_engine.cu; two fp32 rows measured slower
# than the first design on the H100, PERF.md §6).
B_ROWS = {torch.float32: 1, torch.bfloat16: 2}


@dataclass(frozen=True)
class Shard:
    """An engine's place in a grid cut into x-plane blocks: rank ``rank``
    of ``size`` holds the rank-th block.  ``group``: the process group whose
    ranks hold the blocks in order (the ghost planes and the sums travel
    over it), or None for a shard whose caller supplies the ghost planes
    (the kernel-level checks of one process)."""

    rank: int
    size: int
    group: object = None

    @property
    def left(self) -> bool:
        return self.rank > 0

    @property
    def right(self) -> bool:
        return self.rank < self.size - 1


def shard_of(group) -> Shard:
    """This process's :class:`Shard` in ``group`` (a process group, or
    a :class:`~cgx_torch.dist.launch.RowMesh`)."""
    import torch.distributed as dist

    from cgx_torch.dist.launch import RowMesh

    if isinstance(group, RowMesh):
        return Shard(group.rank, group.size, group.group)
    return Shard(dist.get_rank(group), dist.get_world_size(group), group)


def allsum(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """``t`` summed over the shard's group (a copy), or ``t`` itself
    without a group."""
    if shard is None:
        return t
    if shard.group is None and shard.size > 1:
        raise ValueError("a shard without a process group cannot sum over "
                         "its ranks")
    from cgx_torch.dist import halo

    return halo.all_reduce(t.clone(), shard.group)


def check_no_alias(what: str, **tensors) -> None:
    """Raise if two of the named tensors share storage (None entries are
    skipped): the redesigned kernel B takes its vectors as ``__restrict__``
    and loads rows ahead of its stores."""
    seen = {}
    for name, v in tensors.items():
        if v is None:
            continue
        key = (v.device, v.untyped_storage().data_ptr())
        if key in seen:
            raise ValueError(f"{what}: {seen[key]} and {name} share storage")
        seen[key] = name


def even_grid(g: int, fit: int) -> int:
    """A launch grid over ``g`` virtual blocks: at most ``fit`` blocks and
    at most ``g``, then as few as keep the same number of virtual blocks in
    every block."""
    per = -(-g // min(fit, g))
    return -(-g // per)


def sweep_groups(g: int, n: int, rows: int, threads: int = 256):
    """The rows of the redesigned sweeps, as a thread loads them:
    ``{(vb, u): [group, ...]}`` for thread ``u`` of virtual block ``vb`` of
    ``g``, each group the rows loaded together before any is used, in the
    kernel's order.  The thread's rows are vb·threads + u + m·g·threads
    < n; the kernels take ``rows`` at a time while the group's first row
    plus ``rows − 1`` steps lies below n (only its last row may not, and
    is dropped), then one at a time (K3 B's :data:`B_ROWS` and K4's
    ``virtual_sweep_rows`` are ``rows`` = 1 or 2)."""
    step = g * threads
    out = {}
    for vb in range(g):
        for u in range(threads):
            groups, s = [], vb * threads
            while s + (rows - 1) * step < n:
                grp = [s + u + j * step for j in range(rows)
                       if s + u + j * step < n]
                if grp:     # one row a step: past n nothing is loaded
                    groups.append(grp)
                s += rows * step
            while s + u < n:
                groups.append([s + u])
                s += step
            out[vb, u] = groups
    return out


def tap_matvec(nx: int, ny: int, nz: int, taps, coeffs, planes, sym: bool,
               v: torch.Tensor) -> torch.Tensor:
    """Plain ``y = Ã·v`` for engine taps, rounded as the kernels round it.

    A constant tap is ``c·v[neighbour]`` inside the grid, 0 outside; a
    plane tap is ``plane[i]·v[i+off]`` with flat zero fill, plus the mirror
    ``plane[i−off]·v[i−off]`` when ``sym`` (``off`` = dx·ny·nz + dy·nz +
    dk).  Terms are added in tap order, in ``v``'s dtype; narrower planes
    are widened to it first.
    """
    g = v.reshape(nx, ny, nz)
    y = None
    pi = 0
    for (dx, dy, dk), c in zip(taps, coeffs):
        if c is not None:
            term = c * _shift(_shift(_shift(g, 0, dx), 1, dy), 2,
                              dk).reshape(-1)
        else:
            w = planes[pi].to(v.dtype)
            pi += 1
            off = (dx * ny + dy) * nz + dk
            term = w * shifted(v, off)
            if sym and off != 0:
                term = term + shifted(w * v, -off)
        y = term if y is None else y + term
    return y


def bsq_sum(b: torch.Tensor,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Σ b²·w`` of a vector in fp32 (``w = 1`` when ``weight`` is
    None)."""
    bsq = b.to(torch.float32) ** 2
    if weight is not None:
        bsq = bsq * weight.to(torch.float32)
    return torch.sum(bsq)


def clamp_threshold(bsq: torch.Tensor, tol: float,
                    atol: float) -> torch.Tensor:
    """``max(tol²·bsq, atol²)`` in fp32."""
    tol2 = torch.tensor(tol, dtype=torch.float32).square().item()
    atol2 = torch.tensor(atol, dtype=torch.float32).square().item()
    return torch.clamp(bsq * tol2, min=atol2)


def threshold(b: torch.Tensor, tol: float, atol: float,
              weight: Optional[torch.Tensor] = None,
              shard: Optional[Shard] = None) -> torch.Tensor:
    """``max(tol²·Σ b²·w, atol²)`` in fp32 on ``b``'s device (``w = 1``
    when ``weight`` is None); no host synchronisation.  On a shard of a
    group the fp32 sum is summed over the ranks."""
    return clamp_threshold(allsum(bsq_sum(b, weight), shard), tol, atol)


def exact_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Σ u·v`` of fp32 vectors taken exactly: fp64 products (exact for
    fp32 factors) summed in fp64, rounded to fp32 once."""
    return torch.sum(u.to(torch.float64) * v.to(torch.float64)).float()


def _block_tree(v: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """``cgx::block_sum`` of each row of ``v`` (…, threads) in fp64, in the
    kernels' order: each warp's xor butterfly, then the warps' sums added
    to 0 one after another."""
    lane = torch.arange(32)
    w = v.reshape(*v.shape[:-1], threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ o]
    s = torch.zeros(v.shape[:-1], dtype=v.dtype)
    for i in range(threads // 32):
        s = s + w[..., i, 0]
    return s


def _fold(part: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """``cgx::grid_sum`` of ``g`` partials: thread t adds t, t + threads,
    … to 0, then the block tree; rounded to fp32 once."""
    g = part.shape[0]
    cols = -(-g // threads)
    v = torch.zeros(cols * threads, dtype=torch.float64)
    v[:g] = part
    acc = torch.zeros(threads, dtype=torch.float64)
    for c in range(cols):
        acc = acc + v[c * threads:(c + 1) * threads]
    return _block_tree(acc, threads).float()


def kernel_b_rows_reference(eng: "FusedCG", rz, pq, qq, x, r, p, q, g: int,
                            rows: int, threads: int = 256):
    """Plain version of the redesigned kernel B over K3's partition of
    ``g`` virtual blocks (CPU tensors): a thread's rows taken ``rows`` at a
    time, each group's loads before its updates and stores, every sum in
    fp64 in each thread's row order, each virtual block's tree, and the
    fold of the ``g`` partials, in the kernel's orders.  Returns ``(x', r',
    p', Σ r'², Σ r'²·w)``, which :meth:`FusedCG.kernel_b_reference` gives
    with its sums taken in torch's order."""
    dt = x.dtype
    alpha32 = rz / pq
    beta = ((alpha32 * alpha32 * qq - rz) / rz).to(dt).float()
    alpha = alpha32.to(dt).float()
    n, step = x.shape[0], g * threads
    src = [v.float() for v in (x, r, p, q)]
    w = None if eng.weight is None else eng.weight.double()
    out = [torch.empty_like(v) for v in (x, r, p)]
    acc = torch.zeros(step, dtype=torch.float64)
    accw = torch.zeros(step, dtype=torch.float64)
    steps = -(-n // step)
    for m0 in range(0, steps, rows):
        cuts = [slice(m * step, min((m + 1) * step, n))
                for m in range(m0, min(m0 + rows, steps))]
        loaded = [[v[c] for v in src] for c in cuts]
        for c, (xv, rv, pv, qv) in zip(cuts, loaded):
            xs = (xv + alpha * pv).to(dt)
            rs = (rv - alpha * qv).to(dt)
            ps = (rs.float() + beta * pv).to(dt)
            for o, v in zip(out, (xs, rs, ps)):
                o[c] = v
            rsq = rs.double() ** 2
            k = c.stop - c.start
            acc[:k] = acc[:k] + rsq
            if w is not None:
                accw[:k] = accw[:k] + rsq * w[c]
    part = _block_tree(acc.reshape(g, threads), threads)
    part_w = (part if w is None
              else _block_tree(accw.reshape(g, threads), threads))
    return tuple(out) + (_fold(part, threads), _fold(part_w, threads))


def exact_sums(r: torch.Tensor, weight: Optional[torch.Tensor]):
    """``(Σ r², Σ r²·w)`` as :func:`exact_dot` takes them."""
    r64 = r.to(torch.float64)
    rsq = r64 * r64
    s = torch.sum(rsq).float()
    if weight is None:
        return s, s
    return s, torch.sum(rsq * weight.to(torch.float64)).float()


def sums64(r: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    """``[Σ r², Σ r²·w]`` of a vector in fp64, unrounded: a rank's share
    of :func:`exact_sums`, which rounds the same sums."""
    r64 = r.to(torch.float64)
    rsq = r64 * r64
    s = torch.sum(rsq)
    if weight is None:
        return torch.stack([s, s])
    return torch.stack([s, torch.sum(rsq * weight.to(torch.float64))])


def plane_tap_arrays(taps, coeffs):
    """ctypes host arrays ``(int[3·T], float[T], int[T])`` for the C entry
    points: the taps, the constant coefficients (0 for a plane tap) and
    each tap's plane index (−1 for a constant tap)."""
    flat = [int(d) for tap in taps for d in tap]
    plane, cf, pi = [], [], 0
    for c in coeffs:
        if c is None:
            plane.append(pi)
            cf.append(0.0)
            pi += 1
        else:
            plane.append(-1)
            cf.append(float(c))
    n = len(coeffs)
    return ((ctypes.c_int * len(flat))(*flat), (ctypes.c_float * n)(*cf),
            (ctypes.c_int * n)(*plane))


@dataclass(frozen=True, eq=False)
class FusedState:
    """Flat CG state of the engine (the chunk unit of init/run/result)."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor       # (2,) fp32: [solve-space Σr̃², weighted Σr̃²·w]
    k: torch.Tensor        # int32
    history: torch.Tensor  # (maxiter+1,) fp32 or (0,)


class FusedCG:
    """The two-pass solver for one operator.

    Args:
      nx, ny, nz: the grid (2-D operators use ``(nx, 1, ny)``).
      taps: ``(dx, dy, dk)`` per tap, ``|dx| ≤ 1``, at most 27.
      dtype: vector dtype, float32 or bfloat16.
      coeffs: per tap a float (constant) or None (plane); default all None.
      planes: ``(n_planes, n)``, the None slots' planes in tap order.
      weight: per-row weights ``(n,)``; the exit test then reads Σr²·w.
      sym: symmetric mode (``taps`` lists the diagonal and one tap per
        ±off pair; each plane is applied twice).  The caller checks that
        the data really is symmetric.
      plane_dtype: the planes' dtype (default ``dtype``): bfloat16 with
        float32 vectors halves the plane bytes.  Rounding the planes is a
        fixed perturbation of the operator (about 4e-3 relative), made
        once here; :func:`cgx_torch.solve.ir.ir_cg_solve` refines it away.
      group: a process group (or a
        :class:`~cgx_torch.dist.launch.RowMesh`) whose ranks hold the
        grid's x-plane blocks in order: this engine is this rank's block
        (``nx`` its planes; ``planes`` and ``weight`` its rows).
      shard: the :class:`Shard` itself, for a shard without a group (its
        caller supplies the ghost planes to the ``*_ext`` kernels).
      planes_ext: in the symmetric mode of a shard, the planes with the
        neighbours' boundary plane on each side, ``(n_planes, n +
        2·ny·nz)``, cut from the whole planes
        (:func:`cgx_torch.dist.halo.cut_ghost_rows`;
        :func:`~cgx_torch.kernels.fused_dia_cg.dia_shard_engine` builds
        such a shard): the mirror taps read the neighbours' coefficients.
    """

    def __init__(self, nx: int, ny: int, nz: int,
                 taps: Sequence[Tuple[int, int, int]], *,
                 dtype=torch.float32, coeffs=None,
                 planes: Optional[torch.Tensor] = None,
                 weight: Optional[torch.Tensor] = None, sym: bool = False,
                 plane_dtype=None, group=None,
                 shard: Optional[Shard] = None,
                 planes_ext: Optional[torch.Tensor] = None):
        taps = tuple(tuple(int(d) for d in t) for t in taps)
        for (dx, dy, dk) in taps:
            if abs(dx) > 1:
                raise ValueError(f"tap {dx, dy, dk}: |dx| must be <= 1")
        if not 1 <= len(taps) <= 27:
            raise ValueError(f"FusedCG: 1 to 27 taps, got {len(taps)}")
        coeffs = (None,) * len(taps) if coeffs is None else tuple(coeffs)
        if len(coeffs) != len(taps):
            raise ValueError("FusedCG: one coefficient slot per tap")
        n_planes = sum(1 for c in coeffs if c is None)
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.n = self.nx * self.ny * self.nz
        self.taps, self.coeffs, self.dtype = taps, coeffs, dtype
        self.plane_dtype = dtype if plane_dtype is None else plane_dtype
        self.sym = bool(sym and n_planes > 0)
        if n_planes:
            if planes is None or tuple(planes.shape) != (n_planes, self.n):
                raise ValueError(
                    f"need {n_planes} coefficient planes of {self.n} rows "
                    f"for the None tap slots, got "
                    f"{None if planes is None else tuple(planes.shape)}")
            self.planes = planes.to(self.plane_dtype).contiguous()
        else:
            self.planes = None
        self.weight = (None if weight is None
                       else weight.to(dtype).contiguous())
        self.shard = shard if shard is not None or group is None \
            else shard_of(group)
        self.plane = self.ny * self.nz         # elements of an x-plane
        self.planes_ext = None
        if self.shard is not None and self.sym:
            shape = (n_planes, self.n + 2 * self.plane)
            if planes_ext is None or tuple(planes_ext.shape) != shape:
                raise ValueError(
                    f"FusedCG: the symmetric mode of a shard needs "
                    f"planes_ext of shape {shape} (the planes with their "
                    f"ghost planes), got "
                    f"{None if planes_ext is None else tuple(planes_ext.shape)}")
            self.planes_ext = planes_ext.to(
                device=self.planes.device,
                dtype=self.plane_dtype).contiguous()

    # -- a shard's ghost layout --------------------------------------------

    def span(self) -> Tuple[int, int, int, int, int]:
        """``(lo, hi, xlo, xhi, pstride)`` of ``cgx::Span``: the flat
        range of p the rows may read (a ghost plane where a neighbour
        exists), the x-planes a constant tap may reach, and the stride of
        the planes the kernels read."""
        n, nx, pl = self.n, self.nx, self.plane
        if self.shard is None:
            return 0, n, 0, nx, n
        left, right = self.shard.left, self.shard.right
        return (-pl if left else 0, n + pl if right else n,
                -1 if left else 0, nx + 1 if right else nx,
                n + 2 * pl if self.planes_ext is not None else n)

    def ghosted(self, v: torch.Tensor) -> torch.Tensor:
        """``v`` (this rank's rows; a block ``(k, n)`` too) in the
        extended layout, its ghost planes filled from the neighbour ranks
        over the group."""
        from cgx_torch.dist import halo

        sh = self.shard
        if sh.group is None and sh.size > 1:
            raise ValueError("a shard without a process group: fill the "
                             "ghost planes yourself and call the *_ext "
                             "kernels")
        return halo.ghosted(v, self.plane, sh.rank, sh.size, sh.group)

    def matvec_ext(self, v_ext: torch.Tensor) -> torch.Tensor:
        """Plain ``Ã·v`` on this shard's rows from the extended ``v``:
        the operator on the grid of ``nx + 2`` planes, its interior rows.
        Where a rank has no neighbour its ghost plane is zero, as the whole
        grid's zero fill, so the rows equal the whole grid's."""
        n, pl = self.n, self.plane
        planes = None
        if self.planes is not None:
            planes = self.planes_ext
            if planes is None:
                planes = torch.nn.functional.pad(self.planes, (pl, pl))
        y = tap_matvec(self.nx + 2, self.ny, self.nz, self.taps,
                       self.coeffs, planes, self.sym, v_ext)
        return y[pl:pl + n]

    def kernel_a_ext_reference(self, p_ext: torch.Tensor):
        """Plain kernel A of a shard: ``(q, [Σ p·q, Σ q·q])`` from the
        extended ``p``, the sums this rank's, fp64 and unrounded."""
        pl = self.plane
        p = p_ext[pl:pl + self.n]
        q = self.matvec_ext(p_ext.float()).to(p.dtype)
        q64, p64 = q.to(torch.float64), p.to(torch.float64)
        return q, torch.stack([torch.sum(q64 * p64), torch.sum(q64 * q64)])

    def kernel_b_ext_reference(self, rz, sums_a, x, r, p, q):
        """Plain kernel B of a shard: p·q and q·q from ``sums_a`` (fp64,
        summed over the ranks) rounded to fp32 once, then
        :meth:`kernel_b_reference`'s update; ``(x', r', p', [Σ r'²,
        Σ r'²·w])``, the sums this rank's, fp64 and unrounded."""
        pq, qq = sums_a[0].float(), sums_a[1].float()
        x, r, p = self._update_reference(rz, pq, qq, x, r, p, q)
        return x, r, p, sums64(r, self.weight)

    # -- the operator and the two kernels --------------------------------

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """Plain ``Ã·v``."""
        return tap_matvec(self.nx, self.ny, self.nz, self.taps, self.coeffs,
                          self.planes, self.sym, v)

    def kernel_a_reference(self, p: torch.Tensor):
        """Plain kernel A: ``(q, Σ p·q, Σ q·q)``, sums exact to fp32; the
        row in fp32, ``q`` rounded once to ``p``'s dtype.  On a shard of a
        group: the ghost planes exchanged and the sums summed over the
        ranks."""
        if self.shard is not None:
            q, s = self.kernel_a_ext_reference(self.ghosted(p))
            s = allsum(s, self.shard).float()
            return q, s[0], s[1]
        q = self.matvec(p.float()).to(p.dtype)
        return q, exact_dot(q, p), exact_dot(q, q)

    def _update_reference(self, rz, pq, qq, x, r, p, q):
        """Kernel B's update: α and β rounded to the vector dtype, each
        update taken in fp32 and rounded once."""
        dt = x.dtype
        alpha32 = rz / pq
        beta = ((alpha32 * alpha32 * qq - rz) / rz).to(dt).float()
        alpha = alpha32.to(dt).float()
        pf = p.float()
        x = (x.float() + alpha * pf).to(dt)
        r_new = (r.float() - alpha * q.float()).to(dt)
        p_new = (r_new.float() + beta * pf).to(dt)
        return x, r_new, p_new

    def kernel_b_reference(self, rz, pq, qq, x, r, p, q):
        """Plain kernel B: ``(x', r', p', Σ r'², Σ r'²·w)``.  α and β are
        rounded to the vector dtype, each update is taken in fp32 and
        rounded once.  On a shard of a group the sums are summed over the
        ranks."""
        x, r_new, p_new = self._update_reference(rz, pq, qq, x, r, p, q)
        if self.shard is not None:
            s = allsum(sums64(r_new, self.weight), self.shard).float()
            return x, r_new, p_new, s[0], s[1]
        return (x, r_new, p_new) + exact_sums(r_new, self.weight)

    def kernel_a(self, p: torch.Tensor):
        """Kernel A once: ``(q, Σ p·q, Σ q·q)``.  A CPU tensor takes the
        plain version; on a CUDA tensor the kernel runs and the block
        partials are summed here (on a shard of a group: the ghost planes
        exchanged first and the sums summed over the ranks)."""
        if p.device.type == "cpu":
            return self.kernel_a_reference(p)
        if self.shard is not None:
            q, s = self.kernel_a_ext(self.ghosted(p))
            s = allsum(s, self.shard).float()
            return q, s[0], s[1]
        q, part_a = self._kernel_a_call(p, design=_REDESIGN)
        ga = part_a.shape[0] // 2
        return (q, torch.sum(part_a[:ga]).float(),
                torch.sum(part_a[ga:]).float())

    def kernel_a_ext(self, p_ext: torch.Tensor):
        """Kernel A of a shard once, in the cross-rank mode, from the
        extended ``p`` (its ghost planes filled): ``(q, [Σ p·q, Σ q·q])``,
        the sums this rank's, fp64 and unrounded.  A CPU tensor takes the
        plain version."""
        if p_ext.device.type == "cpu":
            return self.kernel_a_ext_reference(p_ext)
        pl = self.plane
        p = p_ext[pl:pl + self.n]
        lib, ga, gb = self._setup(p)
        dev = p.device
        q = torch.empty_like(p)
        part_a = torch.empty(2 * ga, dtype=torch.float64, device=dev)
        sums = torch.zeros(4, dtype=torch.float64, device=dev)
        ctl = torch.zeros(16, dtype=torch.int32, device=dev)
        f = ctl.view(torch.float32)
        f[_RW] = 1.0                     # one iteration to go: rw > tol = 0
        ctl[_MAXIT] = 1
        with torch.cuda.device(dev):
            self._launch_a(lib, self._a_args(p, q, part_a, ga, None, gb, ctl,
                                             None, sums=sums))
        return q, sums[:2].clone()

    def kernel_b_ext(self, rz, sums_a, x, r, p, q):
        """Kernel B of a shard once, in the cross-rank mode, on copies of
        ``x, r, p``: p·q and q·q from ``sums_a`` (fp64, summed over the
        ranks); ``(x', r', p', [Σ r'², Σ r'²·w])``, the sums this rank's,
        fp64 and unrounded.  A CPU tensor takes the plain version."""
        if x.device.type == "cpu":
            return self.kernel_b_ext_reference(rz, sums_a, x, r, p, q)
        lib, ga, gb = self._setup(x)
        dev = x.device
        x, r, p = x.clone(), r.clone(), p.clone()
        part_b = torch.empty(2 * gb, dtype=torch.float64, device=dev)
        sums = torch.zeros(4, dtype=torch.float64, device=dev)
        sums[:2] = sums_a.to(device=dev, dtype=torch.float64)
        ctl = torch.zeros(16, dtype=torch.int32, device=dev)
        ctl.view(torch.float32)[_N_RZ] = torch.as_tensor(
            rz, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            self._launch_b(lib, self._b_args(x, r, p, q, part_b, ga, part_b,
                                             gb, ctl, None, sums=sums))
        return x, r, p, sums[2:].clone()

    def _kernel_a_call(self, p: torch.Tensor, design: int):
        """One launch of kernel A in its x0 mode (``design``: the redesign,
        counted, or the first design, counted nowhere): ``(q, part_a)``."""
        lib, ga, _ = self._setup(p)
        q = torch.empty_like(p)
        part_a = torch.empty(2 * ga, dtype=torch.float64, device=p.device)
        with torch.cuda.device(p.device):
            self._launch_a(lib, self._a_args(p, q, part_a, ga, None, 1, None,
                                             None, init=1, design=design),
                           count=design == _REDESIGN)
        return q, part_a

    def kernel_b(self, rz, pq, qq, x, r, p, q):
        """Kernel B once on copies of ``x, r, p``: ``(x', r', p', Σ r'²,
        Σ r'²·w)``.  A CPU tensor takes the plain version."""
        if x.device.type == "cpu":
            return self.kernel_b_reference(rz, pq, qq, x, r, p, q)
        lib, args, (x, r, p, part_b) = self._kernel_b_setup(
            rz, pq, qq, x, r, p, q, _REDESIGN)
        with torch.cuda.device(x.device):
            self._launch_b(lib, args)
        gb = part_b.shape[0] // 2
        return (x, r, p, torch.sum(part_b[:gb]).float(),
                torch.sum(part_b[gb:]).float())

    def _kernel_b_setup(self, rz, pq, qq, x, r, p, q, design):
        """Kernel B's library and arguments for one step from ``rz, pq,
        qq`` on copies of ``x, r, p`` (``design``: the redesign reads p·q
        and q·q from the control block, the first design sums them from
        one partial each), and the tensors it writes ``(x, r, p,
        part_b)``."""
        lib, _, gb = self._setup(x)
        dev = x.device
        x, r, p = x.clone(), r.clone(), p.clone()
        part_a = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                              device=dev).reshape(())
                              for v in (pq, qq)]).double()
        part_b = torch.empty(2 * gb, dtype=torch.float64, device=dev)
        ctl = torch.zeros(16, dtype=torch.int32, device=dev)
        f = ctl.view(torch.float32)
        for word, v in ((_N_RZ, rz), (_PQ, pq), (_QQ, qq)):
            f[word] = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return lib, self._b_args(x, r, p, q, part_a, 1, part_b, gb, ctl,
                                 None, design), (x, r, p, part_b)

    # -- chunked-stepping primitives -------------------------------------

    def init(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
             history_len: int = 0) -> FusedState:
        """Initial state from the solve-space right-hand side; ``x0`` goes
        through kernel A (``r₀ = b − Ã·x₀``)."""
        return self._init(b, x0, history_len, self.kernel_a)

    def _init(self, b, x0, history_len, kernel_a) -> FusedState:
        b = b.to(self.dtype)
        if x0 is None:
            x, r = torch.zeros_like(b), b
        else:
            x = x0.to(self.dtype).clone()
            r = b - kernel_a(x)[0]
        if self.shard is not None:
            s, sw = allsum(sums64(r, self.weight), self.shard).float()
        else:
            s, sw = exact_sums(r, self.weight)
        hist = torch.zeros(history_len, dtype=torch.float32, device=b.device)
        if history_len:
            hist[0] = sw
        return FusedState(x=x, r=r, p=r, rz=torch.stack([s, sw]),
                          k=torch.zeros((), dtype=torch.int32,
                                        device=b.device), history=hist)

    def run(self, state: FusedState, upto: int, tol_sq) -> FusedState:
        """Advance until ``k == upto`` or the weighted ``Σr²·w ≤ tol_sq``.
        A CPU state takes the plain version."""
        if state.x.device.type == "cpu":
            return self.run_reference(state, upto, tol_sq)
        return self._run_cuda(state, int(upto), tol_sq)

    def run_reference(self, state: FusedState, upto: int,
                      tol_sq) -> FusedState:
        """Plain version of :meth:`run`: the same two passes as a Python
        loop with one host read per iteration (any device)."""
        x, r, p = state.x, state.r, state.p
        rz, rw = state.rz[0], state.rz[1]
        hist = state.history.clone()
        with annotate(ENGINE):
            k = host_read(state.k, int)
            while k < upto and host_read(rw > tol_sq, bool):
                q, pq, qq = self.kernel_a_reference(p)
                x, r, p, rz, rw = self.kernel_b_reference(rz, pq, qq, x, r,
                                                          p, q)
                k += 1
                if hist.shape[0]:
                    hist[min(k, hist.shape[0] - 1)] = rw
        return FusedState(x=x, r=r, p=p, rz=torch.stack([rz, rw]),
                          k=torch.tensor(k, dtype=torch.int32,
                                         device=x.device), history=hist)

    def result(self, state: FusedState, tol_sq,
               maxiter: Optional[int] = None) -> CGResult:
        """Package a :class:`CGResult`; the history is padded after the
        exit with the final value (a ``cgx.result`` span)."""
        with annotate(RESULT):
            hist = state.history
            if hist.shape[0] > 0 and maxiter is not None:
                idx = torch.arange(maxiter + 1, device=hist.device)
                hist = torch.where(idx <= state.k, hist, state.rz[1])
            return CGResult(x=state.x, iterations=state.k,
                            residual_norm_sq=state.rz[1],
                            converged=state.rz[1] <= tol_sq, history=hist)

    # -- checkpoint interop (flat CGState <-> FusedState) -----------------

    def state_to_flat(self, st: FusedState, e=None):
        """The state as a :class:`cgx_torch.solve.cg.CGState` in the
        original (unscaled) problem space, the form of the checkpoint files
        of every backend (:func:`cgx_torch.utils.checkpoint.to_flat`).
        ``e`` is the Jacobi scaling vector of the DIA transform."""
        from cgx_torch.utils.checkpoint import to_flat

        return to_flat(st.x, st.r, st.p, st.rz[0], st.rz[1], st.k,
                       st.history, e)

    def state_from_flat(self, cg, e=None) -> FusedState:
        """Inverse of :meth:`state_to_flat`: resume from any backend's
        snapshot (:func:`cgx_torch.utils.checkpoint.from_flat`)."""
        from cgx_torch.utils.checkpoint import from_flat

        x, r, p = from_flat(cg, e)
        rz = torch.stack([torch.as_tensor(cg.rz).to(torch.float32),
                          torch.as_tensor(cg.rr).to(torch.float32)])
        return FusedState(x=x.to(self.dtype), r=r.to(self.dtype),
                          p=p.to(self.dtype), rz=rz.to(x.device),
                          k=torch.as_tensor(cg.k).to(torch.int32),
                          history=cg.history.to(torch.float32))

    # -- monolithic solve ---------------------------------------------------

    def solve(self, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
              atol: float = 0.0, maxiter: int = 1000,
              track_history: bool = False) -> CGResult:
        """``cg_solve`` semantics in the solve space (the caller applies
        any scaling)."""
        return self._solve(b, x0, tol, atol, maxiter, track_history,
                           self.kernel_a, self.run)

    def solve_reference(self, b: torch.Tensor, x0=None, *,
                        tol: float = 1e-6, atol: float = 0.0,
                        maxiter: int = 1000,
                        track_history: bool = False) -> CGResult:
        """:meth:`solve` through the plain versions only (any device)."""
        return self._solve(b, x0, tol, atol, maxiter, track_history,
                           self.kernel_a_reference, self.run_reference)

    def _solve(self, b, x0, tol, atol, maxiter, track_history, kernel_a,
               run) -> CGResult:
        maxiter = int(maxiter)
        with annotate(PREP):
            tol_sq = threshold(b, tol, atol, self.weight, self.shard)
            st = self._init(b, x0, maxiter + 1 if track_history else 0,
                            kernel_a)
        st = run(st, maxiter, tol_sq)
        return self.result(st, tol_sq, maxiter)

    # -- the CUDA path --------------------------------------------------------

    def _setup(self, v: torch.Tensor):
        """Checks, the library and the grids ``(lib, grid_a, grid_b)``."""
        from cgx_torch.kernels.stencil import check_cuda_vector

        if v.device.type != "cuda":
            raise ValueError(f"FusedCG: unsupported device {v.device}")
        check_cuda_vector(v, self.n, "FusedCG", self.dtype)
        if self.planes is not None and self.plane_dtype not in (
                torch.bfloat16, self.dtype):
            raise ValueError(f"FusedCG: the CUDA kernels take {self.dtype} "
                             f"vectors with {self.dtype} or bfloat16 planes, "
                             f"not {self.plane_dtype} planes")
        for t, name, dt in ((self.planes, "planes", self.plane_dtype),
                            (self.weight, "weight", self.dtype)):
            if t is not None and (t.device != v.device or t.dtype != dt):
                raise ValueError(f"FusedCG: {name} must be {dt} on "
                                 f"{v.device}, got {t.dtype} on {t.device}")
        return (_build.library(),) + self.grids(v.device)

    def grids(self, device: torch.device) -> Tuple[int, int]:
        """The grids of kernels A and B on ``device`` (as many blocks as
        fit at once): the partition of the iteration's sums, which the
        semi-resident and one-pass kernels (K4, K6) take over to equal
        this engine bit for bit."""
        lib = _build.library()
        ga, gb = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib.cgx_fused_a_grid(
            device.index, len(self.taps), int(self.planes is not None),
            int(self.sym), *self._bf16_flags(), ctypes.byref(ga)),
            "fused kernel A occupancy")
        _build.check(lib.cgx_fused_b_grid(
            device.index, int(self.weight is not None),
            self._bf16_flags()[0], ctypes.byref(gb)),
            "fused kernel B occupancy")
        return ga.value, gb.value

    def _bf16_flags(self):
        """``(vec_bf16, plane_bf16)`` for the C entry points."""
        return (int(self.dtype == torch.bfloat16),
                int(self.plane_dtype == torch.bfloat16))

    def a_launch_grid(self, device: torch.device, ga: int) -> int:
        """``kernel_a2``'s own grid: as many blocks as fit at once, at most
        ``ga``, and then as few as keep the same number of K3's virtual
        blocks (of ``ga``) in every block."""
        lib = _build.library()
        fit = ctypes.c_int(0)
        _build.check(lib.cgx_fused_a_fit(
            device.index, len(self.taps), int(self.planes is not None),
            int(self.sym), *self._bf16_flags(), ctypes.byref(fit)),
            "fused kernel A occupancy (redesign)")
        return even_grid(ga, fit.value)

    def _planes_ptr(self):
        """The planes the kernels read: their first local row (past the
        ghost plane in a shard's symmetric mode), or None."""
        if self.planes_ext is not None:
            return (self.planes_ext.data_ptr()
                    + self.plane * self.planes_ext.element_size())
        return None if self.planes is None else self.planes.data_ptr()

    def _span_arg(self):
        """``cgx::Span`` for the C entries: None for a whole grid."""
        if self.shard is None:
            return None
        return (ctypes.c_int * 5)(*self.span())

    def _a_args(self, p, q, part_a, ga, part_b, gb, ctl, hist, init=0,
                design=_REDESIGN, sums=None):
        """Kernel A's C arguments; ``p`` the first local row of a shard's
        extended buffer, ``sums`` the cross-rank sums (or None)."""
        taps_c, coef_c, plane_c = plane_tap_arrays(self.taps, self.coeffs)
        ptr = (lambda t: None if t is None else t.data_ptr())
        grid = (self.a_launch_grid(p.device, ga) if design == _REDESIGN
                else ga)
        return (p.data_ptr(), q.data_ptr(), self._planes_ptr(),
                part_a.data_ptr(), ga, ptr(part_b), gb, ptr(ctl), ptr(hist),
                init, self.nx, self.ny, self.nz, len(self.taps), taps_c,
                coef_c, plane_c, int(self.sym), *self._bf16_flags(), design,
                grid, self._span_arg(), ptr(sums),
                torch.cuda.current_stream(p.device).cuda_stream)

    def _b_args(self, x, r, p, q, part_a, ga, part_b, gb, ctl, hist,
                design=_REDESIGN, sums=None):
        if design == _REDESIGN:
            check_no_alias("FusedCG kernel B", x=x, r=r, p=p, q=q,
                           w=self.weight)
        return (x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
                None if self.weight is None else self.weight.data_ptr(),
                part_a.data_ptr(), ga, part_b.data_ptr(), gb,
                ctl.data_ptr(), None if hist is None else hist.data_ptr(),
                self.n, self._bf16_flags()[0], design,
                None if sums is None else sums.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)

    def _launch_a(self, lib, args, count: bool = True) -> None:
        global fused_a_launches, fused_a_bf16_launches
        global fused_a_bf16_planes_launches
        _build.check(lib.cgx_fused_a(*args), "fused kernel A launch")
        if not count:
            return
        fused_a_launches += 1
        vec_bf16, plane_bf16 = self._bf16_flags()
        if vec_bf16:
            fused_a_bf16_launches += 1
        elif plane_bf16 and self.planes is not None:
            fused_a_bf16_planes_launches += 1

    def _launch_b(self, lib, args, count: bool = True) -> None:
        global fused_b_launches, fused_b_bf16_launches
        _build.check(lib.cgx_fused_b(*args), "fused kernel B launch")
        if not count:
            return
        fused_b_launches += 1
        if self._bf16_flags()[0]:
            fused_b_bf16_launches += 1

    def _run_cuda(self, state: FusedState, upto: int, tol_sq,
                  design: int = _REDESIGN) -> FusedState:
        from cgx_torch.kernels.stencil import check_cuda_vector

        with annotate(PREP):
            lib, ga, gb = self._setup(state.x)
            dev = state.x.device
            for v, name in ((state.r, "r"), (state.p, "p")):
                check_cuda_vector(v, self.n, f"FusedCG state {name}",
                                  self.dtype)
            x, r = state.x.clone(), state.r.clone()
            sh, pl, sums = self.shard, self.plane, None
            if sh is not None:
                # The cross-rank mode: p in the ghost layout, fp64 sums.
                if design != _REDESIGN or (sh.group is None and sh.size > 1):
                    raise ValueError("FusedCG: a shard runs the redesigned "
                                     "kernels over its process group")
                from cgx_torch.dist import halo

                p_ext = torch.zeros(self.n + 2 * pl, dtype=self.dtype,
                                    device=dev)
                p = p_ext[pl:pl + self.n]
                p.copy_(state.p)
                sums = torch.zeros(4, dtype=torch.float64, device=dev)
            else:
                p = state.p.clone()
            q = torch.empty_like(x)
            part_a = torch.empty(2 * ga, dtype=torch.float64, device=dev)
            part_b = torch.empty(2 * gb, dtype=torch.float64, device=dev)
            hist = state.history.to(torch.float32).clone()
            ctl = torch.zeros(16, dtype=torch.int32, device=dev)
            f = ctl.view(torch.float32)
            f[_RZ:_RW + 1] = state.rz.to(torch.float32)
            ctl[_K] = state.k.to(torch.int32)
            f[_TOL] = torch.as_tensor(tol_sq, dtype=torch.float32,
                                      device=dev)
            ctl[_MAXIT] = min(upto, 2 ** 31 - 1)
            ctl[_HLEN] = hist.shape[0]
            hist_or_none = hist if hist.shape[0] else None
            args_a = self._a_args(p, q, part_a, ga, part_b, gb, ctl,
                                  hist_or_none, design=design, sums=sums)
            args_b = self._b_args(x, r, p, q, part_a, ga, part_b, gb, ctl,
                                  hist_or_none, design=design, sums=sums)
            count = design == _REDESIGN
            # At most upto − k + 1 (A, B) pairs: the last A takes the exit.
            budget, launched = max(upto, 0) + 1, 0
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
                    halo.all_reduce(sums[:2], sh.group)
                    self._launch_b(lib, args_b, count)
                    halo.all_reduce(sums[2:], sh.group)
                launched += chunk
                if host_read(ctl[_DONE], int):
                    break
                if launched >= budget:
                    raise RuntimeError("FusedCG: the kernels did not reach "
                                       "their exit")
        return FusedState(x=x, r=r, p=p, rz=f[_RZ:_RW + 1].clone(),
                          k=ctl[_K].clone(), history=hist)


def _before_kernel_a(eng: FusedCG, p: torch.Tensor):
    """The first kernel A once (the same-run "before" of ``kernel_a2``,
    counted nowhere): ``(q, part_a)`` over K3's partition."""
    return eng._kernel_a_call(p, design=_FIRST_DESIGN)


def _before_solve(eng: FusedCG, b: torch.Tensor, x0=None, *,
                  tol: float = 1e-6, atol: float = 0.0, maxiter: int = 1000,
                  track_history: bool = False) -> CGResult:
    """:meth:`FusedCG.solve` through the first design of kernels A and B
    (the same-run "before", counted nowhere)."""
    return eng._solve(b, x0, tol, atol, maxiter, track_history,
                      lambda v: eng._kernel_a_call(
                          v, design=_FIRST_DESIGN)[:1],
                      lambda st, upto, tol_sq: eng._run_cuda(
                          st, upto, tol_sq, design=_FIRST_DESIGN))

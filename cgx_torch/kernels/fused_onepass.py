"""K6: the one-pass CG iteration — CUDA kernel + plain version.

Counterpart of :mod:`cgx.kernels.fused_onepass` (``OnePassCG``): each
iteration is one kernel launch that never stores ``q = A·p``.  With the
carried sums ``[Σr², Σr²·w, p·Ap, ‖Ap‖²]`` of the previous iteration it
computes α and β (the two-pass engine's algebra), ``q = A·p``, ``x' = x +
αp``, ``r' = r − αq``, ``p' = r' + βp``, then ``w = A·p'`` and the next
sums ``[Σr'², Σr'², p'·w, w·w]``.  Constant taps and float32 vectors only,
as in the JAX package; operators with coefficient planes keep the
two-pass engine.

The launch is cooperative, with one grid-wide barrier between the update
and the second apply; r and p ping-pong between two buffers (see
``cgx_torch/csrc/onepass.cu``).  The sums are exact and taken over the
two-pass engine's partition, so on the card the one-pass solve equals
``fused_stencil_cg`` (K3) bit for bit — x, the iteration count and the
history.  The kernel holds K3's occupancy, and :func:`launch_grid` picks
its grid so that every block sweeps as many of K3's virtual blocks as
every other.  The plain version, :meth:`OnePassCG.run_reference`, is the
same iteration through K3's plain kernels.

The stepping surface is :class:`~cgx_torch.kernels.fused_engine.FusedCG`'s
(``init``/``run``/``result``/``solve``); the carried ``rz`` widens to
``(4,)``.  The Gram numbers of the start state come from one launch of
K3's kernel A at init, never in the loop.  ``state_to_flat`` and
``state_from_flat`` wait for the checkpoint slice, as K3's do.
``onepass_launches`` counts the kernel's launches.  The kernel of the
first design (its own occupancy grid, every block folding the partials)
stays as the same-run "before" (:func:`_before_solve`, CUDA only, counted
nowhere).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cgx_torch.kernels import _build
from cgx_torch.kernels.fused_engine import CHUNK, FusedCG, FusedState
from cgx_torch.utils.profiling import host_read

__all__ = ["OnePassCG", "onepass_launches", "launch_grid", "STREAMS",
           "DEVICE_STREAMS"]

# Kernel launches so far (a run resets it to show which kernels it used).
onepass_launches = 0

# The kernels of onepass.cu (its `design`): the first design, kept as the
# same-run "before", and the redesign.
_FIRST_DESIGN, _REDESIGN = 0, 1

# Vector streams of n floats an iteration: the function reads x, r, p and
# writes x, r', p' (the bound); the kernel also reads p' again in the
# second apply.
STREAMS = 6
DEVICE_STREAMS = 7


def launch_grid(ga: int, gb: int, cap: int, sms: int) -> int:
    """The grid of the kernel over K3's partitions of ``ga`` (second
    apply) and ``gb`` (update) virtual blocks; ``cap``: the blocks that fit
    on the card at once; ``sms``: the card's SMs.

    A sweep over g virtual blocks takes ⌈g / grid⌉ rounds, and a grid
    costs its rounds times its blocks: the grid with the fewest such slots
    wins, the one closest to every block sweeping the same number of
    virtual blocks (none idle when the grid divides ga and gb).  Ties go
    to the larger grid.  A grid keeps at least half of K3's parallelism
    (2·grid ≥ max(ga, gb)) and a block per SM."""
    best = None
    for grid in range(min(sms, cap), cap + 1):
        if 2 * grid < max(ga, gb):
            continue
        key = (grid * (-(-ga // grid) + -(-gb // grid)), -grid)
        if best is None or key < best[0]:
            best = (key, grid)
    if best is None:
        raise ValueError(f"one-pass engine: no grid for K3's grids {ga}, "
                         f"{gb} within {cap} blocks")
    return best[1]


_cached_shape = functools.lru_cache(maxsize=None)(launch_grid)

# Words of the device control block (the struct Ctl in onepass.cu).
_RZ, _QQ, _K, _PENDING, _DONE, _TOL, _MAXIT, _HLEN = 0, 3, 4, 5, 6, 7, 8, 9


class OnePassCG(FusedCG):
    """The one-pass solver for one constant-coefficient operator (see the
    module docstring); the arguments are :class:`FusedCG`'s."""

    def __init__(self, nx: int, ny: int, nz: int, taps, *,
                 dtype=torch.float32, coeffs=None):
        if coeffs is None or any(c is None for c in coeffs):
            raise ValueError("one-pass engine: constant-coefficient taps "
                             "only (DIA planes keep the two-pass engine)")
        if dtype != torch.float32:
            raise ValueError(f"one-pass engine: float32 vectors only, not "
                             f"{dtype}")
        super().__init__(nx, ny, nz, taps, dtype=dtype, coeffs=coeffs)

    # -- state --------------------------------------------------------------

    def _init(self, b, x0, history_len, kernel_a) -> FusedState:
        """The two-pass start state, widened with the Gram numbers of its
        p (one kernel-A call: init and resume only, never in the loop)."""
        st = super()._init(b, x0, history_len, kernel_a)
        _, pq, qq = kernel_a(st.p)
        return dataclasses.replace(
            st, rz=torch.cat([st.rz, torch.stack([pq, qq])]))

    # -- one iteration ----------------------------------------------------

    def kernel_c_reference(self, dots, x, r, p):
        """Plain iteration: ``(x', r', p', dots')`` from ``dots = [Σr²,
        Σr²·w, p·Ap, ‖Ap‖²]``, through K3's plain kernels."""
        q = self.matvec(p)
        x, r, p, rz, rw = self.kernel_b_reference(dots[0], dots[2], dots[3],
                                                  x, r, p, q)
        _, pq, qq = self.kernel_a_reference(p)
        return x, r, p, torch.stack([rz, rw, pq, qq])

    def kernel_c(self, dots, x, r, p):
        """One launch on copies of ``x, r, p``: ``(x', r', p', dots')``.
        A CPU tensor takes the plain version."""
        if x.device.type == "cpu":
            return self.kernel_c_reference(dots, x, r, p)
        st = FusedState(x=x, r=r, p=p, rz=dots.to(torch.float32),
                        k=torch.zeros((), dtype=torch.int32,
                                      device=x.device),
                        history=torch.zeros(0, device=x.device))
        out = self._run_cuda(st, 1, torch.tensor(-1.0, device=x.device))
        return out.x, out.r, out.p, out.rz

    # -- the loop -----------------------------------------------------------

    def run(self, state: FusedState, upto: int, tol_sq) -> FusedState:
        """Advance until ``k == upto`` or ``Σr²·w ≤ tol_sq``; a CPU state
        takes the plain version."""
        if state.x.device.type == "cpu":
            return self.run_reference(state, upto, tol_sq)
        return self._run_cuda(state, int(upto), tol_sq)

    def run_reference(self, state: FusedState, upto: int,
                      tol_sq) -> FusedState:
        """Plain version of :meth:`run`: one host read per iteration."""
        x, r, p, dots = state.x, state.r, state.p, state.rz
        hist = state.history.clone()
        k = host_read(state.k, int)
        while k < upto and host_read(dots[1] > tol_sq, bool):
            x, r, p, dots = self.kernel_c_reference(dots, x, r, p)
            k += 1
            if hist.shape[0]:
                hist[min(k, hist.shape[0] - 1)] = dots[1]
        return FusedState(x=x, r=r, p=p, rz=dots,
                          k=torch.tensor(k, dtype=torch.int32,
                                         device=x.device), history=hist)

    def shape(self, device: torch.device):
        """``(grid, ga, gb)``: the grid :func:`launch_grid` picks on
        ``device`` beside K3's grids."""
        ga, gb = self.grids(device)
        return self._shape(_build.library(), device, ga, gb), ga, gb

    def _shape(self, lib, device, ga, gb) -> int:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return _cached_shape(ga, gb, self._occupancy(lib, device, _REDESIGN),
                             sms)

    def _occupancy(self, lib, device, design) -> int:
        grid = ctypes.c_int(0)
        _build.check(lib.cgx_onepass_grid(device.index, len(self.taps),
                                          design, ctypes.byref(grid)),
                     "one-pass kernel occupancy")
        return grid.value

    def _run_cuda(self, state: FusedState, upto: int, tol_sq,
                  design: int = _REDESIGN) -> FusedState:
        global onepass_launches
        from cgx_torch.kernels.stencil import check_cuda_vector, tap_arrays

        lib, ga, gb = self._setup(state.x)
        dev = state.x.device
        for v, name in ((state.r, "r"), (state.p, "p")):
            check_cuda_vector(v, self.n, f"OnePassCG state {name}")
        if design == _REDESIGN:
            grid = self._shape(lib, dev, ga, gb)
        else:
            grid = self._occupancy(lib, dev, _FIRST_DESIGN)
        k0 = host_read(state.k, int)
        x = state.x.clone()
        # Iterate k lives in buffer k & 1 of r and of p.
        rb = [torch.empty_like(x), torch.empty_like(x)]
        pb = [torch.empty_like(x), torch.empty_like(x)]
        rb[k0 & 1].copy_(state.r)
        pb[k0 & 1].copy_(state.p)
        part_a = torch.empty(4 * ga, dtype=torch.float64, device=dev)
        part_b = torch.empty(4 * gb, dtype=torch.float64, device=dev)
        hist = state.history.to(torch.float32).clone()
        ctl = torch.zeros(16, dtype=torch.int32, device=dev)
        f = ctl.view(torch.float32)
        f[_RZ:_QQ + 1] = state.rz.to(torch.float32)
        ctl[_K] = k0
        f[_TOL] = torch.as_tensor(tol_sq, dtype=torch.float32, device=dev)
        ctl[_MAXIT] = min(upto, 2 ** 31 - 1)
        ctl[_HLEN] = hist.shape[0]
        taps_c, coef_c = tap_arrays(self.taps, self.coeffs)
        args = (x.data_ptr(), rb[0].data_ptr(), rb[1].data_ptr(),
                pb[0].data_ptr(), pb[1].data_ptr(), part_a.data_ptr(), ga,
                part_b.data_ptr(), gb, grid, design, ctl.data_ptr(),
                hist.data_ptr() if hist.shape[0] else None, self.nx,
                self.ny, self.nz, len(self.taps), taps_c, coef_c,
                torch.cuda.current_stream(dev).cuda_stream)
        # At most upto − k0 + 1 launches: the last one takes the exit.
        budget, launched = max(upto - k0, 0) + 1, 0
        with torch.cuda.device(dev):
            while True:
                chunk = min(CHUNK, budget - launched)
                for _ in range(chunk):
                    _build.check(lib.cgx_onepass(*args),
                                 "one-pass kernel launch")
                    if design == _REDESIGN:
                        onepass_launches += 1
                launched += chunk
                if host_read(ctl[_DONE], int):
                    break
                if launched >= budget:
                    raise RuntimeError("OnePassCG: the kernel did not reach "
                                       "its exit")
        k = host_read(ctl[_K], int)
        return FusedState(x=x, r=rb[k & 1], p=pb[k & 1],
                          rz=f[_RZ:_QQ + 1].clone(), k=ctl[_K].clone(),
                          history=hist)


def _before_solve(eng: OnePassCG, b: torch.Tensor, *, tol: float = 1e-6,
                  maxiter: int = 1000, track_history: bool = False):
    """:meth:`OnePassCG.solve` through the first design's kernel: the
    same-run "before" of the tests and the smoke.  CUDA only; no launch
    counter counts it."""
    if b.device.type != "cuda":
        raise ValueError("the first one-pass kernel runs on CUDA tensors only")
    return eng._solve(b, None, tol, 0.0, maxiter, track_history,
                      eng.kernel_a,
                      lambda st, upto, tol_sq: eng._run_cuda(
                          st, int(upto), tol_sq, design=_FIRST_DESIGN))

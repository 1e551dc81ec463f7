"""High-accuracy CG: df64 solves for the reference's fp64 envelope (PyTorch).

Counterpart of :mod:`cgx.solve.hp`.  On κ ≈ 10¹⁰ SPD systems (the
bcsstk shell-stiffness class) fp32 CG cannot reach a true relative
residual of 1e-6: its recurrence stalls near ``eps₃₂·κ``.  This module
closes the gap with double-word fp32 arithmetic (:mod:`cgx_torch.ops.df64`,
about 2⁻⁴⁸ effective precision) in two forms:

* :func:`df64_cg_solve` — the whole Krylov iteration in df64 over a
  fixed-width ELL operator (:class:`DF64ELL`), its row sums a pairwise
  fold of elementwise double-word adds.  The ``lax.while_loop`` of the JAX
  package is a Python loop here, reading ``rr > tol_sq`` from the device
  once an iteration.
* :func:`make_ir_df64_solver` / :func:`ir_df64_solve` — fp32 (P)CG inner
  solves (``"ell"``, ``"csr"`` or ``"wbell"``, the last over K7) inside a
  df64 iterative-refinement outer loop.  The iterate and the true residual
  live in df64, so each outer cycle contracts the TRUE residual by the
  inner solve's reduction (Higham/Carson mixed-precision IR): accuracy is
  set by df64, speed by fp32.  :func:`make_ir_df64_solver_multi` refines
  a block of right-hand sides over batched WBELL inners (K8 over a tier
  plan).

The df64 products and folds are torch ops, not kernels (the JAX package
has no Pallas kernel for them either); the inner solves run the port's
CUDA kernels.  The outer loop reads the device once a cycle.  The JAX
package's module-level jits (``_ir_inner``, ``_ir_true_residual*``) are
plain calls here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cgx_torch.ops.df64 import (DF64, _fold_axis, df, df_add, df_axpy,
                                df_div, df_dot, df_from_f64, df_mul,
                                df_neg, df_sub, quick_two_sum, two_prod)
from cgx_torch.sparse.types import resolve_device
from cgx_torch.sparse.wbell import _host

__all__ = ["DF64ELL", "df64_ell_from_csr", "df64_ell_spmv",
           "df64_ell_spmm", "HPCGResult", "df64_cg_solve",
           "df64_col_norm_sq", "ir_df64_solve", "make_ir_df64_solver",
           "make_ir_df64_solver_multi", "IRDF64Operator"]


@dataclass(frozen=True, eq=False)
class DF64ELL:
    """Row-padded ELL matrix with df64 values: ``vhi + vlo`` is the exact
    split of the host fp64 data, so a solve targets the true system, not
    its fp32 rounding.  Padding slots hold 0 and the row's own column."""

    vhi: torch.Tensor          # (n, width) fp32
    vlo: torch.Tensor          # (n, width) fp32
    col_indices: torch.Tensor  # (n, width) int64
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return self.vhi.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vhi.device

    def diagonal_df(self) -> DF64:
        """The df64 diagonal (for Jacobi scaling in the df64 loop)."""
        n = self.shape[0]
        rows = torch.arange(n, device=self.device)[:, None]
        mask = self.col_indices == rows
        return DF64(torch.where(mask, self.vhi, 0.0).sum(dim=1),
                    torch.where(mask, self.vlo, 0.0).sum(dim=1))


def _scipy_f64(a):
    """A CSR container (the port's or ``cgx``'s) or a scipy matrix as a
    host fp64 ``scipy.sparse.csr_matrix``."""
    import scipy.sparse as sp

    if hasattr(a, "indptr") and hasattr(a, "col_indices"):
        return sp.csr_matrix((_host(a.values).astype(np.float64),
                              _host(a.col_indices), _host(a.indptr)),
                             shape=tuple(int(s) for s in a.shape))
    return sp.csr_matrix(a).astype(np.float64)


def df64_ell_from_csr(a, width_multiple: int = 8,
                      device="cuda") -> DF64ELL:
    """Build a :class:`DF64ELL` on ``device`` from host fp64 CSR data (a
    CSR container or a ``scipy.sparse`` matrix)."""
    a = _scipy_f64(a)
    n = a.shape[0]
    counts = np.diff(a.indptr)
    w = max(1, -(-int(counts.max()) // width_multiple) * width_multiple)
    vals64 = np.zeros((n, w), np.float64)
    cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, w))
    offs = (np.concatenate([np.arange(c) for c in counts])
            if a.nnz else np.zeros(0, np.int64))
    rows = np.repeat(np.arange(n), counts)
    vals64[rows, offs] = a.data
    cols[rows, offs] = a.indices
    vhi = vals64.astype(np.float32)
    vlo = (vals64 - vhi.astype(np.float64)).astype(np.float32)
    dev = resolve_device(device)
    return DF64ELL(vhi=torch.from_numpy(vhi).to(dev),
                   vlo=torch.from_numpy(vlo).to(dev),
                   col_indices=torch.from_numpy(cols).to(dev),
                   shape=(int(a.shape[0]), int(a.shape[1])))


def df64_ell_spmv(a: DF64ELL, x: DF64) -> DF64:
    """``y = A·x`` in df64: error-free products of each slot, the three
    cross terms, then a pairwise double-word fold along the width."""
    xh = x.hi[a.col_indices]           # (n, w) gathers
    xl = x.lo[a.col_indices]
    p, e = two_prod(a.vhi, xh)
    e = e + (a.vhi * xl + a.vlo * xh + a.vlo * xl)
    p, e = quick_two_sum(p, e)
    return _fold_axis(DF64(p, e), axis=1)


def df64_ell_spmm(a: DF64ELL, x: DF64) -> DF64:
    """Batched ``Y = A·X`` in df64 for an ``(n, k)`` df64 block (the
    multi-RHS true residual's operator: one gather serves every column)."""
    xh = x.hi[a.col_indices]           # (n, w, k)
    xl = x.lo[a.col_indices]
    vh = a.vhi[:, :, None]
    vl = a.vlo[:, :, None]
    p, e = two_prod(vh, xh)
    e = e + (vh * xl + vl * xh + vl * xl)
    p, e = quick_two_sum(p, e)
    return _fold_axis(DF64(p, e), axis=1)


def _true_residual(a_hp: DF64ELL, b_df: DF64, x: DF64) -> DF64:
    """The TRUE df64 residual ``b − A·x`` (one vector or an (n, k) block)."""
    ax = df64_ell_spmv(a_hp, x) if x.hi.dim() == 1 else df64_ell_spmm(a_hp,
                                                                      x)
    return df_sub(b_df, ax)


@dataclass(frozen=True, eq=False)
class HPCGResult:
    """df64 solver output.  ``x`` is the double-word iterate; its host fp64
    view is :func:`cgx_torch.ops.df64.df_to_f64`."""

    x: DF64
    iterations: torch.Tensor
    residual_norm_sq: torch.Tensor   # fp32 hi word of the df64 ‖r‖²
    converged: torch.Tensor

    @property
    def residual_norm(self) -> torch.Tensor:
        return torch.sqrt(self.residual_norm_sq)


def df64_cg_solve(a: DF64ELL, b, x0: Optional[DF64] = None, *,
                  tol: float = 1e-6, atol: float = 0.0,
                  maxiter: int = 10_000, jacobi: bool = False
                  ) -> HPCGResult:
    """(P)CG with every vector, product and reduction in df64.

    ``b``: a host fp64 array or a :class:`DF64` (on the operator's device).
    ``jacobi=True`` applies the df64 diagonal scaling ``z = D⁻¹r`` inside
    the loop.  Exits on ``‖r‖² ≤ max(tol²·‖b‖², atol²)`` (fp32 hi words of
    the df64 norms) or at ``maxiter``, as :func:`cgx.solve.hp.
    df64_cg_solve` does; the exit test is read from the device once an
    iteration.
    """
    dev = a.device
    b_df = b if isinstance(b, DF64) else df_from_f64(b, device=dev)
    n = b_df.hi.shape[0]

    inv_diag = None
    if jacobi:
        d = a.diagonal_df()
        inv_diag = df_div(df(torch.ones_like(d.hi)), d)

    def apply_m(r):
        return df_mul(inv_diag, r) if jacobi else r

    if x0 is None:
        x = DF64(torch.zeros(n, dtype=torch.float32, device=dev),
                 torch.zeros(n, dtype=torch.float32, device=dev))
        r = b_df
    else:
        x = x0
        r = df_sub(b_df, df64_ell_spmv(a, x))
    z = apply_m(r)
    p = z
    rz = df_dot(r, z)
    rr = df_dot(r, r).hi

    bb = df_dot(b_df, b_df).hi
    t = torch.tensor(tol, dtype=torch.float32, device=dev)
    at = torch.tensor(atol, dtype=torch.float32, device=dev)
    tol_sq = torch.maximum(t * t * bb, at * at)

    maxiter = int(maxiter)
    k = 0
    while k < maxiter and bool(rr > tol_sq):
        q = df64_ell_spmv(a, p)
        alpha = df_div(rz, df_dot(p, q))
        x = df_axpy(alpha, p, x)
        r = df_axpy(df_neg(alpha), q, r)
        z = apply_m(r)
        rz_new = df_dot(r, z)
        beta = df_div(rz_new, rz)
        p = df_axpy(beta, p, z)
        rz, rr = rz_new, df_dot(r, r).hi
        k += 1
    return HPCGResult(x=x, iterations=torch.tensor(k, dtype=torch.int32,
                                                   device=dev),
                      residual_norm_sq=rr, converged=rr <= tol_sq)


def df64_col_norm_sq(r: DF64) -> np.ndarray:
    """Per-column df64 ``‖r‖²`` of an (n, k) df64 block → host fp64 (k,)
    (a pairwise double-word fold down the rows)."""
    s = _fold_axis(df_mul(r, r), axis=0)
    return (s.hi.detach().cpu().numpy().astype(np.float64)
            + s.lo.detach().cpu().numpy().astype(np.float64))


def _pick_inner_format(a_sp, *, allow_wbell: bool = True,
                       device="cuda") -> str:
    """``inner_format="auto"``: the decision of
    :func:`cgx_torch.sparse.wbell.pick_format` (the one surface
    ``auto_format`` uses too): WBELL only for a large irregular matrix on
    the card."""
    from cgx_torch.sparse.wbell import pick_format

    return pick_format(a_sp, allow_wbell=allow_wbell, device=device)


def _make_wbell_inner(a_sp, preconditioner, *, inner_tol, inner_maxiter,
                      inner_chunk, wb=None, device="cuda"):
    """The WBELL fp32 inner solve of the refinement: ``(inner, wb)`` with
    ``inner(r_unit) -> (d_unit, iterations)``.

    The inner operator is the fp32-rounded matrix, which is enough for
    refinement (the inner solve only contracts the residual; the df64 true
    residual sets the accuracy), and it runs through K7.  Raises
    ``ValueError`` when the preconditioner is neither None nor Jacobi, or
    when the matrix has no bounded-window tiling.  ``inner_chunk`` runs
    each inner solve in chunks of that many iterations
    (:func:`cgx_torch.utils.checkpoint.make_checkpointed_solver`).
    """
    from cgx_torch.ops.blas import safe_recip
    from cgx_torch.solve.precond import JacobiPrecond
    from cgx_torch.solve.wbell import wbell_cg_solve
    from cgx_torch.sparse.wbell import wbell_from_csr

    if preconditioner is not None and not isinstance(preconditioner,
                                                     JacobiPrecond):
        raise ValueError(
            "inner_format='wbell' supports preconditioner=None or "
            "JacobiPrecond (the WBELL internal-layout surface); for "
            "IC(0)/block-Jacobi inners use inner_format='ell'")
    jac = preconditioner is not None
    ivd = preconditioner.inv_diag if jac else None
    if wb is None:
        wb = wbell_from_csr(a_sp, device=device)

    if inner_chunk is None:
        def inner(r_unit):
            res = wbell_cg_solve(wb, r_unit, tol=inner_tol,
                                 maxiter=inner_maxiter, jacobi=jac,
                                 inv_diag=ivd)
            return res.x, res.iterations
        return inner, wb

    from cgx_torch.utils.checkpoint import make_checkpointed_solver
    idi = None
    if jac:
        idi = (wb.to_internal(ivd) if ivd is not None
               else safe_recip(wb.diag_internal))
    solve = make_checkpointed_solver(
        wb, tol=inner_tol, maxiter=inner_maxiter, chunk=int(inner_chunk),
        preconditioner=(lambda r: r * idi) if jac else None)

    def inner(r_unit):
        res = solve(wb.to_internal(r_unit))
        return wb.from_internal(res.x), res.iterations
    return inner, wb


@dataclass(frozen=True, eq=False)
class IRDF64Operator:
    """The persistable operator state of an IR-df64 solver: the exact df64
    ELL split (the true residual's operator), the fp32 WBELL operator of
    the inners, and the fp64 diagonal (to rebuild a Jacobi inner without
    the CSR).  Build once, save with
    :func:`cgx_torch.io.native_format.save_df64_operator`, reuse across
    processes (``prebuilt=``)."""

    a_hp: DF64ELL
    wb: object                 # WBELLMatrix, or None (an ELL-only bundle)
    diag: np.ndarray           # (n,) fp64 matrix diagonal


def make_ir_df64_solver(a=None, *, tol: float = 1e-6, atol: float = 0.0,
                        inner_tol: float = 1e-2, inner_maxiter: int = 2000,
                        max_outer: int = 40, preconditioner=None,
                        inner_format: str = "ell",
                        inner_chunk: Optional[int] = None,
                        prebuilt: Optional[IRDF64Operator] = None,
                        save_to: Optional[str] = None,
                        verbose: bool = False, device="cuda"):
    """Factory for fp32 (P)CG inner solves inside a df64 iterative-
    refinement outer loop; returns ``solve(b, x0=None) -> (HPCGResult,
    info)``.  The host builds (the df64 ELL split, and the WBELL build for
    ``"wbell"``) are paid once here; each ``solve(b)`` reuses them.

    Args:
      a: host fp64 CSR (a CSR container or scipy); not needed with
        ``prebuilt``.
      preconditioner: a port preconditioner for the fp32 inners (IC(0)
        suits the bcsstk class).  With a WBELL inner it must be None or
        :class:`~cgx_torch.solve.precond.JacobiPrecond`.
      inner_format: ``"ell"`` (default), ``"csr"``, ``"wbell"`` (K7), or
        ``"auto"`` (:func:`~cgx_torch.sparse.wbell.pick_format`; when the
        matrix has no bounded-window tiling it decides again without
        WBELL).
      inner_tol: residual reduction per inner solve, which is the per-cycle
        contraction of the TRUE residual.
      inner_chunk: run each inner solve in chunks of this many iterations
        (:mod:`cgx_torch.utils.checkpoint`); the trajectory is the
        monolithic one.
      prebuilt: an :class:`IRDF64Operator` (e.g. from
        :func:`~cgx_torch.io.native_format.load_df64_operator`): no CSR, no
        host build; needs its WBELL operator.
      save_to: persist the WBELL + df64 bundle there (a WBELL inner only).
      device: where the operators live (the card unless the caller asks
        for the CPU); ignored with ``prebuilt``, which keeps its own.

    ``info["outer"]`` is the cycle count, ``info["relres"]`` the final TRUE
    df64 relative residual, ``info["inner_iterations"]`` (also the
    result's ``iterations``) the total of inner iterations.
    """
    from cgx_torch.solve.cg import cg_solve
    from cgx_torch.sparse.types import csr_from_scipy, ell_from_csr

    if prebuilt is not None:
        if prebuilt.wb is None:
            raise ValueError("prebuilt IRDF64Operator has no WBELL "
                             "operator; rebuild from the CSR source")
        a_hp = prebuilt.a_hp
        inner, _ = _make_wbell_inner(
            None, preconditioner, inner_tol=float(inner_tol),
            inner_maxiter=int(inner_maxiter), inner_chunk=inner_chunk,
            wb=prebuilt.wb)
        return _ir_df64_loop(a_hp, inner, a_hp.shape[0], tol=tol,
                             atol=atol, max_outer=max_outer,
                             verbose=verbose)

    a_sp = _scipy_f64(a)
    dev = resolve_device(device)
    was_auto = inner_format == "auto"
    if was_auto:
        inner_format = _pick_inner_format(a_sp, device=dev)
        if verbose:
            print(f"[ir_df64] inner_format auto -> {inner_format}")

    a_hp = df64_ell_from_csr(a_sp, device=dev)
    wb_built = None
    if inner_format == "wbell":
        try:
            inner, wb_built = _make_wbell_inner(
                a_sp, preconditioner, inner_tol=float(inner_tol),
                inner_maxiter=int(inner_maxiter), inner_chunk=inner_chunk,
                device=dev)
        except ValueError:
            if not was_auto:
                raise          # an explicit wbell request keeps its reason
            # auto, and no bounded-window tiling: decide again without
            # WBELL (ELL if its padding is acceptable, else CSR).
            inner_format = _pick_inner_format(a_sp, allow_wbell=False,
                                              device=dev)
    if save_to:
        if wb_built is None:
            raise ValueError(
                "save_to persists the WBELL+df64 operator bundle; this "
                f"solver resolved inner_format={inner_format!r} (the "
                "ell/csr builds are seconds — nothing worth persisting)")
        from cgx_torch.io.native_format import save_df64_operator
        save_df64_operator(save_to, IRDF64Operator(
            a_hp=a_hp, wb=wb_built, diag=a_sp.diagonal()))
        if verbose:
            print(f"[ir_df64] operator bundle saved: {save_to}")
    if inner_format != "wbell":
        a32 = csr_from_scipy(a_sp.astype(np.float32), device=dev)
        if inner_format == "ell":
            a32 = ell_from_csr(a32, width_multiple=8, device=dev)

        if inner_chunk is not None:
            from cgx_torch.utils.checkpoint import make_checkpointed_solver
            chunked = make_checkpointed_solver(
                a32, tol=float(inner_tol), maxiter=int(inner_maxiter),
                preconditioner=preconditioner, chunk=int(inner_chunk))

            def inner(r_unit):
                res = chunked(r_unit)
                return res.x, res.iterations
        else:
            def inner(r_unit):
                res = cg_solve(a32, r_unit, tol=float(inner_tol),
                               maxiter=int(inner_maxiter),
                               preconditioner=preconditioner)
                return res.x, res.iterations

    return _ir_df64_loop(a_hp, inner, a_sp.shape[0], tol=tol, atol=atol,
                         max_outer=max_outer, verbose=verbose)


def _ir_df64_loop(a_hp: DF64ELL, inner, n: int, *, tol, atol, max_outer,
                  verbose):
    """The refinement loop of the build and prebuilt paths:
    ``solve(b, x0=None) -> (HPCGResult, info)``.  ``x0`` (a :class:`DF64`
    iterate, e.g. a preempted solve's ``res.x``) resumes refinement from
    there: the iterate is the outer loop's only state."""
    dev = a_hp.device

    def solve(b, x0: Optional[DF64] = None):
        b_df = df_from_f64(b, device=dev)
        bb = float(df_dot(b_df, b_df).hi)
        tol_sq = max(tol * tol * bb, atol * atol)

        if x0 is None:
            x = DF64(torch.zeros(n, dtype=torch.float32, device=dev),
                     torch.zeros(n, dtype=torch.float32, device=dev))
            r = b_df
            rr = bb
        else:
            x = x0
            r = _true_residual(a_hp, b_df, x)
            rr = float(df_dot(r, r).hi)
        total = 0
        outer = 0
        strikes = 0
        while rr > tol_sq and outer < max_outer and strikes < 2:
            # The scale as a device scalar: the residual is divided by it,
            # not multiplied by its reciprocal.
            s = torch.tensor(np.float32(np.sqrt(rr)), device=dev)
            r_unit = (r.hi / s) + (r.lo / s)
            d_unit, k_in = inner(r_unit)
            x = df_add(x, df(d_unit * s))
            r = _true_residual(a_hp, b_df, x)
            rr_new = float(df_dot(r, r).hi)
            strikes = 0 if rr_new < rr else strikes + 1
            rr = rr_new
            total += int(k_in)
            outer += 1
            if verbose:
                print(f"[ir_df64] cycle {outer}: true relres "
                      f"{np.sqrt(rr_new / bb):.3e} (+{int(k_in)} inner)")

        res = HPCGResult(x=x, iterations=torch.tensor(total,
                                                      dtype=torch.int32),
                         residual_norm_sq=torch.tensor(rr,
                                                       dtype=torch.float32),
                         converged=torch.tensor(rr <= tol_sq))
        info = dict(outer=outer, relres=float(np.sqrt(rr / bb)),
                    inner_iterations=total)
        return res, info

    return solve


def make_ir_df64_solver_multi(a=None, *, tol: float = 1e-6,
                              atol: float = 0.0,
                              inner_tol: float = 1e-2,
                              inner_maxiter: int = 2000,
                              max_outer: int = 40,
                              jacobi: bool = True,
                              inner_chunk: Optional[int] = None,
                              prebuilt: Optional[IRDF64Operator] = None,
                              verbose: bool = False, device="cuda"):
    """Multi-RHS factory: df64 true-residual refinement over batched WBELL
    inners (:func:`cgx_torch.solve.wbell.wbell_cg_solve_multi`, K8 over a
    tier plan whenever ``span <= 16``, else K7) and one batched df64 ELL
    product per cycle.

    Returns ``solve(B, x0=None) -> (HPCGResult, info)`` with ``B`` host
    fp64 ``(n, k)``; ``x`` is a df64 ``(n, k)`` block and the scalar
    fields carry a ``(k,)`` axis.  Columns refine together until all reach
    tol; a finished column gets a zero-scaled unit residual, so its inner
    work stops.  ``inner_chunk`` bounds each inner call by warm-restarting
    the batched CG from its iterate.  The JAX package also asks that its
    resident kernel fit the TPU's VMEM before it takes the tier plan; the
    card has no such cap.
    """
    from cgx_torch.kernels.wbell import build_tier_plan
    from cgx_torch.solve.wbell import wbell_cg_solve_multi
    from cgx_torch.sparse.wbell import wbell_from_csr

    if prebuilt is not None:
        if prebuilt.wb is None:
            raise ValueError("prebuilt IRDF64Operator has no WBELL "
                             "operator; rebuild from the CSR source")
        a_hp, wb = prebuilt.a_hp, prebuilt.wb
    else:
        a_sp = _scipy_f64(a)
        dev = resolve_device(device)
        a_hp = df64_ell_from_csr(a_sp, device=dev)
        wb = wbell_from_csr(a_sp, device=dev)
    dev = a_hp.device
    n = a_hp.shape[0]
    plan = build_tier_plan(wb) if wb.span <= 16 else None

    def inner(r_unit):
        """(n, k) fp32 unit residuals → (correction block, iterations)."""
        kw = dict(tol=inner_tol, jacobi=jacobi)
        if plan is not None:
            kw["tier_plan"] = plan
        else:
            kw["tiered"] = False
        if inner_chunk is None:
            res = wbell_cg_solve_multi(wb, r_unit, maxiter=inner_maxiter,
                                       **kw)
            return res.x, int(res.iterations.max())
        total = 0
        x0 = None
        while True:
            res = wbell_cg_solve_multi(wb, r_unit, x0,
                                       maxiter=int(inner_chunk), **kw)
            total += int(res.iterations.max())
            if bool(res.converged.all()) or total >= inner_maxiter:
                return res.x, total
            x0 = res.x

    def solve(B, x0: Optional[DF64] = None):
        B = _host(B).astype(np.float64)
        if B.ndim != 2:
            raise ValueError(f"expected (n, k) RHS block, got {B.shape}")
        k = B.shape[1]
        b_df = df_from_f64(B, device=dev)
        bb = np.einsum("nk,nk->k", B, B)
        tol_sq = np.maximum(tol * tol * bb, atol * atol)

        if x0 is None:
            x = DF64(torch.zeros((n, k), dtype=torch.float32, device=dev),
                     torch.zeros((n, k), dtype=torch.float32, device=dev))
            r = b_df
            rr = bb.copy()
        else:
            # Resume from a prior iterate: it is the outer's only state.
            x = x0
            r = _true_residual(a_hp, b_df, x)
            rr = df64_col_norm_sq(r)
        total = 0
        outer = 0
        strikes = 0
        while (rr > tol_sq).any() and outer < max_outer and strikes < 2:
            active = rr > tol_sq
            s = np.sqrt(np.where(active, rr, 1.0))
            inv_s = torch.from_numpy(
                np.where(active, 1.0 / s, 0.0).astype(np.float32)).to(dev)
            r_unit = (r.hi * inv_s[None, :]) + (r.lo * inv_s[None, :])
            d_unit, k_in = inner(r_unit)
            s32 = torch.from_numpy(s.astype(np.float32)).to(dev)
            x = df_add(x, df(d_unit * s32[None]))
            r = _true_residual(a_hp, b_df, x)
            rr_new = df64_col_norm_sq(r)
            worse = (rr_new >= rr)[active].all() if active.any() else True
            strikes = strikes + 1 if worse else 0
            rr = rr_new
            total += int(k_in)
            outer += 1
            if verbose:
                print(f"[ir_df64_multi] cycle {outer}: true relres "
                      f"{np.sqrt(np.maximum(rr, 0) / bb)}")

        conv = rr <= tol_sq
        res = HPCGResult(x=x, iterations=torch.tensor(total,
                                                      dtype=torch.int32),
                         residual_norm_sq=torch.from_numpy(
                             rr.astype(np.float32)),
                         converged=torch.from_numpy(conv))
        info = dict(outer=outer,
                    relres=np.sqrt(np.maximum(rr, 0.0) / bb).tolist(),
                    inner_iterations=total)
        return res, info

    return solve


def ir_df64_solve(a, b, *, tol: float = 1e-6, atol: float = 0.0,
                  inner_tol: float = 1e-2, inner_maxiter: int = 2000,
                  max_outer: int = 40, preconditioner=None,
                  inner_format: str = "ell",
                  inner_chunk: Optional[int] = None,
                  verbose: bool = False, device="cuda"):
    """One-shot form of :func:`make_ir_df64_solver` (see its docstring)."""
    return make_ir_df64_solver(
        a, tol=tol, atol=atol, inner_tol=inner_tol,
        inner_maxiter=inner_maxiter, max_outer=max_outer,
        preconditioner=preconditioner, inner_format=inner_format,
        inner_chunk=inner_chunk, verbose=verbose, device=device)(b)

"""Textbook (Jacobi-)PCG and the true residual, plain PyTorch.

The exit test is the program's: a column stops when ``‖r‖² ≤ tol²·‖b‖²``
on the recurrence residual of the unscaled system, or at ``maxiter``.  Each
column keeps its own α, β and exit; a column that has stopped is frozen.
"""
from __future__ import annotations

import torch


def pcg(matvec, b: torch.Tensor, diagonal=None, *, tol: float,
        maxiter: int):
    """Solve ``A X = B`` column by column from X = 0.  ``b``: ``(n, k)``.

    Returns ``(x, iterations, history, converged)``: ``iterations`` a list
    of k ints, ``history`` ``(k, max(iterations) + 1)`` of ``‖r_j‖²`` (a
    column's entries past its exit repeat its last value), ``converged`` a
    list of k bools.
    """
    inv = None if diagonal is None else (1.0 / diagonal)[:, None]
    x = torch.zeros_like(b)
    r = b.clone()
    z = r if inv is None else inv * r
    p = z.clone()
    rz = (r * z).sum(0)
    rr = (r * r).sum(0)
    tol_sq = tol * tol * (b * b).sum(0)
    it = torch.zeros(b.shape[1], dtype=torch.int64, device=b.device)
    hist = [rr.clone()]
    for _ in range(maxiter):
        active = rr > tol_sq
        if not bool(active.any()):
            break
        q = matvec(p)
        alpha = torch.where(active, rz / (p * q).sum(0), 0.0)
        x += alpha * p
        r -= alpha * q
        z = r if inv is None else inv * r
        rz_new = (r * z).sum(0)
        beta = torch.where(active, rz_new / rz, 0.0)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, (r * r).sum(0), rr)
        it += active.to(torch.int64)
        hist.append(rr.clone())
    history = torch.stack(hist, dim=1)
    return (x, it.tolist(), history, (rr <= tol_sq).tolist())


def relres(matvec, x: torch.Tensor, b: torch.Tensor) -> list:
    """``‖b − A x‖ / ‖b‖`` of each column, in float64."""
    x64, b64 = x.to(torch.float64), b.to(torch.float64)
    res = b64 - matvec(x64)
    return (res.norm(dim=0) / b64.norm(dim=0)).tolist()

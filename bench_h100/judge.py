"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (:mod:`bench_h100.reference`, float64 on the card) rebuilds the
operator from the data the benchmark made and judges a sample of the calls,
drawn from the seed, with the last call in it:

* ``relres``: the worst ``‖b − A x‖ / ‖b‖`` of the program's answers x, every
  column, with A the reference's own operator.  It covers the engine, the
  route's entry and any scaling the program does around it, together.
* ``hist_gap`` (a mix that reads the history back): the widest
  ``|‖r_j‖_program / ‖r_j‖_reference − 1|`` over the iterations both ran,
  against the reference's own PCG from the same b.
* ``iter_gap``: ``|iterations − reference iterations| / reference
  iterations``, the slowest column on each side (the multi-RHS engine shares
  its count).

A number is compared where the configuration gives it a limit; the others
are printed beside them.  Every call of the window is checked on the way
besides: the route its launch counters show, and ``converged``.
"""
from __future__ import annotations

import torch

from bench_h100.reference import cg as ref_cg

# The reference's iteration cap: far past any count these cells reach.
REF_MAXITER = 20000


def _cols(v: torch.Tensor) -> torch.Tensor:
    return v[:, None] if v.dim() == 1 else v


def judge(samples, data: dict, reference, config: dict,
          read_history: bool) -> dict:
    """``{number: value}`` over ``samples`` (dicts of ``x``, ``b``,
    ``pool``, ``iterations`` and ``history``)."""
    matvec, diagonal = reference.operator(data)
    tol = float(config["tol"])
    solved = {}
    relres, iter_gap, hist_gap = 0.0, 0.0, 0.0
    for s in samples:
        b = _cols(s["b"]).to(torch.float64)
        relres = max(relres, *ref_cg.relres(matvec, _cols(s["x"]), b))
        if s["pool"] not in solved:
            _, its, hist, _ = ref_cg.pcg(matvec, b, diagonal, tol=tol,
                                         maxiter=REF_MAXITER)
            solved[s["pool"]] = (its, hist.cpu())
        its, hist = solved[s["pool"]]
        ref_it, prog_it = max(its), max(s["iterations"])
        iter_gap = max(iter_gap, abs(prog_it - ref_it) / max(ref_it, 1))
        if read_history:
            hp = s["history"].to(torch.float64).reshape(-1)
            hr = hist[0]
            m = min(hp.shape[0], hr.shape[0])
            gap = (torch.sqrt(hp[:m] / hr[:m]) - 1.0).abs().max()
            hist_gap = max(hist_gap, float(gap))
    out = {"relres": relres, "iter_gap": iter_gap}
    if read_history:
        out["hist_gap"] = hist_gap
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(ok, checks)``: each number that has a limit, beside it."""
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in numbers.items() if k in limits}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks

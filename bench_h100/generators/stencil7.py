"""The constant 7-point stencil as the program's matrix-free ``Stencil3D``."""
from __future__ import annotations

import torch

from bench_h100.generators import Problem


def make(config: dict, gen: torch.Generator, device) -> Problem:
    """Nothing to draw: the operator is the configuration's."""
    from cgx_torch.sparse.stencil import Stencil3D

    nx, ny, nz = config["grid"]
    c0, c1 = float(config["center"]), float(config["coupling"])
    op = Stencil3D(nx, ny, nz, c0, c1, c1, c1, dtype_name=config["dtype"])
    return Problem(operator=op, preconditioner=None,
                   data={"grid": (nx, ny, nz), "center": c0, "coupling": c1})


def control_solve(problem: Problem, config: dict, traffic: dict):
    """The program's own path one precision down (bfloat16 vectors): the
    cell's call with ``b`` in bfloat16, which ``auto_solve`` sends to its
    loop; ``maxiter`` capped so that a solve that cannot converge ends."""
    from cgx_torch.solve.auto import auto_solve

    cap = int(config["control_maxiter"])

    def solve(b):
        return auto_solve(problem.operator, b.to(torch.bfloat16),
                          tol=float(config["tol"]), maxiter=cap,
                          **traffic["options"])

    return solve

"""Harnesses (PyTorch): the scaling model and the measured runners.

Counterpart of :mod:`cgx.bench`: :mod:`~cgx_torch.bench.scaling` (the
analytic communication model and the measured scaling runs),
:mod:`~cgx_torch.bench.suitesparse` (the preconditioner sweep over the
SuiteSparse targets), :mod:`~cgx_torch.bench.df64_rhs` (the warm df64 run
per right-hand side) and :mod:`~cgx_torch.bench.reference_full` (the
reference program's full-size problem).  These are package modules, each
with its command line; none is the repository's benchmark.
"""
from cgx_torch.bench.scaling import LinkModel, comm_report, measure_scaling

__all__ = ["LinkModel", "comm_report", "measure_scaling"]

"""Solvers (counterpart of ``cgx.solve``)."""

"""Utilities of the port (counterpart of :mod:`cgx.utils`)."""

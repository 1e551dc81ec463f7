"""Vector ops and sparse products (counterpart of ``cgx.ops``)."""

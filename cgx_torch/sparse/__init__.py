"""Matrix-free operators (counterpart of ``cgx.sparse``)."""

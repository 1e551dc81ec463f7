"""Problem generators (PyTorch port of :mod:`cgx.io`)."""

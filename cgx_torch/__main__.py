"""``python -m cgx_torch`` entry point (see :mod:`cgx_torch.cli`)."""
import sys

from cgx_torch.cli import main

sys.exit(main())

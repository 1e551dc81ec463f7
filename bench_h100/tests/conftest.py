"""The benchmark's CPU tests: ``python -m pytest bench_h100/tests -q`` from
the root of the repository.  They import no JAX; a test that needs the card
is marked ``cuda`` and skips without one."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

"""One generator a configuration ``kind`` (``generators/<kind>.py``): it
makes the operator on the card from the seed, in the form the program takes,
and hands the same data to the reference."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Problem:
    operator: object          # what the program is handed
    preconditioner: object    # None or the program's JacobiPrecond
    data: dict                # what the reference rebuilds the operator from

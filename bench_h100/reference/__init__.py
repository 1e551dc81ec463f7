"""The plain reference: plain PyTorch, float64 on the card.

It imports nothing of the program (``cgx_torch``) and takes nothing the
program made: each operator is rebuilt from the data the benchmark generated
(``reference/<kind>.py``), and the solve (:mod:`bench_h100.reference.cg`) is
textbook Jacobi-PCG with the program's exit test.
"""

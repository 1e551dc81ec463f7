"""The reference's operators against the port's plain products at 8³, the
reference PCG, and what the benchmark's modules import."""
import ast
from pathlib import Path

import torch

from bench_h100 import catalog
from bench_h100.reference import cg as ref_cg

N = 8
ROOT = Path(catalog.ROOT)


def problem(name, seed=4):
    cfg = dict(catalog.config(name), grid=[N, N, N], rows=N ** 3)
    pr = catalog.generator(cfg["kind"]).make(
        cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, pr


def test_stencil7_matches_the_ports_matvec():
    cfg, pr = problem("poisson7_224")
    mv, diag = catalog.reference("stencil7").operator(pr.data)
    x = torch.randn(N ** 3, 3, dtype=torch.float64)
    want = torch.stack([pr.operator.matvec(x[:, j].float()).double()
                        for j in range(3)], 1)
    assert torch.allclose(mv(x), want, atol=1e-5) and diag is None


def test_reference_pcg_solves_and_keeps_a_history():
    cfg, pr = problem("poisson7_224")
    mv, _ = catalog.reference("stencil7").operator(pr.data)
    diag = torch.full((N ** 3,), 6.0, dtype=torch.float64)
    b = torch.rand(N ** 3, 2, dtype=torch.float64) * 2 - 1
    x, its, hist, conv = ref_cg.pcg(mv, b, diag, tol=1e-6, maxiter=500)
    assert all(conv) and hist.shape == (2, max(its) + 1)
    assert max(ref_cg.relres(mv, x, b)) < 1.5e-6
    assert torch.allclose(hist[:, 0], (b * b).sum(0))
    x1, its1, _, _ = ref_cg.pcg(mv, b[:, :1], diag, tol=1e-6, maxiter=500)
    assert its1 == its[:1] and torch.allclose(x1[:, 0], x[:, 0])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_cgx():
    for path in ROOT.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "cgx"), \
                f"{path} imports {name}"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "torch", "bench_h100"), \
                f"{path} imports {name}"
            assert not name.startswith("bench_h100.") or \
                name.startswith("bench_h100.reference"), f"{path}: {name}"

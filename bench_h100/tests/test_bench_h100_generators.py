"""The generator against a dense construction at 8³."""
import torch

from bench_h100 import catalog

N = 8


def small(name):
    cfg = catalog.config(name)
    return dict(cfg, grid=[N, N, N], rows=N ** 3)


def node(i):
    return i // (N * N), (i // N) % N, i % N


def test_stencil7_is_the_poisson_matrix():
    cfg = small("poisson7_224")
    g = torch.Generator().manual_seed(3)
    pr = catalog.generator("stencil7").make(cfg, g, "cpu")
    n = N ** 3
    dense = torch.stack([pr.operator.matvec(torch.eye(n)[:, j])
                         for j in range(n)], dim=1).double()
    c = torch.tensor([node(i) for i in range(n)])
    dist = (c[:, None, :] - c[None, :, :]).abs().sum(-1)
    want = torch.where(dist == 0, 6.0, torch.where(dist == 1, -1.0, 0.0))
    want = want.double()
    assert torch.equal(dense, want)
    assert pr.preconditioner is None


def test_stencil7_same_for_every_seed():
    cfg = small("poisson7_224")
    mk = catalog.generator("stencil7").make
    a = mk(cfg, torch.Generator().manual_seed(5), "cpu")
    b = mk(cfg, torch.Generator().manual_seed(2 ** 31 + 11), "cpu")
    assert a.data == b.data

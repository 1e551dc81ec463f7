"""The fused engines K3 and K5 across ranks, against cgx.dist.fused.

Two kinds of test:

* In process: the plain kernel A of K3 and of K5 on shard r of 4, its ghost
  x-planes taken from the neighbouring shards, against the rows of the
  whole grid's plain product, bit for bit for q (stencils, Jacobi-scaled
  DIA, the symmetric mode whose mirror taps read the neighbours' planes,
  bf16 planes and vectors), and K5 A's march mirror (``march_reference``)
  reading the ghost planes at each chunk's first and last plane.
* Spawned: ``run_spmd`` runs P = 1, 2 and 4 gloo ranks once for the module;
  every rank solves every case through ``dist_fused_cg`` and
  ``dist_fused_cg_multi`` (the plain versions: the CPU path).  At P = 1
  the cross-rank form equals the single-process solve bit for bit; at
  P = 2 and 4 the sums differ only in the order of fp64 additions, so the
  iteration counts equal the single-process ones within 1 and x agrees to
  1e-5 relative.  Against cgx (its kernels in interpret mode on a 4-device
  sub-mesh of the virtual CPU devices, as its own tests run them) the
  tolerances are cgx's for its distributed fused solves: iterations within
  2, x to ``rtol=5e-4, atol=5e-5`` (fp32 sums in cgx, exact ones here).

The module imports cgx (and JAX) only inside its test functions: the
spawned workers unpickle ``_worker`` by name and check that no JAX is
loaded.
"""
import sys

import numpy as np
import pytest

SEED = 5


# -- the shared inputs (numpy and the port's constructors: no JAX) ------------


def _scaled_dia7(nx, ny, nz, seed):
    """The JAX package's variable-coefficient 7-point ``D A D`` in fp32:
    ``(data, offsets)``."""
    from torch_parity import scaled_dia_data

    data, offsets, _ = scaled_dia_data(nx, ny, nz, seed)
    return data.astype(np.float32), tuple(offsets)


def _dia27(nx, ny, nz):
    """The wrap-free variable 27-point operator (symmetric data)."""
    from cgx_torch.io.poisson import poisson3d_dia27

    a = poisson3d_dia27(nx, ny, nz, variable=True, device="cpu")
    return a.data.numpy().copy(), tuple(a.offsets)


def _bf16_case():
    """cgx's bf16-plane case: 7-point Poisson with a scaled centre."""
    from cgx_torch.io.poisson import poisson3d_dia

    a = poisson3d_dia(16, 6, 5, dtype=np.float32, device="cpu")
    data = a.data.numpy().copy()
    rng = np.random.default_rng(SEED + 1)
    data[3] *= (1.0 + 0.3 * rng.random(a.shape[0])).astype(np.float32)
    return data, tuple(a.offsets)


def _cases():
    """name -> (operator spec, b, kwargs).  A spec is ``("stencil", kind,
    dims)`` or ``("dia", data, offsets, dims)``."""
    rng = np.random.default_rng(SEED)

    def vec(n, k=None):
        shape = (n,) if k is None else (n, k)
        return rng.standard_normal(shape).astype(np.float32)

    d7 = _scaled_dia7(8, 6, 7, SEED)
    d27 = _dia27(8, 6, 5)
    d7u = _scaled_dia7(9, 6, 7, SEED + 2)
    bf = _bf16_case()
    n867 = 8 * 6 * 7
    x0 = vec(n867)
    b_bf = vec(16 * 6 * 5)
    return {
        "stencil7": (("stencil", "7", (8, 6, 7)), vec(n867), {}),
        "stencil7_x0": (("stencil", "7", (8, 6, 7)), vec(n867),
                        {"x0": x0, "track_history": True}),
        "stencil27": (("stencil", "27", (8, 6, 7)), vec(n867), {}),
        "one_plane": (("stencil", "7", (4, 6, 7)), vec(4 * 6 * 7), {}),
        "dia7": (("dia",) + d7 + ((8, 6, 7),), vec(n867),
                 {"jacobi": True, "maxiter": 800}),
        "dia27": (("dia",) + d27 + ((8, 6, 5),), vec(8 * 6 * 5),
                  {"jacobi": True, "maxiter": 800}),
        "bf16": (("dia",) + bf + ((16, 6, 5),), b_bf,
                 {"jacobi": True, "plane_dtype": "bfloat16"}),
        "fp32_planes": (("dia",) + bf + ((16, 6, 5),), b_bf,
                        {"jacobi": True}),
        "uneven_stencil": (("stencil", "7", (9, 6, 7)), vec(9 * 6 * 7), {}),
        "uneven_dia": (("dia",) + d7u + ((9, 6, 7),), vec(9 * 6 * 7),
                       {"jacobi": True, "maxiter": 800}),
        "multi_stencil": (("stencil", "7", (8, 6, 7)), vec(n867, 4), {}),
        "multi_dia7": (("dia",) + d7 + ((8, 6, 7),), vec(n867, 4),
                       {"jacobi": True, "maxiter": 800}),
        "multi_dia27": (("dia",) + d27 + ((8, 6, 5),), vec(8 * 6 * 5, 3),
                        {"jacobi": True, "maxiter": 800}),
        "multi_uneven": (("stencil", "7", (9, 5, 6)), vec(9 * 5 * 6, 3),
                         {}),
    }


def _port_operator(spec):
    import torch

    from cgx_torch.sparse.stencil import poisson3d_27point, poisson3d_stencil
    from cgx_torch.sparse.types import DIAMatrix

    if spec[0] == "stencil":
        fn = poisson3d_stencil if spec[1] == "7" else poisson3d_27point
        return fn(*spec[2])
    _, data, offsets, dims = spec
    n = data.shape[1]
    return DIAMatrix(data=torch.from_numpy(data), offsets=offsets,
                     shape=(n, n), grid=dims)


def _cgx_operator(spec):
    import jax.numpy as jnp

    from cgx.sparse.stencil import poisson3d_27point, poisson3d_stencil
    from cgx.sparse.types import DIAMatrix

    if spec[0] == "stencil":
        fn = poisson3d_stencil if spec[1] == "7" else poisson3d_27point
        return fn(*spec[2])
    _, data, offsets, dims = spec
    n = data.shape[1]
    return DIAMatrix(data=jnp.asarray(data), offsets=offsets, shape=(n, n),
                     grid=dims)


def _kwargs(kw, torch_side):
    import torch

    out = dict(tol=1e-5, maxiter=600)
    out.update(kw)
    if "plane_dtype" in out:
        out["plane_dtype"] = (torch.bfloat16 if torch_side
                              else __import__("jax.numpy").numpy.bfloat16)
    return out


def _worker(mesh, cases):
    """Every case through the distributed fused solvers on one rank."""
    assert "jax" not in sys.modules
    import torch

    from cgx_torch.dist import (dist_fused_cg, dist_fused_cg_multi,
                                gather_rows, halo)

    out = {}
    for name, (spec, b, kw) in cases.items():
        a = _port_operator(spec)
        args = _kwargs(kw, True)
        multi = b.ndim == 2
        if "x0" in args:
            args["x0"] = torch.from_numpy(args["x0"])
        halo.reset_counters()
        fn = dist_fused_cg_multi if multi else dist_fused_cg
        res = fn(a, torch.from_numpy(b), mesh, **args)
        counts = halo.counters()
        x = gather_rows(res.x, mesh)[:b.shape[0]]
        out[name] = {"x": x.numpy(),
                     "it": res.iterations.numpy(),
                     "history": res.history.numpy(),
                     "conv": res.converged.numpy(), "counts": counts}
    out["jax_loaded"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def ranks():
    """``{P: [each rank's results]}`` for P = 1, 2, 4 (one spawn each)."""
    from cgx_torch.dist import run_spmd

    cases = _cases()
    return {P: run_spmd(_worker, P, cases) for P in (1, 2, 4)}


@pytest.fixture(scope="module")
def single():
    """The port's single-process solves of every case (plain versions)."""
    import torch

    from cgx_torch.kernels.fused_cg import fused_stencil_cg
    from cgx_torch.kernels.fused_dia_cg import fused_dia_cg
    from cgx_torch.kernels.fused_multi import (fused_dia_cg_multi,
                                               fused_stencil_cg_multi)

    out = {}
    for name, (spec, b, kw) in _cases().items():
        a = _port_operator(spec)
        args = _kwargs(kw, True)
        if "x0" in args:
            args["x0"] = torch.from_numpy(args["x0"])
        bt = torch.from_numpy(b)
        if spec[0] == "stencil":
            fn = fused_stencil_cg_multi if b.ndim == 2 else fused_stencil_cg
        else:
            fn = fused_dia_cg_multi if b.ndim == 2 else fused_dia_cg
        res = fn(a, bt, **args)
        out[name] = {"x": res.x.numpy(), "it": res.iterations.numpy(),
                     "history": res.history.numpy()}
    return out


@pytest.fixture(scope="module")
def cgx_mesh():
    from cgx.dist.solve import make_row_mesh

    return make_row_mesh(4)


# -- spawned: the solves --------------------------------------------------------


NAMES = list(_cases())


@pytest.mark.parametrize("name", NAMES)
def test_one_rank_equals_single_process(ranks, single, name):
    """At P = 1 the cross-rank form (fp64 sums all-reduced, then rounded
    once) is the single-process solve bit for bit."""
    got, ref = ranks[1][0][name], single[name]
    np.testing.assert_array_equal(got["it"], ref["it"])
    np.testing.assert_array_equal(got["x"], ref["x"])
    np.testing.assert_array_equal(got["history"], ref["history"])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_ranks_follow_single_process(ranks, single, cgx_mesh, P, name):
    """At P = 2 and 4: against the port's single-process solve (fp64 sum
    order only) and against cgx.dist.fused on 4 devices."""
    import jax.numpy as jnp

    from cgx.dist.fused import dist_fused_cg, dist_fused_cg_multi

    spec, b, kw = _cases()[name]
    got = ranks[P][0][name]
    ref = single[name]
    assert np.all(got["conv"])
    assert np.all(np.abs(got["it"] - ref["it"]) <= 1)
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref["x"]).max())
    args = _kwargs(kw, False)
    if "x0" in args:
        args["x0"] = jnp.asarray(args["x0"])
    fn = dist_fused_cg_multi if b.ndim == 2 else dist_fused_cg
    theirs = fn(_cgx_operator(spec), jnp.asarray(b), cgx_mesh, **args)
    assert np.all(np.abs(got["it"] - np.asarray(theirs.iterations)) <= 2)
    np.testing.assert_allclose(got["x"], np.asarray(theirs.x), rtol=5e-4,
                               atol=5e-5)
    if kw.get("track_history"):
        k = int(got["it"])
        np.testing.assert_allclose(got["history"][:k],
                                   np.asarray(theirs.history)[:k],
                                   rtol=2e-2)


@pytest.mark.parametrize("P", [2, 4])
def test_bf16_planes_close_to_fp32(ranks, P):
    """bf16 planes across ranks converge near the fp32-plane solution (cgx's
    bound)."""
    r16, r32 = ranks[P][0]["bf16"], ranks[P][0]["fp32_planes"]
    err = np.linalg.norm(r16["x"] - r32["x"]) / np.linalg.norm(r32["x"])
    assert r16["conv"] and err < 3e-2


@pytest.mark.parametrize("P", [1, 2, 4])
def test_fused_collective_counts(ranks, P):
    """Two all-reduces an iteration (p·q and q·q after kernel A, Σr² and
    Σr²·w after kernel B) plus two at the start (the threshold and r₀'s
    sums; one more with x₀, whose kernel A sums too), one plane sent to
    each neighbour a kernel A and none gathered.  Symmetric DIA planes
    send nothing at setup: each rank cuts its planes' ghost planes from
    the whole operator it holds."""
    for r in range(P):
        out = ranks[P][r]
        assert not out["jax_loaded"]
        neighbours = (r > 0) + (r < P - 1)
        for name in ("stencil7", "dia7", "multi_stencil", "multi_dia27"):
            c, it = out[name]["counts"], int(np.max(out[name]["it"]))
            assert c["all_gathers"] == 0
            assert c["all_reduces"] == 2 + 2 * it, name
            assert c["sends"] == c["recvs"] == neighbours * it, name
        c = out["stencil7_x0"]["counts"]
        it = int(out["stencil7_x0"]["it"])
        assert c["all_reduces"] == 3 + 2 * it
        assert c["sends"] == neighbours * (it + 1)


# -- in process: shard r of 4 with ghost planes ----------------------------------


def _engine(op):
    """A whole-grid plain engine (K3) for each operator kind."""
    import torch

    from cgx_torch.kernels.fused_cg import build_fused
    from cgx_torch.kernels.fused_dia_cg import build_fused_dia
    from cgx_torch.sparse.stencil import poisson3d_27point, poisson3d_stencil

    dims = (8, 6, 5)
    if op == "stencil7":
        return build_fused(poisson3d_stencil(*dims), torch.float32), None
    if op == "stencil27":
        return build_fused(poisson3d_27point(*dims), torch.float32), None
    if op == "bf16_vectors":
        return build_fused(poisson3d_stencil(*dims), torch.bfloat16), None
    spec = (("dia",) + _scaled_dia7(*dims, SEED) + (dims,) if op == "dia7"
            else ("dia",) + _dia27(*dims) + (dims,))
    a = _port_operator(spec)
    kw = {"plane_dtype": torch.bfloat16} if op == "dia27_bf16" else {}
    return build_fused_dia(a, torch.float32, **kw)[0], a


OPS = ["stencil7", "stencil27", "bf16_vectors", "dia7", "dia27",
       "dia27_bf16"]


@pytest.mark.parametrize("op", OPS)
def test_k3_plain_shard_equals_whole(op):
    """K3's plain kernel A of shard r of 4, fed its ghost planes, gives the
    whole grid's q rows bit for bit (the outer shards' zero ghosts are
    the grid's zero fill; the symmetric mode's mirror reads the
    neighbours' plane rows); the shards' fp64 sums add up to the whole
    grid's.  build_fused_dia(n_shards=4, rank=r) builds the same shard."""
    import torch

    from cgx_torch.dist.halo import cut_ghost_rows
    from cgx_torch.kernels.fused_dia_cg import build_fused_dia
    from cgx_torch.kernels.fused_engine import FusedCG, Shard

    whole, a = _engine(op)
    p = torch.from_numpy(np.random.default_rng(3).standard_normal(
        whole.n).astype(np.float32)).to(whole.dtype)
    q_whole, pq, qq = whole.kernel_a_reference(p)
    P, plane = 4, whole.ny * whole.nz
    nl = whole.n // P
    total = torch.zeros(2, dtype=torch.float64)
    for r in range(P):
        rows = slice(r * nl, (r + 1) * nl)
        eng = FusedCG(whole.nx // P, whole.ny, whole.nz, whole.taps,
                      dtype=whole.dtype, coeffs=whole.coeffs,
                      planes=None if whole.planes is None
                      else whole.planes[:, rows],
                      weight=None if whole.weight is None
                      else whole.weight[rows],
                      sym=whole.sym, plane_dtype=whole.plane_dtype,
                      shard=Shard(r, P),
                      planes_ext=cut_ghost_rows(whole.planes, r, P, plane)
                      if whole.sym else None)
        q, s = eng.kernel_a_ext(cut_ghost_rows(p, r, P, plane))
        assert torch.equal(q, q_whole[rows])
        total += s
        if a is not None:
            built = build_fused_dia(
                a, torch.float32, n_shards=P, rank=r,
                plane_dtype=whole.plane_dtype)[0]
            q2, _ = built.kernel_a_ext(cut_ghost_rows(p, r, P, plane))
            assert torch.equal(q2, q)
    assert torch.equal(total.float(), torch.stack([pq, qq]))


@pytest.mark.parametrize("op", ["dia7", "dia27"])
def test_k3_plain_shard_b_rounds_reduced_sums_once(op):
    """K3's plain kernel B of a shard takes p·q and q·q reduced in fp64 and
    rounds them once: with the whole grid's sums it updates the shard's
    rows as the whole grid's kernel B does, bit for bit, and its own fp64
    sums add up to the whole grid's."""
    import torch

    from cgx_torch.kernels.fused_engine import FusedCG, Shard

    whole, _ = _engine(op)
    rng = np.random.default_rng(4)
    x, r_, p = (torch.from_numpy(rng.standard_normal(whole.n).astype(
        np.float32)) for _ in range(3))
    q, _, _ = whole.kernel_a_reference(p)
    q64, p64 = q.double(), p.double()
    sums_a = torch.stack([torch.sum(q64 * p64), torch.sum(q64 * q64)])
    rz = torch.sum(r_.double() ** 2).float()
    ref = whole.kernel_b_reference(rz, sums_a[0].float(), sums_a[1].float(),
                                   x, r_, p, q)
    P, nl = 4, whole.n // 4
    total = torch.zeros(2, dtype=torch.float64)
    for k in range(P):
        rows = slice(k * nl, (k + 1) * nl)
        eng = FusedCG(whole.nx // P, whole.ny, whole.nz, whole.taps,
                      coeffs=whole.coeffs, planes=whole.planes[:, rows],
                      weight=whole.weight[rows], sym=False,
                      shard=Shard(k, P))
        xs, rs, ps, s = eng.kernel_b_ext(rz, sums_a, x[rows], r_[rows],
                                         p[rows], q[rows])
        for got, want in zip((xs, rs, ps), ref[:3]):
            assert torch.equal(got, want[rows])
        total += s
    np.testing.assert_allclose(total.float().numpy(),
                               torch.stack(ref[3:]).numpy(), rtol=1e-7)


@pytest.mark.parametrize("op", ["stencil7", "dia27"])
def test_k5_plain_shard_equals_whole(op):
    """K5's plain kernel A and its march mirror (``march_reference``, which
    stages planes i0 − 1 … i1 of each chunk from the shard's span) on
    shard r of 4 give the whole grid's Q rows bit for bit, chunks of one
    and two planes included."""
    import torch

    from cgx_torch.dist.halo import cut_ghost_rows
    from cgx_torch.kernels.fused_cg import stencil_taps
    from cgx_torch.kernels.fused_dia_cg import dia_prep
    from cgx_torch.kernels.fused_engine import Shard
    from cgx_torch.kernels.fused_multi import (FusedCGMulti, march_plan,
                                               march_reference)
    from cgx_torch.sparse.stencil import poisson3d_stencil

    dims = (8, 6, 5)
    if op == "stencil7":
        nx, ny, nz, taps, coeffs = stencil_taps(poisson3d_stencil(*dims))
        planes = weight = None
        sym = False
    else:
        a = _port_operator(("dia",) + _dia27(*dims) + (dims,))
        nx, ny, nz, taps, coeffs, planes, _, weight, sym = dia_prep(
            a, torch.float32)
    whole = FusedCGMulti(nx, ny, nz, taps, coeffs=coeffs, planes=planes,
                         weight=weight, sym=sym)
    p = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, whole.n)).astype(np.float32))
    q_whole = whole.kernel_a_reference(p)[0]
    P, plane = 4, ny * nz
    nl = whole.n // P
    for r in range(P):
        rows = slice(r * nl, (r + 1) * nl)
        eng = FusedCGMulti(nx // P, ny, nz, taps, coeffs=coeffs,
                           planes=None if planes is None
                           else planes[:, rows],
                           weight=None if weight is None else weight[rows],
                           sym=sym, shard=Shard(r, P),
                           planes_ext=cut_ghost_rows(planes, r, P, plane)
                           if sym else None)
        p_ext = cut_ghost_rows(p, r, P, plane)
        q, _ = eng.kernel_a_ext(p_ext)
        assert torch.equal(q, q_whole[:, rows])
        for length in (1, 2):
            plan = march_plan(eng.nx, ny, nz, taps, length=length)
            qm = march_reference(eng, p_ext, plan)[0]
            assert torch.equal(qm, q_whole[:, rows])


def test_shard_without_group_refuses_missing_ghosts():
    """A shard with no process group cannot fetch its ghosts: the
    symmetric mode needs its planes with their ghost planes given, and
    the group-level kernels refuse to run (the ``*_ext`` kernels take the
    ghost planes from the caller)."""
    import torch

    from cgx_torch.dist.halo import cut_ghost_rows
    from cgx_torch.kernels.fused_engine import FusedCG, Shard

    whole, _ = _engine("dia27")
    nl = whole.n // 4
    kw = dict(coeffs=whole.coeffs, planes=whole.planes[:, nl:2 * nl],
              weight=whole.weight[nl:2 * nl], sym=True)
    with pytest.raises(ValueError, match="planes_ext"):
        FusedCG(whole.nx // 4, whole.ny, whole.nz, whole.taps,
                shard=Shard(1, 4), **kw)
    plane = whole.ny * whole.nz
    eng = FusedCG(whole.nx // 4, whole.ny, whole.nz, whole.taps,
                  shard=Shard(1, 4),
                  planes_ext=cut_ghost_rows(whole.planes, 1, 4, plane), **kw)
    with pytest.raises(ValueError, match="process group"):
        eng.kernel_a(torch.zeros(nl))

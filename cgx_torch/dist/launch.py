"""Process-group launch and the row mesh (PyTorch).

Counterpart of :mod:`cgx.dist.launch`: :func:`initialize` forms the
process group from the environment, :func:`is_multihost` and
:func:`global_row_mesh` keep their names.  Where the JAX package has a 1-D
device mesh over matrix rows (``make_row_mesh``), the port has a
:class:`RowMesh`: the process group, this process's rank and the group's
size, and the device its shard lives on.  Ranks hold consecutive row
blocks in rank order.

The group runs NCCL on the cards (device ``cuda:{local_rank}``), or gloo on
the CPU when the caller passes ``device="cpu"``.  Nothing falls back: a
failed ``init_process_group`` raises, and ``device="cuda"`` without a card
raises.

:func:`run_spmd` runs a function on ``world_size`` spawned processes joined
by a gloo group over a ``FileStore`` in a fresh temporary directory (no
port to collide on), the way the CPU tests drive the distributed solvers;
on cards the same functions run under ``torchrun``::

    torchrun --nproc-per-node 4 my_solve.py     # calls initialize()
"""
from __future__ import annotations

import os
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["RowMesh", "initialize", "is_multihost", "global_row_mesh",
           "make_row_mesh", "run_spmd"]


@dataclass(frozen=True)
class RowMesh:
    """The row mesh: ``rank`` of ``size`` processes of ``group`` (a
    process group), each holding its row block on ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device


def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def _device_for(device: str) -> torch.device:
    """The process's device: ``cuda:{LOCAL_RANK}`` for ``"cuda"`` (raises
    without a card), the CPU for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA card is available; "
                           "pass device='cpu' to run over gloo")
    if dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    torch.cuda.set_device(dev)
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str = "cuda") -> None:
    """``torch.distributed.init_process_group`` with environment defaults.

    The address, size and rank come from the arguments, else from
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``, else from ``CGX_COORDINATOR``/``CGX_NUM_PROCS``/
    ``CGX_PROC_ID``.  A single process that names no coordinator asks for
    no group: nothing happens, so library code may call this
    unconditionally.  ``coordinator_address`` is ``host:port`` or a
    ``tcp://`` or ``file://`` URL.  The backend is NCCL with
    ``device="cuda"`` (the process's card is ``cuda:{LOCAL_RANK}``) and
    gloo with ``device="cpu"``.  A group that is already formed is kept.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("CGX_COORDINATOR")
        if coordinator_address is None and "MASTER_ADDR" in os.environ:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', 29500)}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "CGX_NUM_PROCS")
    if process_id is None:
        process_id = _env_int("RANK", "CGX_PROC_ID")
    if coordinator_address is None and num_processes in (None, 1):
        return                                    # single process
    if dist.is_initialized():
        return
    dev = _device_for(device)
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: a group needs a coordinator address, "
                         "a number of processes and a process id")
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=timedelta(minutes=10))


def is_multihost() -> bool:
    """Whether this process belongs to a group of more than one."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _group_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_row_mesh(n: Optional[int] = None, device=None) -> RowMesh:
    """The row mesh over the default group; ``n`` (if given) must be its
    size.  ``device`` defaults to the backend's: this process's card under
    NCCL, the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_row_mesh: no process group (call "
                           "initialize() or run under run_spmd/torchrun)")
    size = dist.get_world_size()
    if n is not None and int(n) != size:
        raise ValueError(f"make_row_mesh: {n} shards on a group of {size} "
                         f"processes")
    dev = _group_device() if device is None else torch.device(device)
    return RowMesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size,
                   device=dev)


def global_row_mesh() -> RowMesh:
    """The 1-D row mesh over every process of the group, in rank order
    (contiguous row blocks per host when ranks are numbered host by
    host, so the halo exchange crosses hosts once per host boundary)."""
    return make_row_mesh()


def _spmd_child(rank, world_size, store_path, fn, args, queue):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(minutes=5))
        try:
            mesh = make_row_mesh(world_size, device="cpu")
            queue.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:                         # reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def run_spmd(fn, world_size: int, *args, device: str = "cpu",
             timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned processes of one
    gloo group and return the results in rank order.

    The group meets through a ``FileStore`` in a fresh temporary
    directory, so concurrent callers never share a port.  ``fn`` and
    ``args`` are pickled (``fn`` by name: a module-level function).  Each
    process takes one CPU thread.  A failure in any process raises here
    with its traceback.  Only ``device="cpu"`` is supported: NCCL does
    not let two ranks share a card, so ranks on cards come from
    ``torchrun``."""
    import multiprocessing as mp
    import queue as queue_mod

    if device != "cpu":
        raise ValueError("run_spmd runs gloo groups on the CPU; launch "
                         "card ranks with torchrun")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="cgx_spmd_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spmd_child,
                             args=(r, world_size, store, fn, args, q),
                             daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world_size and not errors:
                try:
                    rank, ok, value = q.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"rank {dead[0]} exited with code "
                                      f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        errors.append(f"no result within {timeout} s")
                    continue
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        finally:
            for p in procs:
                p.join(timeout=5 if errors else 60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("run_spmd failed on " + "\n".join(errors))
    return [results[r] for r in range(world_size)]

"""Device meshes: the twin of the reference's ``repro/launch/mesh.py``.

Functions, so importing this module never touches a process group.  Single
pod: (data=16, model=16) = 256 ranks.  Multi-pod adds an outer pure-DP
'pod' axis: (pod=2, data=16, model=16) = 512 ranks.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the live
process group.  The dry-run has no 512 cards: it runs in one process on a
*fake* process group of the production world size (:func:`fake_world`),
whose collectives move nothing, over ``meta`` tensors, as the reference
lowers its cells on 512 placeholder devices in one process.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _fake_backend() -> None:
    """Register the ``"fake"`` process-group backend.  PyTorch's testing
    package registers it on import; where that package is missing, the
    same C++ ``FakeProcessGroup`` is registered here."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
        return
    except ImportError:
        pass
    if "FAKE" in getattr(dist.Backend, "_plugins", {}):
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        return FakeProcessGroup._create_internal(
            common_opts.group_rank, common_opts.group_size, backend_opts)

    dist.Backend.register_backend("fake", create, extended_api=True,
                                  devices=["cpu", "cuda"])


def fake_world(world_size: int, rank: int = 0) -> None:
    """Start a fake process group of ``world_size`` ranks in this process
    (this process is ``rank``): collectives return at once and move
    nothing.  For the dry-run's meshes on ``meta`` tensors."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already live in this "
                           "process")
    _fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world_size)


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_world(backend: str) -> int:
    """Start this process's group: the one ``torchrun`` describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the
    environment), else a world of one on a free localhost port.  Returns
    this process's local rank (its card under ``nccl``)."""
    import os
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}",
            rank=0, world_size=1)
    return local_rank


def _rank_main(fn, rank: int, world: int, backend: str, port: int, args,
               queue) -> None:
    import traceback
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            queue.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, backend: str = "gloo", args=(),
              timeout: float = 600.0) -> List[Any]:
    """``fn(rank, *args)`` in ``world`` new processes, each rank of one
    process group on a free localhost port (``gloo`` for CPU tensors,
    ``nccl`` with rank r on card r); their results in rank order.  ``fn``
    must be importable by name (a module-level function) and its result
    picklable.  Raises with the traceback of a rank that failed."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, port, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, value = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:    # exited without a result (killed, or failed
                    # before it could report)
                    raise RuntimeError(
                        f"ranks {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]} and no "
                        f"result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(results)} of {world} "
                                       f"ranks gave no result in "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cpu"):
    """A mesh of ``shape`` named ``axes`` over the live process group,
    whose world size must be ``prod(shape)`` (a ``gloo`` group for CPU
    tensors, ``nccl`` with ``device_type="cuda"``, or :func:`fake_world`
    for the dry-run)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, have {have} — launch "
            f"{n} processes (torchrun --nproc-per-node {n}) or start a "
            f"fake world of {n} in this process (launch.mesh.fake_world) "
            f"for a dry-run")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """(16, 16) over 256 ranks, or (2, 16, 16) over 512 with
    ``multi_pod``."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device_type)


def mesh_axes_for(shape: Sequence[int]) -> Tuple[str, ...]:
    """The axis names of a (data, model) or (pod, data, model) mesh."""
    return PRODUCTION[len(shape) == 3][1]

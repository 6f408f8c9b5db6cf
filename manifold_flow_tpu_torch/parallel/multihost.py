"""Process-group initialization and cross-process helpers.

Counterpart of manifold_flow_tpu/parallel/multihost.py. The JAX package wires
up `jax.distributed` so that one controller sees every host's devices. The
port runs one process per rank: `initialize` joins the process group that
torchrun describes in the environment (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, LOCAL_RANK), or the one the caller names.

    torchrun --nproc-per-node 4 -m manifold_flow_tpu_torch.pipeline.cli \\
        batch --root results/ --frame-shards 4
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

TORCHRUN_HINT = ("launch the command under torchrun (torchrun --nproc-per-node N "
                 "...), which sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, "
                 "or call parallel.multihost.initialize with init_method, "
                 "world_size and rank")


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Join the process group (a no-op when one is already up).

    With no arguments the group comes from torchrun's environment. `backend`
    defaults to "nccl" where CUDA is available and "gloo" otherwise: NCCL for
    one GPU a rank, gloo for CPU ranks (or ranks that share one GPU, whose
    collectives then stage through host memory: parallel.comm). Raises
    ValueError when neither the arguments nor the environment describe a
    group.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is not None:
        if world_size is None or rank is None:
            raise ValueError("initialize(init_method=...) needs world_size and rank")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=int(world_size), rank=int(rank))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        raise ValueError(f"no process group is set up: {TORCHRUN_HINT}")
    logger.info("torch.distributed: rank %d / %d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes artifacts and logs: rank 0, or the
    only process."""
    return rank() == 0


def _world():
    from manifold_flow_tpu_torch.parallel.comm import AxisComm

    return AxisComm(dist.group.WORLD, world_size(), rank())


def sync_hosts(name: str = "barrier") -> None:
    """Barrier across every rank (a no-op for one process)."""
    if world_size() == 1:
        return
    _world().barrier()


class RankError(RuntimeError):
    """An exception that one rank raised, raised on every rank by `agree`."""


def agree(error: BaseException | None) -> None:
    """Tell every rank whether any rank failed: every rank calls it at the
    same point, with the exception it caught since the last agreement or
    None. Returns where no rank failed; else raises RankError on every rank,
    naming the lowest failing rank and its exception (chained on that
    rank), so that the ranks leave together and no rank goes on into a
    collective that another has left. One process re-raises `error`."""
    if world_size() == 1:
        if error is not None:
            raise error
        return
    comm = _world()
    device = (torch.device("cuda", torch.cuda.current_device())
              if comm.backend == "nccl" else torch.device("cpu"))
    failed = torch.zeros(world_size(), dtype=torch.int64, device=device)
    failed[rank()] = int(error is not None)
    comm.all_reduce_(failed)
    bad = failed.nonzero().flatten().tolist()
    if not bad:
        return
    message = [None if error is None else f"{type(error).__name__}: {error}"]
    dist.broadcast_object_list(message, src=bad[0])
    raise RankError(f"rank {bad[0]} of {world_size()} failed: {message[0]}") from error


def _spawned(rank: int, world: int, store: str, backend: str, threads: int,
             cuda_device, target, args, queue) -> None:
    """A rank spawned by `spawn`: joins the group, runs target and puts its
    result, or its traceback, on the queue."""
    import traceback

    try:
        torch.set_num_threads(threads)
        if cuda_device is not None:
            torch.cuda.set_device(cuda_device)
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        try:
            out = target(rank, world, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, "ok", out))
    except BaseException:  # the parent raises with the rank's traceback
        queue.put((rank, "error", traceback.format_exc()))


def spawn(target, world: int, args=(), backend: str = "gloo", timeout: float = 600.0,
          threads: int = 1, cuda_device=None) -> list:
    """Run target(rank, world, *args) in `world` spawned processes joined in
    a `backend` group through a FileStore in a temporary directory, and
    return their results in rank order. `threads` sets each rank's CPU
    threads; `cuda_device`, where given, is made every rank's current GPU
    (ranks that share one card). A rank's exception raises
    RuntimeError here with its traceback, and so does a rank that has not
    answered within `timeout` seconds; every rank is stopped before this
    returns or raises. `target` must be importable by module: a spawned
    child imports its target's module."""
    import os
    import tempfile
    import time
    from queue import Empty

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mf_ranks_") as tmp:
        queue = ctx.Queue()
        procs = [ctx.Process(target=_spawned, args=(
            r, world, os.path.join(tmp, "store"), backend, threads, cuda_device,
            target, args, queue))
            for r in range(world)]
        for p in procs:
            p.start()
        results: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                try:
                    r, status, out = queue.get(timeout=1.0)
                except Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in results]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} of {world} exited with "
                                           f"code {dead[0][1]} before it answered") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{world - len(results)} of {world} ranks did "
                                           f"not answer within {timeout} s") from None
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {r} of {world} failed:\n{out}")
                results[r] = out
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world)]

"""Processes, their process group and the collectives the port uses: the
port of ``skrx.parallel.distributed`` on ``torch.distributed``.

JAX runs one controller over every device of a mesh; PyTorch runs one
process per rank. A run of several ranks is started by ``torchrun`` (which
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) or by :func:`run_ranks` (``torch.multiprocessing`` with the
``"spawn"`` start method: a forked child cannot use CUDA). Each rank calls
:func:`initialize_distributed` once, before it builds a model.

The backend is chosen, and printed, before the group starts, never after a
failure: NCCL when every rank of the host has a card of its own; gloo when
ranks share a card (NCCL refuses two ranks on one GPU) and on the CPU. The
collectives below are the only ones the port calls: ``all_gather`` and
``all_reduce``, which gloo takes on CUDA tensors too (it has no
``reduce_scatter``, and nothing here needs one).
"""
import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["initialize_distributed", "is_multi_host", "process_index",
           "global_batch_from_local", "choose_backend", "rank_device",
           "all_gather_rows", "all_reduce_sum", "run_ranks"]

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=600)


def choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """"nccl" when each of the host's ``ranks_on_host`` ranks has a card of
    its own, "gloo" when ranks share a card and on the CPU."""
    if device.type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The caller's ``device``, else ``cuda:<LOCAL_RANK mod device count>``
    (raises without CUDA, as every entry point does)."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        return resolve_device("cuda")          # raises the device error
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return resolve_device(f"cuda:{local % torch.cuda.device_count()}")


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device: Optional[Union[str, torch.device]] = None,
                           backend: Optional[str] = None
                           ) -> Optional[torch.device]:
    """Start this rank's process group and return the rank's device.

    ``init_method`` (``tcp://localhost:<port>``, as tests and
    :func:`run_ranks` pass it) with ``world_size`` and ``rank``; or, without
    it, torchrun's variables (``env://``). With neither, or a world of one,
    nothing is started and None is returned, as the JAX package's call is a
    no-op on one host. A group already started is kept. ``backend`` None is
    :func:`choose_backend`'s."""
    if dist.is_initialized():
        return rank_device(device)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1 and init_method is None:
        return None
    dev = rank_device(device)
    ranks_on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if backend is None:
        backend = choose_backend(dev, ranks_on_host)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    shared = "ranks share" if dev.type == "cuda" and backend == "gloo" \
        else "one rank a"
    print(f"skrx_torch.parallel: rank {rank} of {world_size} on {dev}, "
          f"backend {backend} ({ranks_on_host} ranks on this host, {shared} "
          f"{'card' if dev.type == 'cuda' else 'CPU process group'})",
          flush=True)
    return dev


def is_multi_host() -> bool:
    """Whether this run has more than one process (rank)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def all_gather_rows(x: torch.Tensor, group=None,
                    size: Optional[int] = None) -> torch.Tensor:
    """The rows of ``x`` of every rank of ``group`` (of ``size`` ranks; None:
    the world), concatenated in the group's rank order. Every rank passes
    the same shape."""
    if size is None:
        size = dist.get_world_size(group) if dist.is_initialized() else 1
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def all_reduce_sum(x: torch.Tensor, group=None,
                   size: Optional[int] = None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (in place; returned)."""
    if size is None:
        size = dist.get_world_size(group) if dist.is_initialized() else 1
    if size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def global_batch_from_local(mesh, local_rows: torch.Tensor) -> torch.Tensor:
    """The global batch from each data index's ``local_rows`` (the same
    count on every rank), in data-index order: the input-pipeline building
    block of the JAX package (``make_array_from_process_local_data``)."""
    return all_gather_rows(local_rows, mesh.data_group, mesh.data_size)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, init_method: str, device,
               backend, fn, args, queue) -> None:
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        initialize_distributed(init_method, world_size, rank, device,
                               backend)
        try:
            queue.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:           # reported to the parent, then re-raised
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (),
              device: Union[str, torch.device] = "cpu",
              backend: Optional[str] = None, timeout: float = 300.0
              ) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned ranks joined by one
    process group on ``device`` (each rank's; a CPU rank runs one thread)
    and return the ranks' results in rank order. ``fn`` and ``args`` are
    pickled (``fn`` by its import path) and a result should be numpy
    arrays and Python values. Raises, with the rank's traceback, when a
    rank fails, and after ``timeout`` seconds, when every rank still
    running is killed."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, init_method, str(device),
                               backend, fn, tuple(args), queue))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results: dict = {}
    try:
        while len(results) < world_size:
            try:
                rank, ok, value = queue.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    missing = sorted(set(range(world_size)) - set(results))
                    raise TimeoutError(f"ranks {missing} of {world_size} "
                                       f"gave no result in {timeout} s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    # a failed rank's report may still be in flight
                    rank, ok, value = queue.get(timeout=5.0)
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{value}")
            results[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    except queue_mod.Empty:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"a rank exited without a result (exit codes "
                           f"{codes})") from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    return [results[r] for r in range(world_size)]

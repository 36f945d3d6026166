"""Run a function on every rank of a (dp, sp, tp) world of processes.

``run_world(fn, n, device, *args, shape=(dp, sp, tp))`` spawns ``n``
processes (the ``spawn`` start method: a process that has initialised CUDA
cannot fork safely), joins them into one ``torch.distributed`` world over a
free localhost port, builds the mesh (``axes.init_mesh``) in each, calls
``fn(*args)`` there and returns every rank's result in rank order. ``fn``
and its arguments are pickled: ``fn`` must be a module-level function of a
module the child can import.

The world has a time limit of its own: it is the process group's timeout,
so a collective that waits longer raises, and the limit within which the
parent expects every result; past it the ranks are killed and
``run_world`` raises. A rank that raises ends the world the same way, with
its traceback.

On the card rank ``r`` takes ``cuda:(r % device_count)``, and the kernels
are built in the parent before anything is spawned, so that no rank
compiles. Every rank runs its CPU work on one thread.

The world's backend is chosen here, once, from the devices the ranks
actually hold: each rank posts its card's UUID to the rendezvous store,
and every rank reads them all and calls ``axes.transport`` on the same
list before ``init_process_group``. The mesh's groups take the world's
backend.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ompi_tpu_torch.parallel import axes

TIMEOUT_S = 300.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device_id(dev: torch.device) -> str:
    """What tells this rank's device apart from another rank's: the card's
    UUID (the same card under any index or CUDA_VISIBLE_DEVICES)."""
    if dev.type == "cpu":
        return "cpu"
    return str(torch.cuda.get_device_properties(dev).uuid)


def _rank_main(rank: int, n: int, shape: Sequence[int], device: str,
               port: int, timeout: float, fn: Callable, args: tuple,
               results) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    try:
        limit = datetime.timedelta(seconds=timeout)
        store = dist.TCPStore("127.0.0.1", port, n, is_master=rank == 0,
                              timeout=limit)
        store.set(f"device/{rank}", _device_id(dev))
        ids = [store.get(f"device/{r}").decode() for r in range(n)]
        dist.init_process_group(axes.transport(dev.type, ids), store=store,
                                rank=rank, world_size=n, timeout=limit)
        try:
            axes.init_mesh(*shape, device=dev)
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which ends the world
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, n: int, device: str, *args: Any,
              shape: Optional[Sequence[int]] = None,
              timeout: float = TIMEOUT_S) -> List[Any]:
    """``fn(*args)`` on each rank of an ``n``-rank world on ``device``
    ("cpu" or "cuda") with mesh ``shape`` (dp, sp, tp; ``(n, 1, 1)`` by
    default); returns the results by rank. Raises if a rank raises or the
    world outlives ``timeout`` seconds."""
    shape = tuple(shape or (n, 1, 1))
    if len(shape) != 3 or shape[0] * shape[1] * shape[2] != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} ranks")
    if torch.device(device).type == "cuda":
        from ompi_tpu_torch.ops import _build

        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, shape, device, port, timeout, fn, args,
                               results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out: List[Any] = [None] * n
    pending = set(range(n))
    try:
        while pending:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that died without a word (a signal, os._exit)
                dead = [r for r in pending if procs[r].exitcode]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {n} exited with code "
                        f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"world of {n} ranks {shape} on {device}: ranks "
                        f"{sorted(pending)} gave no result within {timeout} "
                        f"s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return out

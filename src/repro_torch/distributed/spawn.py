"""Run a function on ``world`` ranks, each a process of its own (the
``spawn`` start method), joined in one ``torch.distributed`` group.

The ranks meet through a ``file://`` store in a fresh directory (no
port). Each returns what ``fn(comm, *args)`` returns, in rank order; a
rank that raises (or dies) stops the others and raises here with that
rank's traceback. A CPU run of the data-parallel trainer is ``world``
gloo ranks started this way (``launch/train.py --devices N``).
"""
from __future__ import annotations

import datetime
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch.multiprocessing as mp


def _child(rank: int, world: int, backend: str, init_method: str,
           timeout_s: float, fn: Callable, args: tuple, out, done) -> None:
    import torch.distributed as dist

    from repro_torch.distributed.comm import Comm
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(Comm(), *args)
        out.put((rank, True, result))
    except BaseException:                 # noqa: BLE001 — sent to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # a tensor in the result travels as a file descriptor this process
    # hands over on request: stay until the parent has read every result
    done.wait(timeout_s)


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              rendezvous_dir: Optional[str] = None,
              timeout_s: float = 600.0) -> List[Any]:
    """``[fn(comm, *args) on rank r for r in range(world)]``. ``fn`` must be
    importable by name (a module-level function); ``rendezvous_dir``
    holds the store's file (default: a temporary directory, removed)."""
    own = rendezvous_dir is None
    d = tempfile.mkdtemp(prefix="ranks_") if own else rendezvous_dir
    path = os.path.join(d, f"store_{os.getpid()}_{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    out, done = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=_child,
                         args=(r, world, backend, f"file://{path}",
                               timeout_s, fn, args, out, done), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world and failure is None:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    failure = f"ranks did not finish within {timeout_s} s"
                continue
            if ok:
                results[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        done.set()
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        if own:
            shutil.rmtree(d, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world)]

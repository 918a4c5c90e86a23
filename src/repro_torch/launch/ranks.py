"""One process a shard: spawn ``world`` ranks in one gloo process group,
run a function in each, and collect what each returns.

The group is ``torch.distributed`` over gloo with a ``FileStore`` in a
temporary directory, so no TCP port is taken.  Every wait is bounded:
``init_timeout`` is the group's own (its joins and collectives), and
``timeout`` the whole run's.  A rank that raises sends its traceback;
the parent then raises it, and kills every rank still alive on the way
out, whatever happened.

A rank gets its mesh from ``core.distributed.make_process_mesh``.  The
ranks are spawned (CUDA does not survive ``fork``); a spawned child
re-imports the parent's ``__main__``, so a driving script does no work
at import, and ``fn`` is a module-level function whose module a child
can import.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch.distributed as dist

KILL_WAIT_S = 10.0  # a killed rank's join


def _rank_main(fn, rank: int, world: int, store_path: str,
               init_timeout: float, args: tuple, results) -> None:
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=init_timeout))
        try:
            value = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # noqa: BLE001 — the parent raises it with the traceback
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, args: tuple = (), timeout: float = 300.0,
              init_timeout: float = 60.0) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each call in
    its own spawned process, all ranks of one gloo group.  Raises when a
    rank raises or dies, or when the ranks have not all answered within
    ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world, store, init_timeout, args,
                                   results))
                 for rank in range(world)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            out: dict = {}
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} gave "
                        f"no answer in {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = {r: p.exitcode for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)}
                    if dead:
                        raise RuntimeError(f"ranks died without an answer "
                                           f"(exit codes {dead})") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{value}")
                out[rank] = value
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            return [out[rank] for rank in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(KILL_WAIT_S)
            results.close()

"""Spawned process-group worlds for the multi-rank checks.

``run_world(fn, world_size, store_dir)`` starts ``world_size`` processes
(the ``spawn`` start method), each joining one process group through a
``file://`` store in ``store_dir`` (never a fixed port: several worlds may
run at once), calls ``fn(rank, world_size, *args)`` in each and returns
the ranks' results in rank order. The world has one deadline: when it
passes, every child still running is killed and ``TimeoutError`` is
raised; a rank that raises makes the call raise with its traceback. The
children are always gone when it returns.

``fn`` must be importable by name (a module-level function) and its
result picklable (numbers, numpy arrays, dicts of them).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback
from typing import Any, Callable, List, Sequence


def _entry(fn, rank, world_size, init_method, backend, args, timeout, out):
    import torch.distributed as dist
    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 — sent to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world_size: int, store_dir: str,
              args: Sequence[Any] = (), timeout: float = 180.0,
              backend: str = "gloo") -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on a fresh world of
    ``world_size`` spawned ranks; -> the ranks' results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store.{os.getpid()}.{time.time_ns()}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world_size, f"file://{store}", backend,
                               tuple(args), timeout, out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, errors = {}, {}
    try:
        while len(results) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world_size} ranks running {fn.__name__} did "
                    f"not finish in {timeout:.0f}s (ranks done: "
                    f"{sorted(results)}, failed: {sorted(errors)})")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None)
                        and r not in results and r not in errors]
                if dead:
                    raise RuntimeError(
                        f"ranks {dead} of {fn.__name__} died (exit codes "
                        f"{[procs[r].exitcode for r in dead]})")
                continue
            (results if ok else errors)[rank] = value
            if errors:
                break
        if errors:
            rank = min(errors)
            raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                               f"{errors[rank]}")
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        try:
            os.remove(store)
        except FileNotFoundError:
            pass

"""Start the ranks of a view mesh as local processes, with a time limit.

``spawn(fn, n_ranks, args)`` runs ``fn(*args)`` in ``n_ranks`` new processes
(the ``spawn`` start method) that form one ``torch.distributed`` group over a
``file://`` store in a fresh temporary directory, so that concurrent runs
never share an address, and returns each rank's return value in rank order.
It is the counterpart of the JAX package's mesh over every local device.

``fn`` travels to the children by its module path, and each child imports
that module: keep it importable and cheap to import (a script's workers stay
outside its ``if __name__ == "__main__":`` block, which the children skip).
Its return value travels back through ``torch.save``/``torch.load(...,
weights_only=True)``: tensors, numbers, strings, lists, tuples and dicts.

A rank that raises or dies ends the run: the others are stopped and the
first failure is raised. So is a run that outlasts ``timeout`` seconds (a
rank blocked in a collective whose peer is gone never returns).
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def default_backend(n_ranks: int, device) -> str:
    """NCCL where every rank has a card of its own, else gloo (NCCL refuses
    two ranks on one card)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= n_ranks):
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, n_ranks, backend, tmp, args):
    # the ranks of one run share the host's cores (and a test run's workers
    # share them again): one intra-op thread each keeps them from spinning
    # against one another
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=n_ranks, rank=rank)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def spawn(fn, n_ranks: int, args=(), *, backend: str = "gloo",
          timeout: float = 120.0) -> list:
    """``[fn(*args) on rank r for r in range(n_ranks)]``, each in its own
    process of one ``backend`` group. Raises the first rank's failure, or
    ``TimeoutError`` (the ranks killed) after ``timeout`` seconds."""
    with tempfile.TemporaryDirectory(prefix="dmrt_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n_ranks, backend, tmp, tuple(args)),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic()),
                               grace_period=5.0):
                if time.monotonic() >= deadline:
                    alive = [r for r, p in enumerate(ctx.processes)
                             if p.is_alive()]
                    raise TimeoutError(
                        f"spawn: ranks {alive} of {n_ranks} still running "
                        f"after {timeout} s; killed")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=True)
                for r in range(n_ranks)]

"""Start N ranks on one host: the port's answer to JAX's single controller
over N local devices.

:func:`launch` spawns ``nprocs`` processes with
``torch.multiprocessing``, joins them into one process group through a
``file://`` rendezvous under a fresh temporary directory (no fixed port,
so concurrent launches on one host never collide), runs ``fn(rank,
*args)`` on each and returns the ranks' results in rank order. Each rank
runs ``torch.set_num_threads(1)``: N ranks share the host's cores.

``fn`` must be importable by the children (a module-level function), and
its result picklable.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, nprocs: int, backend: str, root: str,
               args: Sequence[Any], timeout_s: float) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{root}/rendezvous",
                            world_size=nprocs, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: Sequence[Any] = (), *, backend: str = "nccl",
           timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` spawned ranks of one process
    group (``nccl``: rank r on ``cuda:r``; ``gloo``: CPU tensors) and
    return their results. A failed rank raises here with its traceback
    and the others are stopped; so are all of them after ``timeout_s``
    (also each collective's timeout), so a deadlock ends as an error."""
    if backend == "nccl":
        from ..device import resolve_device

        resolve_device("cuda")
        if torch.cuda.device_count() < nprocs:
            raise RuntimeError(f"{nprocs} ranks need {nprocs} CUDA devices, "
                               f"have {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="seldon-ranks-") as root:
        ctx = mp.start_processes(_rank_main, args=(fn, nprocs, backend, root, tuple(args),
                                                    timeout_s),
                                  nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]

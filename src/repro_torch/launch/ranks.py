"""Ranks of one host, each a process of its own in one process group.

:func:`spawn` starts ``world_size`` processes (``torch.multiprocessing``,
the spawn start method), each joining a group over
``tcp://localhost:<a free port>`` as its rank, with a timeout on every
collective, and runs ``fn(rank, *args)`` there.  A rank that raises fails
the call with its traceback; ranks still running at the deadline are
killed and the call raises ``TimeoutError`` naming them.  Nothing is
retried and no other backend is tried.
"""
from __future__ import annotations

import datetime
import socket
import time


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world_size: int, backend: str, port: int,
               args: tuple, timeout_s: float) -> None:
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), *, backend: str = "gloo",
          timeout_s: float = 600.0, collective_timeout_s: float = 300.0
          ) -> None:
    """``fn(rank, *args)`` in ``world_size`` processes of one ``backend``
    group; returns when every rank has returned.  ``fn`` must be importable
    by name (a module's function).  A collective that waits past
    ``collective_timeout_s`` raises in its rank; the whole call past
    ``timeout_s`` kills every rank still running and raises."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, backend, free_port(), args,
                          collective_timeout_s),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            alive = [i for i, p in enumerate(ctx.processes) if p.is_alive()]
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"ranks {alive} of {world_size} still ran "
                               f"after {timeout_s} s; killed")

"""Local ranks: ``spawn(fn, n, args, timeout)`` runs ``fn(i, *args)`` for i
in 0..n-1, each in a fresh process (``torch.multiprocessing``, the spawn
start method), and waits for all of them.  A rank that raises or exits
with another code than 0 stops the others and raises in the caller; past
``timeout`` seconds every rank still running is killed and the caller
gets ``TimeoutError``.  ``free_coordinator()`` names a free TCP port on
this host for their rendezvous."""
from __future__ import annotations

import socket
import time
from typing import Callable, Optional, Sequence

import torch.multiprocessing as mp


def free_coordinator() -> str:
    """``localhost:<port>`` of a port that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          timeout: Optional[float] = None) -> None:
    """Run ``fn(i, *args)`` in ``nprocs`` processes and wait for them all
    (``fn`` must be importable: a module-level function)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                             join=False, start_method="spawn")
    try:
        while True:
            wait = 5.0 if deadline is None else \
                max(0.0, min(5.0, deadline - time.monotonic()))
            if ctx.join(timeout=wait):          # raises on a failed rank
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()

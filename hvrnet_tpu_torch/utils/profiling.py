"""Phase timing and tracing (counterpart of
``hvrnet_tpu/utils/profiling.py``):

* ``PhaseTimer``: named host wall-clock phases with an EMA and totals and
  the JAX package's printed summary (the ``t_data`` / ``t_net`` the
  reference's test loops compute and never print).
* ``trace``: a ``torch.profiler`` trace of the host and the card (CPU and
  CUDA activities) around a block, written into a directory as a Chrome
  trace file (``chrome://tracing``, Perfetto, or TensorBoard's profiler
  plugin).
* ``annotate``: a named host region on the trace's timeline
  (``torch.profiler.record_function``).
* ``device_memory_stats``: the CUDA caching allocator's counters.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Host wall time per named phase.  Like the JAX package's, it times
    the host around calls that queue device work and return before the
    card has run it: a phase that ends without waiting for the card
    counts the launches, not the work, and the work lands in the phase
    that next waits for it (a device-to-host read, a synchronise).  Phases
    may run on several threads (the frame stream's on its own)."""

    def __init__(self, ema: float = 0.98):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.avg: Dict[str, float] = {}
        self.ema = ema
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.total[name] += dt
                self.count[name] += 1
                prev = self.avg.get(name, dt)
                self.avg[name] = self.ema * prev + (1 - self.ema) * dt

    def summary(self) -> str:
        lines = [f"{'phase':>16} {'total_s':>9} {'calls':>7} {'avg_ms':>8}"]
        with self._lock:
            total, count = dict(self.total), dict(self.count)
        for name in sorted(total, key=total.get, reverse=True):
            n = count[name]
            lines.append(f"{name:>16} {total[name]:>9.2f} {n:>7} "
                         f"{total[name] / n * 1000:>8.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write it to
    ``<log_dir>/trace_<pid>.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """A named host region on the profiler's timeline."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of ``device``, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(device)

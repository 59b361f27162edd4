"""Tracing and timing helpers, the counterpart of the JAX package's
``utils/profiling.py``: a stage-timer aggregate (the reference viewer's
``std::chrono`` stage timers), a device trace (``torch.profiler`` where
the JAX package starts a ``jax.profiler`` trace), the chain-slope timing
of a call, and the analytic MACs of a frame (on the model definitions'
``macs_per_input``, as the evaluation's complexity counts them).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch


class StageTimers:
    """Accumulating per-stage wall timers."""

    def __init__(self):
        self.total_us: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total_us[name] += (time.perf_counter() - t0) * 1e6
            self.count[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.total_us):
            n = max(self.count[name], 1)
            lines.append(f"{name}: {self.total_us[name] / n:.1f} us/call x{self.count[name]}")
        return "\n".join(lines)

    def reset(self):
        self.total_us.clear()
        self.count.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is visible) and write a Chrome trace (viewable in
    ``chrome://tracing`` or Perfetto) into ``log_dir`` as
    ``trace_<pid>_<ns>.json``. Yields the profiler: its ``key_averages()``
    hold the ops' times, and its ``trace_path`` the file, once the block
    has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def _fence(result):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def chain_slope_time(fn: Callable, args, n1: int = 2, n2: int = 12,
                     fence: Callable = None) -> float:
    """Milliseconds per call as the slope between chains of ``n1`` and
    ``n2`` calls, each ended by ``fence(result)`` (by default
    ``torch.cuda.synchronize`` where a card is visible): the fixed cost of
    a chain, its launch and its fence, cancels."""
    fence = fence or _fence

    def run(n):
        t0 = time.perf_counter()
        r = None
        for _ in range(n):
            r = fn(*args)
        fence(r)
        return time.perf_counter() - t0

    run(1)
    d1 = run(n1)
    d2 = run(n2)
    return (d2 - d1) / (n2 - n1) * 1e3


def analytic_macs(model_defs, avg_samples: float, n_pixels: int):
    """(MACs of a frame, MACs a pixel): the first net once a pixel, every
    other at ``avg_samples`` samples a pixel."""
    per_pixel = 0.0
    for i, d in enumerate(model_defs):
        macs = d.macs_per_input()
        per_pixel += macs if i == 0 else macs * avg_samples
    return per_pixel * n_pixels, per_pixel

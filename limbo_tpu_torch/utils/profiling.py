"""Tracing and profiling utilities (port of limbo_tpu/utils/profiling.py).

The reference has no in-library tracing (timing is ad hoc std::chrono in
benchmarks, src/benchmarks/limbo/bench.cpp:138-153).  Here:

* ``PhaseTimer``: named per-phase wall timers that wait on the card before
  they stop (the work a phase queued is counted in that phase);
* ``trace()``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (chrome://tracing, Perfetto) of the host and the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def device_sync(x) -> None:
    """Wait for the computation producing x: synchronize the CUDA device
    of the first tensor in x (a tensor, or a list, tuple or dict of them);
    on the CPU, nothing to wait for."""
    while isinstance(x, (list, tuple, dict)):
        x = next(iter(x.values() if isinstance(x, dict) else x))
    if torch.is_tensor(x) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class PhaseTimer:
    """Accumulating named timers:

        timer = PhaseTimer()
        with timer("fit", sync=gp.L):
            gp = fit(...)
        print(timer.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device_sync(sync)
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> str:
        lines = []
        for phase in sorted(self.totals):
            tot = self.totals[phase]
            cnt = self.counts[phase]
            lines.append(f"{phase:24s} {tot*1e3:10.2f} ms total "
                         f"({cnt} calls, {tot/cnt*1e3:.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "limbo_tpu_torch_trace"):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write its Chrome trace to
    ``<log_dir>/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

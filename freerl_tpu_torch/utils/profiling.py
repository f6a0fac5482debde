"""Tracing and per-step timing (counterpart:
``freerl_tpu/utils/profiling.py``).

``trace(logdir)`` wraps a block in a ``torch.profiler`` trace (host
activity, and the CUDA kernels when the device is a card) and writes it as
a Chrome trace into ``logdir``, viewable in Perfetto or
``chrome://tracing``; ``StepTimer`` tracks steady-state steps/s with
warmup excluded.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """``torch.profiler.profile`` around a block; yields the profiler (for
    ``key_averages()``) and writes ``<logdir>/trace.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Steady-state throughput meter: skips warmup iterations, then
    reports items/s over the measured window."""

    def __init__(self, warmup: int = 2, items_per_step: int = 1):
        self.warmup = warmup
        self.items_per_step = items_per_step
        self.count = 0
        self._t0: Optional[float] = None
        self.measured_steps = 0

    def step(self):
        self.count += 1
        if self.count == self.warmup:
            self._t0 = time.time()
        elif self.count > self.warmup:
            self.measured_steps += 1

    @property
    def items_per_second(self) -> float:
        if self._t0 is None or self.measured_steps == 0:
            return 0.0
        return (self.measured_steps * self.items_per_step
                / (time.time() - self._t0))

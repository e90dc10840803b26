"""Profiling and step-time observability.

Counterpart of ``aum_tpu/train/profiling.py`` on ``torch.profiler``:

- ``trace(logdir)``: a context manager that profiles the host and, when
  there is a card, the device, and writes a Chrome trace
  (``trace.json``, TensorBoard- and Perfetto-loadable) into ``logdir``;
- ``annotate(name)``: a ``record_function`` range that labels a host region
  inside a trace;
- ``StepTimer``: the step-time and clips/s meter with a warm-up skip. It
  synchronizes the card before it reads the clock, so a step's time is the
  device's and not the enqueue's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Step-time and throughput meter (skips warm-up steps)."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self):
        self._seen = 0
        self._items = 0
        self._elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self):
        _sync()
        self._t0 = time.perf_counter()

    def stop(self, n_items: int = 1):
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        _sync()
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._seen += 1
        if self._seen > self.warmup_steps:
            self._elapsed += dt
            self._items += n_items

    @property
    def steps_timed(self) -> int:
        return max(0, self._seen - self.warmup_steps)

    @property
    def mean_step_time(self) -> float:
        return self._elapsed / self.steps_timed if self.steps_timed else 0.0

    @property
    def items_per_sec(self) -> float:
        return self._items / self._elapsed if self._elapsed > 0 else 0.0

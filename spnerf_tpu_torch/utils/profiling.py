"""Profiling hooks (``spnerf_tpu/utils/profiling.py``): ``torch.profiler``
traces and a step timer.

Any stretch of work can be wrapped in a trace that ``torch.profiler``
writes as a Chrome trace (``chrome://tracing``, Perfetto), and the train
loop reports steps/s:

    with trace_if(enabled, logdir):
        ... run steps ...

or set ``profile: {enable: true, logdir: ..., start: 10, num_steps: 20}``
in a training config (``tasks/train_task.py`` hooks it up).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace_if(enabled: bool, logdir: str = "/tmp/spnerf_trace"):
    """Profile the block (host and, where there is a card, device
    activity) and write ``<logdir>/trace_<pid>_<ns>.json`` at its end."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        out = Path(logdir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Running steps/sec + examples/sec, cheap enough to call every step."""

    def __init__(self, window: int = 100):
        self.window = window
        self._t0 = time.perf_counter()
        self._count = 0
        self.steps_per_sec = 0.0

    def tick(self, n: int = 1) -> float | None:
        self._count += n
        if self._count >= self.window:
            now = time.perf_counter()
            self.steps_per_sec = self._count / (now - self._t0)
            self._t0 = now
            self._count = 0
            return self.steps_per_sec
        return None

    def restart(self) -> None:
        """Start a new window now: the time since the last tick (a
        validation pass, a checkpoint) is not counted."""
        self._t0 = time.perf_counter()
        self._count = 0

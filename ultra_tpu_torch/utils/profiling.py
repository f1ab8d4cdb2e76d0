"""Profiling and step timing.

Counterpart of ``ultra_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block (host
  and, where there is a card, CUDA kernels), written into ``logdir`` as a
  Chrome trace (``*.pt.trace.json``, which TensorBoard and Perfetto read);
- ``annotate(name)``: a named region on the host timeline of a trace;
- ``StepTimer``: rolling step time and throughput, synchronised with the
  device of a step's output.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; yields the ``torch.profiler.profile``
    (for ``key_averages()``), and writes its trace into ``logdir`` on exit."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof


def annotate(name: str):
    """Named region that shows up on the host timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-clock step stats with optional edges/s accounting.

    CUDA work is asynchronous: hand a step's output to :meth:`stop` as
    ``sync`` so that its device finishes before the clock is read, or the
    times measure the enqueue, not the work.
    """

    def __init__(self, window: int = 50, edges_per_step: Optional[int] = None):
        self.times = deque(maxlen=window)
        self.edges_per_step = edges_per_step
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, sync: Optional[torch.Tensor] = None) -> float:
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - self._last
        self.times.append(dt)
        return dt

    @property
    def mean_step_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def edges_per_sec(self) -> Optional[float]:
        if self.edges_per_step is None or not self.times:
            return None
        return self.edges_per_step / self.mean_step_s

    def summary(self) -> str:
        s = f"step {self.mean_step_s * 1e3:.1f} ms"
        eps = self.edges_per_sec
        if eps is not None:
            s += f", {eps / 1e6:.1f} M edges/s"
        return s

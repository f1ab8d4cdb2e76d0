"""Profiling and step timing.

Counterpart of ``ultra_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block (host
  and, where there is a card, CUDA kernels), written into ``logdir`` as a
  Chrome trace (``*.pt.trace.json``, which TensorBoard and Perfetto read);
- ``annotate(name)``: a named region on the host timeline of a trace, in
  the profiler's own event stream (so on the device trace's clock), nested
  in the region that encloses it on the same thread;
- ``count(name, n)``: adds ``n`` to ``counters[name]``;
- ``StepTimer``: rolling step time and throughput, synchronised with the
  device of a step's output.

``annotate`` and ``count`` act only while a ``torch.profiler`` session
records, so that the program can call them on its hot paths: otherwise each
is one check of PyTorch's flag. ``counters`` thus counts traced windows
only; ``trace`` clears it on entry and writes it as ``counters.json`` beside
its Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter, deque
from typing import Optional

import torch
from torch.profiler import ProfilerActivity

# what a span is while no profiler records: shared, it creates nothing
_NO_SPAN = contextlib.nullcontext()
counters: Counter = Counter()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; yields the ``torch.profiler.profile``
    (for ``key_averages()``), and writes its trace into ``logdir`` on exit,
    with the block's ``counters`` as ``counters.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    counters.clear()
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(dict(counters), f, indent=1, sort_keys=True)


def annotate(name: str):
    """Named region on the host timeline of a trace: a
    ``torch.profiler.record_function`` while a profiler records, else a
    shared no-op. The flag is PyTorch's own, set on a session's start and
    cleared on its stop."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int) -> None:
    """Adds ``n`` to ``counters[name]`` while a profiler records."""
    if torch.autograd.profiler._is_profiler_enabled:
        counters[name] += n


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

"""The traced window, reduced from ``torch.profiler``'s events in memory.

The window is the host range ``bench.window`` that the harness opens around
it. A device operation is an event on the card (a kernel, a copy or a
memset); ranges that code marks on the device timeline are not operations.
Busy time is the union of the operations' intervals inside the window, so
operations that overlap count once; an idle gap is a stretch of the window
that no operation covers, labelled by the innermost host operation that the
profiler shows running at its middle.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

WINDOW = "bench.window"
TOP = 10  # entries of each list of the breakdown
NAME = 200  # characters of a name kept in the breakdown


@dataclass
class Trace:
    """Times in seconds from the window's start."""

    window_s: float
    device_ops: List[Tuple[str, float, float]]  # (name, start, end), clipped
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def kernels(self):
        """The device operations that are kernels (not copies or memsets)."""
        return [op for op in self.device_ops if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged = []
        for _, start, end in sorted(self.device_ops, key=lambda op: op[1]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        out, last = [], 0.0
        for start, end in self.busy_intervals():
            if start > last:
                out.append((last, start))
            last = max(last, end)
        if last < self.window_s:
            out.append((last, self.window_s))
        return out

    def _labels(self, mids) -> List[str]:
        """The innermost host operation running at each of ``mids`` (sorted),
        by a sweep over the host operations in order of start, a stack of
        the open ones."""
        ops = sorted(self.host_ops, key=lambda op: (op[1], -op[2]))
        labels, stack, i = [], [], 0
        for mid in mids:
            while i < len(ops) and ops[i][1] <= mid:
                while stack and stack[-1][2] < ops[i][1]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            labels.append(stack[-1][0] if stack else "no host operation")
        return labels

    def breakdown(self) -> dict:
        """The device operations that took most time, by name, and the idle
        time by the host operation under each gap."""
        by_name = defaultdict(float)
        for name, start, end in self.device_ops:
            by_name[name[:NAME]] += end - start
        idle = defaultdict(float)
        gaps = self.gaps()
        for (start, end), label in zip(gaps, self._labels([0.5 * (a + b) for a, b in gaps])):
            idle[label[:NAME]] += end - start
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def from_profiler(prof) -> Trace:
    """The :class:`Trace` of a stopped ``torch.profiler.profile`` whose host
    events hold one ``bench.window`` range. Reads the profiler's raw events,
    which costs far less than its event tree on a trace of a million."""
    from torch.autograd import DeviceType

    events = [(e.name(), e.device_type(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.is_user_annotation()) for e in prof.profiler.kineto_results.events()]
    window = [e for e in events if e[0] == WINDOW and e[1] == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} ranges named {WINDOW!r}, not 1")
    t0, t1 = window[0][2], window[0][3]
    device, host = [], []
    for name, kind, start, end, annotation in events:
        start, end = max(start, t0), min(end, t1)
        if end < start or name == WINDOW:
            continue
        op = (name, (start - t0) * 1e-9, (end - t0) * 1e-9)
        if kind == DeviceType.CUDA:
            if not annotation:
                device.append(op)
        elif kind == DeviceType.CPU:
            host.append(op)
    return Trace((t1 - t0) * 1e-9, device, host)

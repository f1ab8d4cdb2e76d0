"""The card's idle time inside the program's own spans.

``ultra_tpu_torch/train/eval.py::collect_rankings`` records, while a
profiler records, the span ``ultra.eval.collect_rankings`` and inside it one
span per phase (``utils/profiling.py::annotate``). Spans are host
operations of the :class:`~benchmark.harness.trace.Trace`, on the device
trace's clock. A program without them (one older than its spans) leaves the
readers of this file nothing to read.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

CALL = "ultra.eval.collect_rankings"


def traced(trace) -> bool:
    """Whether the window holds the program's spans."""
    return any(op[0] == CALL for op in trace.host_ops)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering the same time as ``intervals``."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def overlap(a, b) -> float:
    """The time two lists of sorted, disjoint intervals share."""
    shared, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        shared += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def idle_s(trace, names) -> float:
    """Seconds inside the spans named ``names`` in which no device
    operation runs: the time their union shares with the window's gaps."""
    spans = union((start, end) for name, start, end in trace.host_ops if name in names)
    return overlap(spans, trace.gaps())


def idle_pct(trace, names) -> Optional[float]:
    """:func:`idle_s` as a share of the window; nothing without the
    program's spans."""
    if not traced(trace) or trace.window_s <= 0:
        return None
    return 100.0 * idle_s(trace, set(names)) / trace.window_s

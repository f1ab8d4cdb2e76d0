"""The card's idle time inside the spans of UltraQuery's evaluation call.

``ultra_tpu_torch/query/trainer.py::rank_queries`` records, while a profiler
records, the span ``ultra.query.rank_queries`` and inside it one span per
phase (``utils/profiling.py::annotate``). ``harness/spans.py``'s readers key
on the ranking loop's call; these key on this one. A program without it
(one older than its spans) leaves them nothing to read.
"""

from __future__ import annotations

from typing import Optional

from benchmark.harness.spans import idle_s

CALL = "ultra.query.rank_queries"


def traced(trace) -> bool:
    """Whether the window holds the evaluation call's span."""
    return any(op[0] == CALL for op in trace.host_ops)


def idle_pct(trace, names) -> Optional[float]:
    """``spans.idle_s`` of the spans ``names`` as a share of the window;
    nothing without the call's span."""
    if not traced(trace) or trace.window_s <= 0:
        return None
    return 100.0 * idle_s(trace, set(names)) / trace.window_s

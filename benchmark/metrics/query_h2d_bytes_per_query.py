"""``query_h2d_bytes_per_query.<cell kind>``: the bytes UltraQuery's
evaluation call copied from the host to the card in the traced window (the
program's counter ``h2d_bytes``, ``ultra_tpu_torch/utils/profiling.py::
counters``, which counts only while a profiler records: the programs, their
schedules and the answer lists) over the queries answered in it. Nothing
without the call's span (``harness/query_spans.py``)."""

from benchmark.harness import query_spans


def read(ctx):
    if not query_spans.traced(ctx.trace) or not ctx.work["queries"]:
        return None
    from ultra_tpu_torch.utils import profiling

    return profiling.counters["h2d_bytes"] / ctx.work["queries"]

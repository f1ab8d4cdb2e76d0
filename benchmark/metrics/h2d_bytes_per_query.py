"""``h2d_bytes_per_query.<cell kind>``: the bytes the program copied from
the host to the card in the traced window (its counter ``h2d_bytes``,
``ultra_tpu_torch/utils/profiling.py::counters``, which counts only while
a profiler records) over the queries answered in it. Nothing without the
program's spans."""

from benchmark.harness.spans import traced


def read(ctx):
    if not traced(ctx.trace) or not ctx.work["queries"]:
        return None
    from ultra_tpu_torch.utils import profiling

    return profiling.counters["h2d_bytes"] / ctx.work["queries"]

"""``cast_bytes_per_query.<cell kind>``: the bytes the convs' casts of their
rspmm operands to the compute dtype read and write in the traced window
(the program's profiling counter ``cast_bytes``, ``ultra_tpu_torch/models/
layers.py``, which counts only while a profiler records) over the queries
answered in it. Nothing where the program has no such counter."""

from benchmark.harness.spans import traced


def read(ctx):
    if not traced(ctx.trace) or not ctx.work["queries"]:
        return None
    from ultra_tpu_torch.utils import profiling

    if "cast_bytes" not in profiling.counters:
        return None
    return profiling.counters["cast_bytes"] / ctx.work["queries"]

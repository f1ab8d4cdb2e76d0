"""``conv_tail_roofline.<cell kind>``: the conv's tail E2's share of its
roofline, the sum of its launches' least times over the sum of its kernels'
device times in the trace.

The launches' rows are the program's profiling counter ``conv_tail_rows``
(``ultra_tpu_torch/ops/conv_tail_cuda.py``, which adds each launch's rows
while a profiler records, so in the traced window alone); a launch's least
time is ``data/conv_tail.py::conv_tail_bound_ms``, taken over the summed
rows. The device time is
that of the kernels named ``conv_tail_kernel``. Nothing where the program
has no such counter or the trace no such kernel.
"""

from benchmark.data.conv_tail import conv_tail_bound_ms

KERNEL = "conv_tail_kernel"


def read(ctx):
    from ultra_tpu_torch.utils import profiling

    rows = profiling.counters.get("conv_tail_rows")
    device_s = sum(end - start for name, start, end in ctx.trace.kernels if KERNEL in name)
    if not rows or not device_s:
        return None
    return 100.0 * conv_tail_bound_ms(rows) * 1e-3 / device_s

"""One run of one cell: set-up, the measured window, the metrics, the check.

The order is the contract's: set-up (counted in ``setup_s`` from the start
of the process) warms every shape the window uses; the window runs for the
given seconds (traced when asked, and then for :data:`TRACE_SECONDS` at
most); the device's peak memory is read; the
program's state is freed; then the reference checks a sample of what the
window produced, so that its own memory and time count in neither.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from benchmark.harness import cells, program
from benchmark.harness import trace as trace_lib

FORBIDDEN = ("jax", "jaxlib", "flax", "ultra_tpu", "bench")
# a traced run's window, at most: the per-layer metrics are shares and
# rates, and the profiler's own processing of a longer trace of the
# host-bound cell would take most of a run's time limit
TRACE_SECONDS = 20.0


def forbidden_modules() -> list:
    """The modules loaded in this process whose top-level name (the part
    before the first dot, compared whole) is the JAX package's, JAX's or
    the TPU benchmark's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def seed_of(seed: int) -> int:
    """The seed as the generators take it: a whole number from 0 to 2**63."""
    return int(seed) % (1 << 63)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             control=None, started: float | None = None, cell: dict | None = None) -> dict:
    """The result of one run (the fields of the printed line, and
    ``checks``: each compared number with its limit). ``cell`` replaces
    the cell's files (tests run a cell at a small size)."""
    if control not in program.CONTROLS:
        raise ValueError(f"control must be one of {program.CONTROLS}, got {control!r}")
    started = time.perf_counter() if started is None else started
    c = cell or cells.cell(name)
    drv = cells.driver(c["traffic"]["driver"])
    seed = seed_of(seed)
    cuda = torch.device(device).type == "cuda"
    with program.control_precision(control):
        session = drv.setup(c, seed, device, control)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - started
        counters = program.launch_counters()
        for counter in counters.values():
            counter.clear()
        tracer = _Tracer(cuda) if trace else None
        t0 = time.perf_counter()
        drv.window(session, min(seconds, TRACE_SECONDS) if trace else seconds,
                   tracer.span if trace else _no_span)
        if cuda:
            torch.cuda.synchronize()
        work = dict(drv.work(session), seconds=time.perf_counter() - t0)
        if trace:
            tracer.stop()
    launches = {k: dict(v) for k, v in counters.items() if v}
    graphs = drv.graphs(session)
    memory = torch.cuda.max_memory_allocated() if cuda else 0
    out = {"metrics": {}, "device": {"platform": "gpu" if cuda else "cpu",
                                     "kind": torch.cuda.get_device_name() if cuda else "cpu",
                                     "count": c["workload"]["chips"], "memory_peak_bytes": memory}}
    if trace:
        t0 = time.perf_counter()
        tr = trace_lib.from_profiler(tracer.prof)
        tracer.prof = None
        ctx = _Context(c, tr, work, launches, graphs)
        for m in c["per_layer"]:
            value = cells.reader(m["name"]).read(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
        work.update(stop_s=tracer.stop_s, reduce_s=time.perf_counter() - t0)
    else:
        values = dict(drv.end_to_end(session, work), setup_s=setup_s)
        for m in c["end_to_end"]:
            out["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    drv.release(session)
    if cuda:
        torch.cuda.empty_cache()
    found = drv.check(session)
    want = c["limits"]
    checks = {k: {"value": v, "limit": want.get(k)} for k, v in found.items()
              if not k.startswith("_")}
    ok = work["failed"] == 0 and all(
        ch["limit"] is not None and ch["value"] <= ch["limit"] for ch in checks.values())
    return {"correct": ok, "attempted": work["attempted"], "failed": work["failed"], **out,
            "notes": {k[1:]: v for k, v in found.items() if k.startswith("_")},
            "launches": launches, "work": work, "checks": checks}


def _no_span(_name):
    return contextlib.nullcontext()


class _Tracer:
    """``torch.profiler`` over the window, in the ``bench.window`` range;
    the driver opens a span around each call into the program."""

    span = staticmethod(torch.profiler.record_function)

    def __init__(self, cuda: bool):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.range = torch.profiler.record_function(trace_lib.WINDOW)
        self.range.__enter__()

    def stop(self):
        """Ends the trace, after the window's work has finished on the card."""
        self.range.__exit__(None, None, None)
        t0 = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t0


class _Context:
    """What a per-layer reader reads: the cell (``config``, ``traffic``),
    the trace, the driver's account of the window's work, the program's
    launch counters over the window and the graphs' sizes."""

    def __init__(self, c, tr, work, launches, graphs):
        self.config, self.traffic, self.trace = c["config"], c["traffic"], tr
        self.work, self.launches, self.graphs = work, launches, graphs

"""The port's spans and counters (``ultra_tpu_torch/utils/profiling.py``)
and the spans and host-to-device byte count of the ranking loop
(``train/eval.py::collect_rankings``), on the CPU.

``annotate`` and ``count`` act only while a ``torch.profiler`` session
records; otherwise each is a check of PyTorch's flag
``torch.autograd.profiler._is_profiler_enabled``, which these tests pin so
that an upgrade of PyTorch that drops it fails here. The ranking loop's
results must be the same, bit for bit, traced or not.
"""

import json

import numpy as np
import pytest
import torch

from ultra_tpu_torch import tasks
from ultra_tpu_torch.data.synthetic import random_kg_triples, synthetic_graph
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.train import eval as peval
from ultra_tpu_torch.utils import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def record_function_calls(monkeypatch):
    """Counts the ``torch.profiler.record_function`` objects made."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    profiling.counters.clear()
    yield calls
    profiling.counters.clear()


def test_the_profiler_flag_follows_start_and_stop():
    assert torch.autograd.profiler._is_profiler_enabled is False
    prof = torch.profiler.profile(activities=CPU)
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled is True
    finally:
        prof.stop()
    assert torch.autograd.profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=CPU):
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_without_a_profiler_annotate_and_count_do_nothing(record_function_calls):
    span = profiling.annotate("ultra.test.idle")
    assert span is profiling.annotate("ultra.test.other")
    with span as entered:
        assert entered is None
    profiling.count("h2d_bytes", 123)
    assert record_function_calls == [] and not profiling.counters


def test_under_a_profiler_annotate_and_count_record(record_function_calls):
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.annotate("ultra.test.outer"):
            with profiling.annotate("ultra.test.inner"):
                torch.ones(4).sum()
        profiling.count("h2d_bytes", 5)
        profiling.count("h2d_bytes", 7)
    profiling.count("h2d_bytes", 1000)  # after the stop: not counted
    assert record_function_calls == ["ultra.test.outer", "ultra.test.inner"]
    assert profiling.counters == {"h2d_bytes": 12}
    inner = [e for e in prof.events() if e.name == "ultra.test.inner"]
    assert len(inner) == 1 and inner[0].cpu_parent.name == "ultra.test.outer"


def test_trace_clears_the_counters_and_writes_them_beside_its_trace(tmp_path):
    profiling.counters["stale"] = 3
    try:
        with profiling.trace(str(tmp_path)):
            profiling.count("h2d_bytes", 40)
            profiling.count("h2d_bytes", 2)
        assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
        assert json.loads((tmp_path / "counters.json").read_text()) == {"h2d_bytes": 42}
    finally:
        profiling.counters.clear()


# ---------------------------------------------------------- the ranking loop

V, R_DIRECT, T, D, BATCH, TRIPLES = 40, 4, 150, 16, 4, 10
PHASES = ("mask", "upload", "score", "download", "negatives")


@pytest.fixture(scope="module")
def ranking():
    graph, ei, et = synthetic_graph(V, R_DIRECT, T, seed=3, device="cpu")
    nb = lambda **kw: nbfnet.NBFNetConfig(input_dim=D, hidden_dims=(D, D), **kw)  # noqa: E731
    torch.manual_seed(0)
    model = nbfnet.Ultra(nbfnet.UltraConfig(
        relation_model=nb(num_relation=4),
        entity_model=nb(num_relation=1, project_relations=True)))
    index = tasks.GraphIndex.build(ei, et, V, 2 * R_DIRECT)
    trips = random_kg_triples(V, R_DIRECT, T, seed=3)[:TRIPLES]
    return model, graph, index, trips


@pytest.mark.parametrize("cache_relations", [False, True])
def test_collect_rankings_records_its_phases_and_answers_the_same(ranking, cache_relations):
    model, graph, index, trips = ranking
    kw = dict(batch_size=BATCH, cache_relations=cache_relations)
    plain = peval.collect_rankings(model, graph, trips, index, **kw)
    profiling.counters.clear()
    with torch.profiler.profile(activities=CPU) as prof:
        traced = peval.collect_rankings(model, graph, trips, index, **kw)
    for want, got in zip(plain, traced):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)

    spans = [e for e in prof.events() if e.name.startswith("ultra.eval.")]
    calls = [e for e in spans if e.name == "ultra.eval.collect_rankings"]
    assert len(calls) == 1
    call = calls[0]
    batches = -(-TRIPLES // BATCH)
    want = {f"ultra.eval.{p}": batches for p in PHASES}
    if cache_relations:
        want["ultra.eval.precompute"] = 1
    got = {}
    for e in spans:
        if e is not call:
            got[e.name] = got.get(e.name, 0) + 1
            assert e.cpu_parent is call, e.name
            assert call.time_range.start <= e.time_range.start <= e.time_range.end \
                <= call.time_range.end
    assert got == want
    # each batch's phases in order, siblings that do not overlap
    phases = sorted((e for e in spans if e is not call), key=lambda e: e.time_range.start)
    order = [e.name.split(".")[-1] for e in phases if e.name != "ultra.eval.precompute"]
    assert order == list(PHASES) * batches
    for a, b in zip(phases, phases[1:]):
        assert a.time_range.end <= b.time_range.start
    # nothing is copied to a device on the CPU
    assert profiling.counters["h2d_bytes"] == 0

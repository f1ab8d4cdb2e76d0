"""The bf16 ranking cell, ``ultra_3g_bf16.rank.yago310``, on the CPU at a
small size: sound, it comes out correct against the bf16 reference; with an
answer altered, the filter left out, the entity model left in float32, or
under the cell's ``bf16`` control (every weight rounded to bf16), it does
not. The limits are the cell's own (``limits/<cell>.json``). The graph has
2,000 entities, where the rank cell's tests take 300: a precision fault
moves the scores of every node by about 1e-3, and among 300 candidates so
far apart few ranks move, so the median gap would read 0. Its readers of
E2's time and of the casts' bytes read nothing where the program has no
such counter or kernel."""

import copy
from types import SimpleNamespace

import pytest

from benchmark.harness import cells, runner
from benchmark.harness.trace import Trace
from benchmark.tests.test_bench_faults import _altered_ranking, _unfiltered

NAME = "ultra_3g_bf16.rank.yago310"


def small(entity_f32=False):
    """The cell on a graph of 2,000 entities, 5 relations and 8,000 / 48 /
    48 triples, every test triple checked."""
    c = copy.deepcopy(cells.cell(NAME))
    t = c["traffic"]
    t["graph"].update(entities=2000, direct_relations=5, splits=[8000, 48, 48], categories=0)
    t.update(chunk=8, warmup_triples=8, check_triples=48)
    if entity_f32:
        del c["config"]["entity_model"]["compute_dtype"]
    return c


def _run(cell, trace=False, control=None):
    return runner.run_cell(NAME, 2**31 + 12345, 0.2, trace=trace, device="cpu", cell=cell,
                           control=control)


def test_a_sound_run_is_correct():
    res = _run(small())
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("module,attr,fault", [
    ("ultra_tpu_torch.tasks", "compute_ranking", _altered_ranking),
    ("ultra_tpu_torch.tasks", "strict_negative_mask", _unfiltered),
], ids=["answer-altered", "unfiltered"])
def test_a_broken_run_is_not_correct(module, attr, fault, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    res = _run(small())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("case", ["entity model in f32", "bf16 control"])
def test_a_lower_or_other_precision_is_not_correct(case):
    if case == "entity model in f32":
        res = _run(small(entity_f32=True))
    else:
        res = _run(small(), control="bf16")
    assert not res["correct"], res["checks"]
    median = res["checks"]["rank_gap_median"]
    assert median["value"] > median["limit"]


def test_a_traced_run_reads_the_casts_and_not_e2_on_the_cpu():
    from ultra_tpu_torch.utils import profiling

    profiling.counters.clear()
    res = _run(small(), trace=True)
    profiling.counters.clear()
    metrics = res["metrics"]
    # 6 layers a model: the entity pass of 16 queries casts (2,000 x 16 x 64)
    # node states and (10 x 16 x 64) relation features, 6 bytes an element,
    # each layer: 6 x 2,010 x 64 x 6 bytes a query, and the precompute's more
    assert metrics["cast_bytes_per_query.bf16"]["value"] >= 6 * 2010 * 64 * 6
    assert "conv_tail_roofline.bf16" not in metrics  # no kernel on the CPU


def _ctx(kernels, counters, monkeypatch):
    from ultra_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", counters)
    return SimpleNamespace(trace=Trace(10.0, kernels), work={"queries": 16})


def test_conv_tail_roofline_reads_the_rows_over_the_kernels_time(monkeypatch):
    from benchmark.data.conv_tail import conv_tail_bound_ms

    read = cells.reader("conv_tail_roofline.bf16").read
    kernels = [("void conv_tail_kernel<64, 4, 1, true, true, true>", 0.0, 0.002),
               ("void pieces::piece_kernel<...>", 0.002, 0.01)]
    rows = 6 * 123_182 * 16
    got = read(_ctx(kernels, {"conv_tail_rows": rows}, monkeypatch))
    assert got == pytest.approx(100 * conv_tail_bound_ms(rows) * 1e-3 / 0.002)
    # a program without the counter (the parent), or a window without E2
    assert read(_ctx(kernels, {}, monkeypatch)) is None
    assert read(_ctx(kernels[1:], {"conv_tail_rows": rows}, monkeypatch)) is None


def test_cast_bytes_reads_nothing_without_the_counter(monkeypatch):
    read = cells.reader("cast_bytes_per_query.bf16").read
    spans = [("ultra.eval.collect_rankings", 0.0, 1.0)]
    ctx = _ctx([], {}, monkeypatch)
    ctx.trace = Trace(10.0, [], spans)
    assert read(ctx) is None
    ctx = _ctx([], {"cast_bytes": 1600}, monkeypatch)
    ctx.trace = Trace(10.0, [], spans)
    assert read(ctx) == 100.0

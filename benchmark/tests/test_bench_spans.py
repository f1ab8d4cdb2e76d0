"""The readers of the program's spans and counter (``harness/spans.py``,
``metrics/{host,copy,launch}_idle_pct.py``, ``metrics/h2d_bytes_per_query.py``)
against hand counts; a tiny traced run of the ranking cell on the CPU; and,
on the card (marker ``card``), a traced run of the ranking cell held to the
profiler's own copies and clock."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import cells, runner, spans
from benchmark.harness import trace as trace_lib
from benchmark.harness.trace import Trace

RANK = "ultra_3g.rank.yago310"
IDLE = ("host_idle_pct.rank", "copy_idle_pct.rank", "launch_idle_pct.rank")
PROGRAM = IDLE + ("h2d_bytes_per_query.rank",)


def read(metric, trace, queries=16):
    return cells.reader(metric).read(SimpleNamespace(trace=trace, work={"queries": queries}))


def one_batch():
    """A window of 10 s: one call of one batch after a precompute. The card
    runs 0.5-1, 1.5-2 (the precompute), 3.2-3.4 (the upload's copy) and
    4-6.5 (the pass, past the score span into the download)."""
    call = "ultra.eval."
    host = [(call + "collect_rankings", 0.2, 9.5), (call + "precompute", 0.2, 2.2),
            (call + "mask", 2.2, 3.0), (call + "upload", 3.0, 3.5),
            (call + "score", 3.5, 5.0), (call + "download", 5.0, 7.0),
            (call + "negatives", 7.0, 9.0), ("aten::copy_", 3.1, 3.4)]
    device = [("k", 0.5, 1.0), ("k", 1.5, 2.0), ("Memcpy HtoD", 3.2, 3.4), ("k", 4.0, 6.0),
              ("k", 5.5, 6.5)]
    return Trace(10.0, device, host)


def test_union_and_overlap_by_hand():
    assert spans.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    assert spans.overlap([(0, 2), (3, 5)], [(1, 4), (4.5, 6)]) == pytest.approx(2.5)
    assert spans.overlap([], [(0, 1)]) == 0.0


def test_idle_readers_by_hand():
    tr = one_batch()
    # mask 0.8 idle, negatives 2.0 idle; upload 0.5 - 0.2 copy, download 2 - 1.5 pass;
    # precompute 2.0 - 1.0, score 1.5 - 1.0
    assert read("host_idle_pct.rank", tr) == pytest.approx(100 * 2.8 / 10)
    assert read("copy_idle_pct.rank", tr) == pytest.approx(100 * 0.8 / 10)
    assert read("launch_idle_pct.rank", tr) == pytest.approx(100 * 1.5 / 10)
    # the three add up to the card's idle time less what no phase covers: 0.2 before
    # the call, 0.5 in it after its negatives, 0.5 after it
    total = sum(read(m, tr) for m in IDLE)
    device_idle = cells.reader("device_idle_pct.rank").read(SimpleNamespace(trace=tr))
    assert device_idle - total == pytest.approx(100 * 1.2 / 10)


def test_a_span_the_card_covers_reads_zero():
    call = [("ultra.eval.collect_rankings", 0.0, 4.0), ("ultra.eval.mask", 1.0, 2.0)]
    tr = Trace(4.0, [("k", 0.5, 2.5)], call)
    assert read("host_idle_pct.rank", tr) == 0.0
    assert read("copy_idle_pct.rank", tr) == 0.0


def test_without_the_programs_spans_nothing_is_read(monkeypatch):
    from ultra_tpu_torch.utils import profiling

    monkeypatch.setitem(profiling.counters, "h2d_bytes", 1000)
    tr = Trace(10.0, [("k", 0.5, 1.0)], [("bench.collect_rankings", 0.0, 9.0),
                                          ("ultra.eval.mask", 1.0, 2.0)])
    assert all(read(m, tr) is None for m in PROGRAM)
    assert read("h2d_bytes_per_query.rank", one_batch()) == pytest.approx(1000 / 16)
    assert read("h2d_bytes_per_query.rank", one_batch(), queries=0) is None


def test_a_tiny_traced_run_reads_the_programs_metrics(tiny):
    """On the CPU the trace holds no device operation: the readers of the
    device trace read nothing (the card test reads them), the program's
    readers and ``mfu`` read; no byte goes to a device."""
    res = runner.run_cell(RANK, 2**31 + 4321, 0.5, trace=True, device="cpu",
                          cell=tiny(RANK))
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == set(PROGRAM) | {"mfu.rank"}
    assert got["h2d_bytes_per_query.rank"] == 0
    # the card is idle the whole window on the CPU: the phases cover most of it
    assert 50 < sum(got[m] for m in IDLE) <= 100


@pytest.mark.card
def test_a_traced_rank_run_agrees_with_the_profilers_copies_and_clock(card, tmp_path,
                                                                      monkeypatch):
    """The counter equals the bytes of the window's host-to-device copies in
    the profiler's Chrome trace; no device operation that starts before a
    download span ends ends more than 0.1 ms after it (the spans and the
    device share a clock); the three idle shares come to 90-100% of the
    card's idle share."""
    from ultra_tpu_torch.utils import profiling

    kept = {}
    real = trace_lib.from_profiler

    def spy(prof):
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
        kept["trace"] = real(prof)
        return kept["trace"]

    monkeypatch.setattr(trace_lib, "from_profiler", spy)
    profiling.counters.clear()
    res = runner.run_cell(RANK, 2**31 + 97, 3.0, trace=True, device=card)
    assert res["correct"], res["checks"]
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(metrics) == {m["name"] for m in cells.cell(RANK)["per_layer"]}

    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    copied = sum(e["args"]["bytes"] for e in events
                 if e.get("name", "").startswith("Memcpy HtoD"))
    assert profiling.counters["h2d_bytes"] == copied > 0
    assert metrics["h2d_bytes_per_query.rank"] * res["work"]["queries"] == pytest.approx(copied)

    tr = kept["trace"]
    ends = [end for name, start, end in tr.host_ops if name == "ultra.eval.download"]
    assert ends
    late = max(max((e for _, s, e in tr.device_ops if s < end), default=end) - end
               for end in ends)
    assert late <= 1e-4, late

    total = sum(metrics[m] for m in IDLE)
    idle = metrics["device_idle_pct.rank"]
    assert 0.9 * idle <= total <= idle + 0.05, (total, idle)

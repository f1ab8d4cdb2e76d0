"""The evaluation cell of UltraQuery, ``ultraquery.eval.fb237_betae``
(``drivers/eval_query.py``), on the CPU at a tiny size: sound, it comes out
correct; with the program broken underneath in each way its answers can
break, not correct. Beside it the pieces it brings: the test queries with
their answers (``data/betae_answers.py``), the reference's gaps of many
ranks at once (``reference/query_ranking.py``) and the readers of the
executor's spans (``metrics/cheap_idle_pct.py``,
``metrics/query_host_idle_pct.py``, ``metrics/query_launch_idle_pct.py``)
and of its upload counter (``metrics/query_h2d_bytes_per_query.py``)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.data import betae, betae_answers, kg
from benchmark.harness import cells, runner
from benchmark.harness import trace as trace_lib
from benchmark.harness.trace import Trace
from benchmark.reference import query_ranking, ranking
from benchmark.tests.conftest import tiny_cell

EVAL = "ultraquery.eval.fb237_betae"
SEED = 2**31 + 2024


def tiny():
    """The cell at a size the CPU runs in seconds: 4 queries a type in
    batches of 4 (one type a batch, as in the cell), every query judged."""
    c = tiny_cell(EVAL)
    c["traffic"].update(sampled_per_type=32, batch_size=4, check_queries=10**6)
    return c


def _run(c=None):
    return runner.run_cell(EVAL, SEED, 0.2, trace=False, device="cpu", cell=c or tiny())


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 56 and res["attempted"] % 56 == 0 and res["failed"] == 0
    assert res["checks"]["answer_mismatch"]["value"] == 0
    assert res["notes"]["compared"] > 40
    work = res["work"]
    calls = work["calls"]
    assert work["relation_queries"] == calls * 12  # 6 relations, both directions
    # projections of one query of each type: 1+2+3+2+3+3+3+2+3+3+3+3+2+3
    assert work["entity_queries"] == calls * 4 * 36


def _rank_moved_by_one(original):
    """The best hard answer of every query ranked one lower, where the
    ranks are made."""
    def batch_evaluate_device(pred, answers, keep=None):
        hard, answer, num_easy, num_hard = original(pred, answers, keep)
        first = torch.cumsum(num_hard, 0) - num_hard
        hard = hard.clone()
        hard[first[num_hard > 0]] += 1
        return hard, answer, num_easy, num_hard
    return batch_evaluate_device


def _answer_moved_by_one(original):
    """The last answer of every query one place lower in the unfiltered
    ranking, where the ranks are made."""
    def batch_evaluate_device(pred, answers, keep=None):
        hard, answer, num_easy, num_hard = original(pred, answers, keep)
        answer = answer.clone()
        answer[torch.cumsum(num_easy + num_hard, 0) - 1] += 1
        return hard, answer, num_easy, num_hard
    return batch_evaluate_device


def _gate_dropped(original):
    """The predicted answer-set size summed over every probability."""
    def predicted_size(pred):
        return torch.sigmoid(pred.double()).sum(dim=-1)
    return predicted_size


def _size_in_half_precision(original):
    """The predicted answer-set size summed in bfloat16."""
    def predicted_size(pred):
        prob = torch.sigmoid(pred.bfloat16())
        return (prob * (prob > 0.5)).sum(dim=-1).double()
    return predicted_size


def _easy_unfiltered(original):
    """The easy answers left out of the answer lists: the ranks count them
    as non-answers."""
    def pack_answers(easy, hard):
        return original([np.zeros(0, np.int64)] * len(easy), hard)
    return pack_answers


def _projection_dropped(original):
    """Every third projection pass returns its input set unprojected."""
    calls = []

    def relation_projection(model, qcfg, graph, h_prob, r_index, rel_reprs_all=None):
        calls.append(1)
        if len(calls) % 3 == 2:
            return h_prob
        return original(model, qcfg, graph, h_prob, r_index, rel_reprs_all=rel_reprs_all)
    return relation_projection


@pytest.mark.parametrize("module,attr,fault,caught_by", [
    ("ultra_tpu_torch.query.metrics", "batch_evaluate_device", _rank_moved_by_one, "rank_gap"),
    ("ultra_tpu_torch.query.metrics", "pack_answers", _easy_unfiltered, "answer_mismatch"),
    ("ultra_tpu_torch.query.executor", "relation_projection", _projection_dropped, "rank_gap"),
    ("ultra_tpu_torch.query.metrics", "batch_evaluate_device", _answer_moved_by_one,
     "answer_rank_gap"),
    ("ultra_tpu_torch.query.metrics", "predicted_size", _gate_dropped, "num_pred_error"),
    ("ultra_tpu_torch.query.metrics", "predicted_size", _size_in_half_precision,
     "num_pred_error"),
], ids=["rank-moved-by-one", "easy-unfiltered", "projection-dropped", "answer-moved-by-one",
        "gate-dropped", "size-in-bf16"])
def test_a_broken_run_is_not_correct(module, attr, fault, caught_by, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"][caught_by]["value"] > res["checks"][caught_by]["limit"], res["checks"]


def test_the_pool_follows_betaes_rule():
    """Every query kept has a hard answer; its easy answers are its answers
    on the training graph, its hard ones those on the full graph less the
    easy; the pool is drawn from the graph's structure alone."""
    t = tiny()["traffic"]
    g = t["graph"]
    splits = kg.split_triples(g)
    pool = betae_answers.query_pool(t, splits)
    assert list(pool) == t["types"] and all(len(q) == 4 for q in pool.values())
    train, full = betae_answers.adjacencies(splits, g["entities"], g["direct_relations"])
    for qtype, qs in pool.items():
        for inst, easy, hard in qs:
            on_train = betae.evaluate(inst, betae.TYPE2STRUCT[qtype], train)
            on_full = betae.evaluate(inst, betae.TYPE2STRUCT[qtype], full)
            np.testing.assert_array_equal(easy, np.flatnonzero(on_train))
            np.testing.assert_array_equal(hard, np.flatnonzero(on_full & ~on_train))
            assert len(hard)
    again = betae_answers.query_pool(t, splits)
    assert [q[0] for qs in again.values() for q in qs] == [q[0] for qs in pool.values()
                                                           for q in qs]


def test_hard_rank_gaps_are_rank_and_gap_at_once():
    rng = np.random.default_rng(5)
    v = 80
    scores = torch.tensor(rng.integers(0, 12, v) / 4.0)  # many ties
    easy = rng.choice(v, 10, replace=False)
    hard = np.setdiff1d(rng.choice(v, 15, replace=False), easy)
    served = rng.integers(-1, 75, len(hard))
    got = query_ranking.hard_rank_gaps(scores, easy, hard, served)
    mask = np.ones(v, dtype=bool)
    mask[easy] = mask[hard] = False
    ref_ranks = []
    for j, a in enumerate(hard):
        ref_rank, want = ranking.rank_and_gap(scores, int(a), mask, int(served[j]))
        assert got[j] == want
        ref_ranks.append(ref_rank)
    assert got.max() > 0 and (got == ranking.IMPOSSIBLE).any()
    assert not query_ranking.hard_rank_gaps(scores, easy, hard, ref_ranks).any()


def test_answer_rank_gaps_are_rank_and_gap_at_once():
    """Every other node a candidate: the gap of each served unfiltered
    position (0-based) equals ``rank_and_gap``'s of the rank one above it."""
    rng = np.random.default_rng(6)
    v = 80
    scores = torch.tensor(rng.integers(0, 12, v) / 4.0)  # many ties
    answers = rng.choice(v, 20, replace=False)
    served = rng.integers(0, v, len(answers))
    served[:2] = -1, v  # before the first node, past the last
    got = query_ranking.answer_rank_gaps(scores, answers, served)
    ref_positions = []
    for j, a in enumerate(answers):
        mask = np.ones(v, dtype=bool)
        mask[a] = False
        ref_rank, want = ranking.rank_and_gap(scores, int(a), mask, int(served[j]) + 1)
        assert got[j] == want
        ref_positions.append(ref_rank - 1)
    assert got.max() > 0 and (got == ranking.IMPOSSIBLE).any()
    assert not query_ranking.answer_rank_gaps(scores, answers, ref_positions).any()


def test_predicted_size_bounds_the_gate_both_ways():
    logits = torch.tensor([4.0, 1e-7, -1e-7, 0.0, -3.0], dtype=torch.float64)
    p = torch.sigmoid(logits).numpy()
    assert query_ranking.predicted_size(logits, 1e-5) == (p[0], p[0] + p[1] + p[2] + p[3])
    assert query_ranking.predicted_size(logits, 0.0) == (p[0] + p[1], p[0] + p[1])


def _reader(name, trace):
    return cells.reader(name).read(SimpleNamespace(trace=trace))


def test_the_span_readers_by_hand():
    """A window of 10 s: one call; the card runs 1-2 (the precompute, whose
    span starts at 0.6), 3-5 (a projection, past its span), 6-7 (the
    ranking) and 8-9."""
    q = "ultra.query."
    host = [(q + "rank_queries", 0.5, 9.5), (q + "precompute", 0.6, 1.5),
            (q + "schedule", 2.0, 2.5), (q + "cheap", 2.5, 3.5), (q + "project", 3.5, 4.0),
            (q + "cheap", 4.0, 5.5), (q + "metrics", 5.5, 6.5), (q + "download", 7.5, 9.5)]
    device = [("k", 1.0, 2.0), ("k", 3.0, 5.0), ("k", 6.0, 7.0), ("k", 8.0, 9.0)]
    tr = Trace(10.0, device, host)
    # cheap: 2.5-3 and 5-5.5 idle; schedule 0.5, metrics 5.5-6, download 7.5-8 and 9-9.5;
    # precompute 0.6-1, project none
    assert _reader("cheap_idle_pct.eval", tr) == pytest.approx(100 * 1.0 / 10)
    assert _reader("query_host_idle_pct.eval", tr) == pytest.approx(100 * 2.0 / 10)
    assert _reader("query_launch_idle_pct.eval", tr) == pytest.approx(100 * 0.4 / 10)
    bare = Trace(10.0, device, [h for h in host if h[0] != q + "rank_queries"])
    for name in ("cheap_idle_pct.eval", "query_host_idle_pct.eval",
                 "query_launch_idle_pct.eval", "query_h2d_bytes_per_query.eval"):
        ctx = SimpleNamespace(trace=bare, work={"queries": 10})
        assert cells.reader(name).read(ctx) is None, name


def test_a_tiny_traced_run_reads_the_programs_metrics():
    """On the CPU the trace holds no device operation: the readers of the
    device trace read nothing, the span readers and ``mfu`` read."""
    res = runner.run_cell(EVAL, SEED + 1, 0.3, trace=True, device="cpu", cell=tiny())
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {"cheap_idle_pct.eval", "query_host_idle_pct.eval",
                        "query_launch_idle_pct.eval", "query_h2d_bytes_per_query.eval",
                        "mfu.eval"}
    for name in ("cheap_idle_pct.eval", "query_host_idle_pct.eval",
                 "query_launch_idle_pct.eval"):
        assert 0 < got[name] < 100, name
    assert got["query_h2d_bytes_per_query.eval"] == 0  # nothing goes to a card


@pytest.mark.card
def test_a_traced_run_counts_every_upload_and_places_the_idle_card(card, tmp_path,
                                                                    monkeypatch):
    """At the cell's own size: the counter equals the bytes of the window's
    host-to-device copies in the profiler's Chrome trace, and the idle
    shares of the evaluation call's spans, which do not overlap, come to
    75-100% of the card's idle share."""
    from ultra_tpu_torch.utils import profiling

    real = trace_lib.from_profiler

    def spy(prof):
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
        return real(prof)

    monkeypatch.setattr(trace_lib, "from_profiler", spy)
    profiling.counters.clear()
    res = runner.run_cell(EVAL, 2**31 + 96, 3.0, trace=True, device=card)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    copied = sum(e["args"]["bytes"] for e in events
                 if e.get("name", "").startswith("Memcpy HtoD"))
    assert profiling.counters["h2d_bytes"] == copied > 0
    assert m["query_h2d_bytes_per_query.eval"] * res["work"]["queries"] == pytest.approx(copied)
    placed = sum(m[k] for k in ("cheap_idle_pct.eval", "query_host_idle_pct.eval",
                                "query_launch_idle_pct.eval"))
    assert 0.75 * m["device_idle_pct.eval"] <= placed <= m["device_idle_pct.eval"] + 1e-9, m

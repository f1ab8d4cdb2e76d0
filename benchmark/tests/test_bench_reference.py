"""The references against the port's CPU path at a tiny size: the graph of
relations, ULTRA's scores and filtered ranks, UltraQuery's answers to every
BetaE type. Both sides take the same weights, made by the benchmark."""

import numpy as np
import pytest
import torch

from benchmark.data import betae, kg
from benchmark.data.weights import make_weights
from benchmark.harness import cells, program
from benchmark.reference import query as ref_query
from benchmark.reference import ranking, relgraph, ultra
from benchmark.tests.conftest import SERVE, spec


def _graph(num_nodes=120, num_rel=4, num_triples=500, seed=0):
    trip = kg.random_kg_triples(num_nodes, num_rel, num_triples, seed=seed, rel_dist="zipf")
    ei, et = kg.with_inverses(trip, num_rel)
    return trip, ei, et


def test_relation_graph_is_the_ports():
    from ultra_tpu_torch import tasks

    _, ei, et = _graph()
    want = tasks.build_relation_graph_arrays(ei, et, 120, 8)
    got = relgraph.relation_graph(ei, et, 120, 8, "cpu")
    as_set = lambda d, s, t: set(zip(d.tolist(), s.tolist(), t.tolist()))  # noqa: E731
    assert as_set(got["dst"], got["src"], got["etype"]) == as_set(want[0][0], want[0][1], want[1])


def test_weights_fit_the_port_and_count_its_parameters():
    cfg = cells.cell("ultra_3g.rank.yago310")["config"]
    w = make_weights(cfg, 7, "cpu")
    model = program.ultra_model(cfg, w, "cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    again = make_weights(cfg, 7, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


@torch.no_grad()
def test_scores_and_filtered_ranks_match_the_port():
    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.data.kg import KGSplit, split_to_graph
    from ultra_tpu_torch.models.nbfnet import entity_nbfnet_score_all
    from ultra_tpu_torch.train.eval import (collect_rankings,
                                            precompute_relation_representations)

    cfg = cells.cell("ultra_3g.rank.yago310")["config"]
    trip, ei, et = _graph()
    train, test = trip[:460], trip[460:]
    w = make_weights(cfg, 3, "cpu")
    model = program.ultra_model(cfg, w, "cpu")
    split = KGSplit(*kg.with_inverses(train, 4), 120, 8, train[:, :2].T.copy(), train[:, 2])
    graph = split_to_graph(split, device="cpu")
    index = tasks.GraphIndex.build(trip[:, :2].T, trip[:, 2], 120, 8)

    edges = kg.with_inverses(train, 4)
    ref_graph = relgraph.entity_graph(*edges, 120, 8, "cpu")
    ref_rel = relgraph.relation_graph(*edges, 120, 8, "cpu")
    rels = torch.arange(8)
    want = precompute_relation_representations(model, graph)
    got = ultra.relation_representations(w, cfg, ref_rel, rels)
    assert torch.allclose(got, want, atol=1e-5)

    heads, qrels = torch.tensor([3, 9, 40, 41]), torch.tensor([0, 5, 2, 7])
    rel_repr = got[torch.tensor([0, 1, 2, 3])]
    port = entity_nbfnet_score_all(model.entity_model, graph, want[torch.tensor([0, 1, 2, 3])],
                                   heads, qrels)
    ref = ultra.score_all(w, cfg, ref_graph, rel_repr, heads, qrels)
    assert torch.allclose(ref, port, atol=1e-4)

    ranks, negs, _, _ = collect_rankings(model, graph, test, index, batch_size=8)
    filt = ranking.Filter(trip, 120)
    reprs = got
    for b in range(0, len(test), 8):
        batch = test[b:b + 8]
        for direction, k in (("tail", 0), ("head", 1)):
            for i, (h, t, r) in enumerate(batch.tolist()):
                anchor, target, qrel = (h, t, r) if direction == "tail" else (t, h, r + 4)
                sc = ultra.score_all(w, cfg, ref_graph, reprs[r][None], torch.tensor([anchor]),
                                     torch.tensor([qrel]))[0]
                mask = filt.candidates(direction, anchor, r, target)
                pos = 2 * b + k * len(batch) + i
                _, gap = ranking.rank_and_gap(sc, target, mask, int(ranks[pos]))
                assert gap <= 1e-5 and int(negs[pos]) == mask.sum()


def test_rank_gap_by_hand():
    scores = torch.tensor([0.9, 0.5, 0.7, 0.1, 0.6])
    mask = np.array([True, True, False, True, True])  # 2 is the target
    assert ranking.rank_and_gap(scores, 2, mask, 2) == (2, 0.0)
    assert ranking.rank_and_gap(scores, 2, mask, 3)[1] == pytest.approx(0.1)  # counts 0.6
    assert ranking.rank_and_gap(scores, 2, mask, 1)[1] == pytest.approx(0.2)  # leaves out 0.9
    assert ranking.rank_and_gap(scores, 2, mask, 6)[1] == ranking.IMPOSSIBLE


@torch.no_grad()
def test_query_answers_match_the_ports_executor():
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.datasets import QueryGraph
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.query.trainer import make_query_forward_grouped, prepare_query_graph
    from ultra_tpu_torch.train.eval import precompute_relation_representations

    cfg = cells.cell(SERVE["name"], spec())["config"]
    trip = kg.random_kg_triples(150, 5, 700, seed=1, rel_dist="zipf")
    h, r, t = betae.betae_edges(trip)
    adj = betae.Adj(h, r, t, 150, 10)
    pool = betae.sample_queries(adj, tuple(betae.TYPE2STRUCT), 2, np.random.default_rng(0))
    queries = [q for qs in pool.values() for q in qs]
    assert len(queries) == 28
    w = make_weights(cfg, 5, "cpu")
    model = program.ultra_model(cfg, w, "cpu")
    graph = prepare_query_graph(QueryGraph(np.stack([h, t]), r, 150, 10, True), device="cpu")
    q = cfg["query"]
    fwd = make_query_forward_grouped(model, QueryConfig(logic=q["logic"],
                                                        threshold=q["threshold"],
                                                        dropout_ratio=0.0))
    progs = [ops.from_nested(x) for x in queries]
    kind, operand = ops.decompose(ops.pad_queries(progs, max(map(len, progs))))
    port = torch.sigmoid(fwd(graph, kind, operand,
                             precompute_relation_representations(model, graph)).double())
    ev = ref_query.Evaluator(w, cfg, relgraph.entity_graph(np.stack([h, t]), r, 150, 10, "cpu"),
                             relgraph.relation_graph(np.stack([h, t]), r, 150, 10, "cpu"))
    compared = 0
    for i, nested in enumerate(queries):
        want = ev.probs(nested)
        if ev.min_margin < 1e-4:
            continue
        compared += 1
        np.testing.assert_allclose(want, port[i].numpy(), atol=1e-5)
        top_p, top_i = torch.topk(port[i], 10)
        gap, err = ref_query.served_gaps(want, top_i.tolist(), top_p.tolist())
        assert gap <= 1e-5 and err <= 1e-5
    assert compared >= 20

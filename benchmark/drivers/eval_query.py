"""UltraQuery's zero-shot evaluation of complex queries: a closed loop of one
client calling ``ultra_tpu_torch/query/trainer.py::rank_queries`` on a
query dataset's test queries, as ``evaluate_queries`` does for
``run_query.py --epochs 0``.

Traffic (``traffic/<name>.json``): ``graph`` (``data/kg.py``; the evaluated
graph is the training split, both directions, with BetaE's relation ids),
``types``, ``queries_per_type``, ``sampled_per_type`` and ``query_seed``
(the test queries and their easy and hard answers, ``data/
betae_answers.py``), ``batch_size``, ``warmup_calls``, ``check_queries``
(queries the reference judges after the window, drawn from the seed, with
the one of most projections), ``threshold_band`` (as in
``drivers/serve_query.py``: a query whose reference evaluation put a value
that near the threshold before a projection is not compared) and
``gate_band`` (a probability that near the predicted size's gate of 0.5
may fall on either side of it, :func:`check`).

Every seed evaluates the same queries on the same graph structure, under
the seed's ids. The dataset holds them as a query dataset lays them out:
types in blocks of ``queries_per_type`` in the order of ``types``, in an
order drawn from the seed inside each block, the programs padded to the
longest. A call ranks every query in batches of ``batch_size`` (so each
batch is of one type) after one relation precompute; the call running at
``--seconds`` finishes and the window ends with it.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.data import betae, betae_answers, kg
from benchmark.data.weights import make_weights
from benchmark.harness import program
from benchmark.reference import query as ref_query
from benchmark.reference import query_ranking, relgraph


def _inputs(traffic: dict, seed: int):
    """(entities, direct relations, (train, valid, test) triples, pool
    {type: [(nested, easy, hard)]}) under the seed's ids."""
    g = traffic["graph"]
    v, r = g["entities"], g["direct_relations"]
    splits = kg.split_triples(g)
    pool = betae_answers.query_pool(traffic, splits)
    ent, rel = kg.permutations(v, r, seed)
    relmap = np.empty(2 * r, dtype=np.int64)
    relmap[0::2], relmap[1::2] = 2 * rel, 2 * rel + 1
    return v, r, kg.relabel(splits, ent, rel), betae_answers.relabel(pool, ent, relmap)


def setup(cell: dict, seed: int, device, control=None):
    from ultra_tpu_torch.query import ops
    from ultra_tpu_torch.query.datasets import QueryDataset, QueryGraph
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.query.trainer import prepare_query_graph, rank_queries

    cfg, traffic = cell["config"], cell["traffic"]
    v, r, splits, pool = _inputs(traffic, seed)
    h, rel, t = betae.betae_edges(splits[0])
    edge_index, edge_type = np.stack([h, t]), rel
    qg = QueryGraph(edge_index, edge_type, v, 2 * r, True)
    graph = prepare_query_graph(qg, device=device)
    types = list(pool)
    entries = [(i, q) for i, t in enumerate(types) for q in pool[t]]
    programs = [ops.from_nested(q[0]) for _, q in entries]
    dataset = QueryDataset(
        name="eval", graphs=(qg, qg, qg),
        queries=ops.pad_queries(programs, max(map(len, programs))),
        types=np.array([i for i, _ in entries], dtype=np.int64),
        easy_answers=[q[1] for _, q in entries], hard_answers=[q[2] for _, q in entries],
        num_samples=(0, 0, len(entries)), num_entity_for_sample=np.full(len(entries), v),
        id2type=types)
    rng = np.random.default_rng([seed, 1])
    per = traffic["queries_per_type"]
    order = np.concatenate([i * per + rng.permutation(per) for i in range(len(types))])
    weights = make_weights(cfg, seed, device)
    model = program.ultra_model(cfg, weights, device, control)
    q = cfg["query"]
    qcfg = QueryConfig(logic=q["logic"], threshold=q["threshold"], dropout_ratio=0.0)
    s = SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed, device=device, v=v, r=r,
                        splits=splits, edge_index=edge_index, edge_type=edge_type,
                        weights=weights, model=model, qcfg=qcfg, graph=graph, dataset=dataset,
                        entries=entries, order=order, rank=rank_queries, calls=0, last=None,
                        projections=sum(betae_answers.projections(q[0]) for _, q in entries))
    for _ in range(traffic["warmup_calls"]):
        _call(s)
    return s


def _call(s):
    return s.rank(s.model, s.qcfg, s.graph, s.dataset, s.order, s.traffic["batch_size"])


def window(s, seconds: float, span) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with span("bench.rank_queries"):
            s.last = _call(s)
        s.calls += 1


def work(s) -> dict:
    """What the window has answered so far: a call runs the relation model
    for every relation (the precompute) and the entity model once for each
    projection of each query."""
    n = s.calls * len(s.order)
    return {"queries": n, "attempted": n, "failed": 0, "calls": s.calls,
            "relation_queries": s.calls * 2 * s.r,
            "entity_queries": s.calls * s.projections}


def end_to_end(s, work: dict) -> dict:
    return {"queries_per_s": work["queries"] / work["seconds"]}


def graphs(s) -> dict:
    rel = s.graph.relation_graph
    return {"entity": {"nodes": s.graph.num_nodes, "edges": int(s.graph.csr.col.numel()),
                       "relations": s.graph.num_relations},
            "relation": {"nodes": rel.num_nodes, "edges": int(rel.csr.col.numel()),
                         "relations": rel.num_relations}}


def _served(s) -> dict:
    """{dataset index: (num_easy, num_hard, hard ranks, answer positions,
    num_pred)} of the last call, from ``rank_queries``' vectors in the order
    of ``s.order``."""
    hard_rank, answer_rank, num_easy, num_hard, _, num_pred = s.last
    ends = np.cumsum(num_hard)
    answer_ends = np.cumsum(num_easy + num_hard)
    return {int(i): (int(e), int(h), hard_rank[end - h:end],
                     answer_rank[a_end - e - h:a_end], float(n))
            for i, e, h, end, a_end, n in zip(s.order, num_easy, num_hard, ends, answer_ends,
                                              num_pred)}


def release(s) -> None:
    """Frees the program's state; what the check reads stays."""
    s.served = _served(s) if s.last is not None else {}
    s.model = s.graph = s.dataset = s.last = None


def check(s) -> dict:
    """The reference's judgement of a sample of the queries answered, drawn
    from the seed, with the query of most projections, on the reference's
    logits (``reference/query_ranking.py``):

    - ``rank_gap``: the widest gap of a served filtered rank of a hard
      answer (``hard_rank_gaps``);
    - ``answer_rank_gap``: the widest gap of a served unfiltered position of
      an answer (``answer_rank_gaps``), which auroc is computed from;
    - ``num_pred_error``: the largest distance of a served predicted
      answer-set size (which mape and spearmanr are computed from) from
      the reference's (``predicted_size``, with the probabilities
      within ``gate_band`` of 0.5 on either side of the gate), over the
      reference's size or 1, whichever is larger;
    - ``answer_mismatch``: the sampled queries whose served numbers of easy
      and hard answers differ from the reference traversal's on the
      training and the full graph, worked out again from the triples.

    The reference works out the graph of relations again from the edges."""
    if not s.served:  # nothing answered is no pass
        return {"rank_gap": 1e30, "answer_rank_gap": 1e30, "num_pred_error": 1e30,
                "answer_mismatch": 1}
    keys = sorted(s.served)
    rng = np.random.default_rng([s.seed, 2])
    picked = set(rng.choice(keys, size=min(s.traffic["check_queries"], len(keys)),
                            replace=False).tolist())
    picked.add(max(keys, key=lambda i: betae_answers.projections(s.entries[i][1][0])))
    device, v, r = s.device, s.v, s.r
    train, full = betae_answers.adjacencies(s.splits, v, r)
    graph = relgraph.entity_graph(s.edge_index, s.edge_type, v, 2 * r, device)
    rel_graph = relgraph.relation_graph(s.edge_index, s.edge_type, v, 2 * r, device)
    ev = ref_query.Evaluator(s.weights, s.cfg, graph, rel_graph)
    types = list(s.traffic["types"])
    gap, answer_gap, size_error, mismatch = 0.0, 0.0, 0.0, 0
    compared, skipped, worst = 0, 0, None
    band, gate_band = s.traffic["threshold_band"], s.traffic["gate_band"]
    with torch.no_grad(), program.tf32(False):
        for i in sorted(picked):
            type_id, (nested, _, _) = s.entries[i]
            easy, hard = betae_answers.answers(nested, types[type_id], train, full)
            n_easy, n_hard, ranks, positions, num_pred = s.served[i]
            counts_agree = (n_easy, n_hard) == (len(easy), len(hard))
            mismatch += not counts_agree
            scores = query_ranking.logits(ev, nested)
            if ev.min_margin < band:
                skipped += 1
                continue
            m = min(len(hard), len(ranks))
            gaps = query_ranking.hard_rank_gaps(scores, easy, hard[:m], ranks[:m])
            if counts_agree:
                answer_gap = max(answer_gap, float(query_ranking.answer_rank_gaps(
                    scores, np.concatenate([easy, hard]), positions).max(initial=0.0)))
            low, high = query_ranking.predicted_size(scores, gate_band)
            size_error = max(size_error, max(low - num_pred, num_pred - high, 0.0) / max(low, 1.0))
            compared += 1
            if len(gaps) and gaps.max() > gap:
                j = int(gaps.argmax())
                gap, worst = float(gaps[j]), (i, types[type_id], int(hard[j]), int(ranks[j]))
    if not compared:
        gap = answer_gap = size_error = 1e30  # nothing compared is no pass
    return {"rank_gap": gap, "answer_rank_gap": answer_gap, "num_pred_error": size_error,
            "answer_mismatch": mismatch, "_compared": compared, "_near_threshold": skipped,
            "_worst": worst}

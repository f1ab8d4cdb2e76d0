"""Complex queries served: a closed loop of one client sending requests of
BetaE queries to ``ultra_tpu_torch/server.py::PredictionService.query``
(the ``/v1/query`` endpoint without its HTTP transport) over
``serve.py::UltraPredictor``.

Traffic (``traffic/<name>.json``): ``graph`` (``data/kg.py``; the served
graph is the training split, both directions, with BetaE's relation ids),
``types`` and ``queries_per_type`` (the pool, drawn once from the graph's
structure at ``query_seed`` with ``data/betae.py``), ``request_size``, ``k``,
``warmup_requests``, ``check_requests`` (requests the reference answers
after the window, drawn from the seed, with the longest served) and
``threshold_band`` (the check's band around the threshold, below).

Every seed serves the same pool on the same graph structure, under the
seed's ids, in the seed's order: the stream is cut into blocks that hold
``per_block`` queries of each type, shuffled, and each block into requests.
A request is timed from the client's call until its answers are on the
host.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.data import betae, kg
from benchmark.data.weights import make_weights
from benchmark.harness import program
from benchmark.reference import query as ref_query
from benchmark.reference import relgraph


def _inputs(traffic: dict, seed: int):
    """(train triples, pool {type: [nested]}) under the seed's ids."""
    g = traffic["graph"]
    v, r = g["entities"], g["direct_relations"]
    train = kg.split_triples(g)[0]
    adj = betae.Adj(*betae.betae_edges(train), v, 2 * r)
    pool = betae.sample_queries(adj, traffic["types"], traffic["queries_per_type"],
                                np.random.default_rng(traffic["query_seed"]))
    short = [t for t, q in pool.items() if len(q) < traffic["queries_per_type"]]
    if short:
        raise ValueError(f"the sampler found too few queries of types {short}")
    ent, rel = kg.permutations(v, r, seed)
    (train,) = kg.relabel((train,), ent, rel)
    relmap = np.empty(2 * r, dtype=np.int64)
    relmap[0::2], relmap[1::2] = 2 * rel, 2 * rel + 1
    pool = {t: [betae.relabel_instance(q, ent, relmap) for q in qs] for t, qs in pool.items()}
    return v, r, train, pool


def _stream(pool: dict, per_block: int, size: int, rng):
    """Requests of ``size`` nested queries, forever: blocks of ``per_block``
    queries of each type, shuffled."""
    types = list(pool)
    while True:
        order = {t: rng.permutation(len(pool[t])) for t in types}
        for b in range(len(order[types[0]]) // per_block):
            block = [pool[t][j] for t in types for j in order[t][b * per_block:(b + 1) * per_block]]
            block = [block[j] for j in rng.permutation(len(block))]
            for lo in range(0, len(block) - size + 1, size):
                yield block[lo:lo + size]


def setup(cell: dict, seed: int, device, control=None):
    from ultra_tpu_torch.query.datasets import QueryGraph
    from ultra_tpu_torch.query.executor import QueryConfig
    from ultra_tpu_torch.query.trainer import prepare_query_graph
    from ultra_tpu_torch.serve import UltraPredictor
    from ultra_tpu_torch.server import PredictionService

    cfg, traffic = cell["config"], cell["traffic"]
    v, r, train, pool = _inputs(traffic, seed)
    h, rel, t = betae.betae_edges(train)
    edge_index, edge_type = np.stack([h, t]), rel
    graph = prepare_query_graph(QueryGraph(edge_index, edge_type, v, 2 * r, True), device=device)
    weights = make_weights(cfg, seed, device)
    model = program.ultra_model(cfg, weights, device, control)
    q = cfg["query"]
    service = PredictionService(
        UltraPredictor(model, graph, device=device),
        qcfg=QueryConfig(logic=q["logic"], threshold=q["threshold"], dropout_ratio=0.0))
    stream = _stream(pool, traffic["per_block"], traffic["request_size"],
                     np.random.default_rng([seed, 1]))
    s = SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed, device=device, v=v, r=r,
                        edge_index=edge_index, edge_type=edge_type, weights=weights,
                        service=service, stream=stream, served=[], graph=graph)
    for _ in range(traffic["warmup_requests"]):
        service.query(_payload(s, next(stream)))
    return s


def _payload(s, queries) -> dict:
    """A request as a client sends it: the queries as nested JSON lists."""
    return {"queries": [betae.to_lists(q) for q in queries], "k": s.traffic["k"]}


def _projections(nested) -> int:
    if len(nested) == 2 and isinstance(nested[-1][-1], int):
        var, ops = nested
        return sum(op != -2 for op in ops) + (0 if isinstance(var, int) else _projections(var))
    return sum(_projections(b) for b in nested if b != (-1,))


def window(s, seconds: float, span) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        queries = next(s.stream)
        payload = _payload(s, queries)
        start = time.perf_counter()
        with span("bench.query"):
            out = s.service.query(payload)
        s.served.append((queries, out["results"], time.perf_counter() - start))


def work(s) -> dict:
    """What the window has answered so far; an entity query is one
    projection of one query."""
    n = sum(len(q) for q, _, _ in s.served)
    return {"queries": n, "attempted": n, "failed": 0, "requests": len(s.served),
            "relation_queries": 0,
            "entity_queries": sum(_projections(x) for q, _, _ in s.served for x in q)}


def end_to_end(s, work: dict) -> dict:
    lat = np.array([dt for _, _, dt in s.served])
    return {"served_queries_per_s": work["queries"] / work["seconds"],
            "request_p95_ms": float(np.percentile(lat, 95) * 1e3)}


def graphs(s) -> dict:
    rel = s.graph.relation_graph
    return {"entity": {"nodes": s.graph.num_nodes, "edges": int(s.graph.csr.col.numel()),
                       "relations": s.graph.num_relations},
            "relation": {"nodes": rel.num_nodes, "edges": int(rel.csr.col.numel()),
                         "relations": rel.num_relations}}


def release(s) -> None:
    s.service = s.graph = s.stream = None


def check(s) -> dict:
    """The reference's answers to the queries of a sample of the requests
    served, drawn from the seed, with the request of most projections:
    ``order_gap`` and ``prob_err`` (``reference/query.py::served_gaps``),
    the widest over the queries. The reference works out the graph of
    relations again from the edges and evaluates each nested query as it
    was sent.

    A query whose reference evaluation put a value within
    ``threshold_band`` of the threshold before a projection is not
    compared: rounding decides on which side such a value falls, and the
    side decides the projection's input, so two sound evaluations may
    differ by far more than their rounding. The band is set far above the
    rounding of float32 and far below the differences of a lower precision
    (``PERF.md``); the queries left out are counted."""
    rng = np.random.default_rng([s.seed, 2])
    n = len(s.served)
    longest = max(range(n), key=lambda i: sum(_projections(x) for x in s.served[i][0]))
    picked = set(rng.choice(n, size=min(s.traffic["check_requests"], n), replace=False).tolist())
    picked.add(longest)
    device = s.device
    graph = relgraph.entity_graph(s.edge_index, s.edge_type, s.v, 2 * s.r, device)
    rel_graph = relgraph.relation_graph(s.edge_index, s.edge_type, s.v, 2 * s.r, device)
    ev = ref_query.Evaluator(s.weights, s.cfg, graph, rel_graph)
    order_gap = prob_err = 0.0
    band, compared, skipped = s.traffic["threshold_band"], 0, 0
    with torch.no_grad(), program.tf32(False):
        for i in sorted(picked):
            queries, results, _ = s.served[i]
            for nested, res in zip(queries, results):
                probs = ev.probs(nested)
                if ev.min_margin < band:
                    skipped += 1
                    continue
                g, e = ref_query.served_gaps(probs, res["entities"], res["probs"])
                order_gap, prob_err = max(order_gap, g), max(prob_err, e)
                compared += 1
    if not compared:
        order_gap = prob_err = 1e30  # nothing compared is no pass
    return {"order_gap": order_gap, "prob_err": prob_err, "_compared": compared,
            "_near_threshold": skipped}

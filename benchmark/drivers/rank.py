"""Zero-shot filtered ranking of test triples: a closed loop of one client
calling ``ultra_tpu_torch/train/eval.py::collect_rankings``.

Traffic (``traffic/<name>.json``): ``graph`` (the split sizes and the
generator's settings, ``data/kg.py``), ``batch_size`` (triples a batch; each
batch is one entity pass over both directions), ``chunk`` (test triples a
call), ``warmup_triples`` and ``check_triples`` (triples the reference
ranks after the window, drawn from the seed among those answered).

Set-up builds what a user's evaluation builds: the graph with its relation
graph and layouts (``data/kg.py::split_to_graph``), the filter over every
split's triples (``tasks.GraphIndex``, as ``train/runner.py::
build_filtered_index`` builds it), the model. The window calls
``collect_rankings`` on chunks of the test triples, in an order drawn from
the seed, until ``--seconds`` have passed; the call then running finishes
and the window ends with it. A triple answered counts two queries, tail
and head.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.data import kg
from benchmark.data.weights import make_weights
from benchmark.harness import program
from benchmark.reference import ranking, relgraph, ultra
from ultra_tpu_torch.train import eval as port_eval


def _inputs(traffic: dict, seed: int):
    g = traffic["graph"]
    v, r = g["entities"], g["direct_relations"]
    return v, r, kg.relabel(kg.split_triples(g), *kg.permutations(v, r, seed))


def setup(cell: dict, seed: int, device, control=None):
    from ultra_tpu_torch import tasks
    from ultra_tpu_torch.data.kg import KGSplit, split_to_graph

    cfg, traffic = cell["config"], cell["traffic"]
    v, r, (train, valid, test) = _inputs(traffic, seed)
    edge_index, edge_type = kg.with_inverses(train, r)
    split = KGSplit(edge_index, edge_type, v, 2 * r, np.ascontiguousarray(train[:, :2].T),
                    train[:, 2].copy())
    graph = split_to_graph(split, device=device)
    everything = np.concatenate([train, valid, test])
    index = tasks.GraphIndex.build(everything[:, :2].T, everything[:, 2], v, 2 * r)
    weights = make_weights(cfg, seed, device)
    model = program.ultra_model(cfg, weights, device, control)
    s = SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed, device=device, v=v, r=r,
                        train=train, test=test, everything=everything, edge_index=edge_index,
                        edge_type=edge_type, weights=weights, model=model, graph=graph,
                        index=index, answers=[],
                        order=np.random.default_rng([seed, 1]).permutation(len(test)), calls=0)
    warm = test[s.order[:traffic["warmup_triples"]]]
    port_eval.collect_rankings(model, graph, warm, index, batch_size=traffic["batch_size"])
    return s


def _next_chunk(s):
    n = s.traffic["chunk"]
    idx = s.order[(s.calls * n + np.arange(n)) % len(s.order)]
    s.calls += 1
    return idx


def window(s, seconds: float, span) -> None:
    bs, t0 = s.traffic["batch_size"], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        idx = _next_chunk(s)
        with span("bench.collect_rankings"):
            ranking_, num_negative, _, _ = port_eval.collect_rankings(
                s.model, s.graph, s.test[idx], s.index, batch_size=bs)
        s.answers.append((idx, ranking_, num_negative))


def work(s) -> dict:
    """What the window has answered so far: each call runs the relation
    model for every relation (``collect_rankings``'s precompute) and the
    entity model for each of its queries."""
    queries = sum(2 * len(idx) for idx, _, _ in s.answers)
    return {"queries": queries, "attempted": queries, "failed": 0,
            "relation_queries": len(s.answers) * 2 * s.r, "entity_queries": queries}


def end_to_end(s, work: dict) -> dict:
    return {"queries_per_s": work["queries"] / work["seconds"]}


def graphs(s) -> dict:
    """The sizes the per-layer readers need, by the rows of a launch."""
    rel = s.graph.relation_graph
    return {"entity": {"nodes": s.graph.num_nodes, "edges": int(s.graph.csr.col.numel()),
                       "relations": s.graph.num_relations},
            "relation": {"nodes": rel.num_nodes, "edges": int(rel.csr.col.numel()),
                         "relations": rel.num_relations}}


def _served(s):
    """{test index: (tail rank, head rank, tail negatives, head negatives)}
    of the first answer of each triple, from ``collect_rankings``'s layout:
    each batch's tail ranks, then its head ranks."""
    bs, out = s.traffic["batch_size"], {}
    for idx, ranks, negs in s.answers:
        for start in range(0, len(idx), bs):
            valid = min(bs, len(idx) - start)
            for i in range(valid):
                t, h = 2 * start + i, 2 * start + valid + i
                out.setdefault(int(idx[start + i]), (ranks[t], ranks[h], negs[t], negs[h]))
    return out


def release(s) -> None:
    """Frees the program's state; what the check reads stays."""
    s.served = _served(s)
    s.model = s.graph = s.index = s.answers = None


def check(s) -> dict:
    """The reference's filtered ranks of a sample of the triples answered,
    drawn from the seed: ``rank_gap`` (the widest gap of a served rank,
    ``reference/ranking.py::rank_and_gap``) and ``filter_mismatch`` (the
    served triples whose count of candidates differs from the reference's
    filter). The reference works out the graph of relations and the filter
    again from the triples."""
    device, cfg, r = s.device, s.cfg, s.r
    keys = sorted(s.served)
    rng = np.random.default_rng([s.seed, 2])
    picked = rng.choice(keys, size=min(s.traffic["check_triples"], len(keys)), replace=False)
    graph = relgraph.entity_graph(s.edge_index, s.edge_type, s.v, 2 * r, device)
    rel_graph = relgraph.relation_graph(s.edge_index, s.edge_type, s.v, 2 * r, device)
    filt = ranking.Filter(s.everything, s.v)
    rows = []  # (test index, direction, anchor, target, query relation, relation)
    for i in picked:
        h, t, rel = (int(x) for x in s.test[i])
        rows += [(i, "tail", h, t, rel, rel), (i, "head", t, h, rel + r, rel)]
    gap, mismatch, worst = 0.0, 0, None
    block = s.traffic["check_batch"]
    with torch.no_grad(), program.tf32(False):
        rels = torch.tensor(sorted({row[5] for row in rows}), device=device)
        reprs = dict(zip(rels.tolist(), ultra.relation_representations(s.weights, cfg,
                                                                        rel_graph, rels)))
        for lo in range(0, len(rows), block):
            part = rows[lo:lo + block]
            scores = ultra.score_all(
                s.weights, cfg, graph, torch.stack([reprs[row[5]] for row in part]),
                torch.tensor([row[2] for row in part], device=device),
                torch.tensor([row[4] for row in part], device=device))
            for row, sc in zip(part, scores):
                i, direction, anchor, target, _, rel = row
                t_rank, h_rank, t_neg, h_neg = s.served[i]
                served_rank, served_neg = (t_rank, t_neg) if direction == "tail" else (h_rank, h_neg)
                mask = filt.candidates(direction, anchor, rel, target)
                _, g = ranking.rank_and_gap(sc, target, mask, int(served_rank))
                mismatch += int(mask.sum()) != int(served_neg)
                if worst is None or g > gap:
                    gap, worst = g, (int(i), direction, int(served_rank))
    return {"rank_gap": gap, "filter_mismatch": mismatch,
            "_compared": len(rows), "_worst": worst}

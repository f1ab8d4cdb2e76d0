"""BetaE test queries with their easy and hard answers, as a query dataset
holds them, for the evaluation cells.

BetaE's rule (Ren and Leskovec, NeurIPS 2020): a test query is drawn on the
full graph (every split, both directions) and kept only where it has an
answer that the training graph does not give; its easy answers are its
answers on the training graph, its hard answers its answers on the full
graph that are not easy. The draws are ``data/betae.py::sample_queries`` on
the full graph (an instance with any answer there), of which the first
``queries_per_type`` with a hard answer are kept, in the order drawn.
"""

from __future__ import annotations

import numpy as np

from benchmark.data import betae


def answers(instance, qtype: str, train: betae.Adj, full: betae.Adj):
    """(easy, hard) ascending node ids of one instance."""
    struct = betae.TYPE2STRUCT[qtype]
    easy = betae.evaluate(instance, struct, train)
    hard = betae.evaluate(instance, struct, full) & ~easy
    return np.flatnonzero(easy), np.flatnonzero(hard)


def projections(nested) -> int:
    """The relation projections of a nested instance: the entity queries
    UltraQuery runs for it."""
    if len(nested) == 2 and isinstance(nested[-1][-1], int):
        var, unary = nested
        return sum(op != -2 for op in unary) + (0 if isinstance(var, int) else projections(var))
    return sum(projections(b) for b in nested if b != (-1,))


def adjacencies(splits, num_nodes: int, num_direct: int):
    """(training graph, full graph) :class:`betae.Adj` of (train, valid,
    test) (T, 3) (h, t, r) triples, both directions with BetaE's ids."""
    everything = np.concatenate(splits)
    return tuple(betae.Adj(*betae.betae_edges(t), num_nodes, 2 * num_direct)
                 for t in (splits[0], everything))


def query_pool(traffic: dict, splits):
    """{type: [(instance, easy, hard)]} on the (train, valid, test) triples
    ``splits`` of a traffic file's ``graph``, with the graph's own ids:
    ``queries_per_type`` of each of ``types``, drawn at ``query_seed`` from
    ``sampled_per_type`` draws a type. Raises where a type has too few
    queries with a hard answer."""
    g = traffic["graph"]
    train, full = adjacencies(splits, g["entities"], g["direct_relations"])
    rng = np.random.default_rng(traffic["query_seed"])
    want = traffic["queries_per_type"]
    out, short = {}, []
    for qtype in traffic["types"]:
        drawn = betae.sample_queries(full, (qtype,), traffic["sampled_per_type"], rng)[qtype]
        kept = []
        for inst in drawn:
            easy, hard = answers(inst, qtype, train, full)
            if len(hard):
                kept.append((inst, easy, hard))
                if len(kept) == want:
                    break
        out[qtype] = kept
        if len(kept) < want:
            short.append(qtype)
    if short:
        raise ValueError(f"too few queries with a hard answer of types {short}")
    return out


def relabel(pool: dict, ent: np.ndarray, relmap: np.ndarray) -> dict:
    """``pool`` under other ids: entities through ``ent``, BetaE relation ids
    through ``relmap``; answer lists ascending again."""
    return {t: [(betae.relabel_instance(inst, ent, relmap), np.sort(ent[easy]),
                 np.sort(ent[hard])) for inst, easy, hard in qs] for t, qs in pool.items()}

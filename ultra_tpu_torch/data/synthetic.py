"""Synthetic knowledge graphs for tests and the on-card smoke run.

Counterpart of ``ultra_tpu/data/synthetic.py``: the same numpy generator,
so one seed gives the same triples in both packages. Graphs carry explicit
inverse edges (type r + num_direct_rel) and an attached relation graph.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ultra_tpu_torch import tasks
from ultra_tpu_torch.graph import Graph, make_graph


def random_kg_triples(
    num_nodes: int, num_direct_rel: int, num_triples: int, seed: int = 0,
    rel_dist: str = "uniform", categories: int = 0,
) -> np.ndarray:
    """(T, 3) unique (h, t, r) triples with power-law head/tail popularity.

    ``rel_dist='zipf'`` draws relations from a Zipf(1.0) table instead of
    uniformly, as real KGs have skewed relation histograms. ``categories=K``
    puts entities in K categories (Zipf sizes) and types each relation to
    one (head category, tail category) pair: the schema locality of real KGs.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1)
    p = 1.0 / ranks**0.8
    p /= p.sum()
    n_draw = num_triples * 2
    if rel_dist == "zipf":
        rp = 1.0 / np.arange(1, num_direct_rel + 1) ** 1.0
        rp /= rp.sum()
        r = rng.choice(num_direct_rel, size=n_draw, p=rp)
    else:
        r = rng.integers(0, num_direct_rel, size=n_draw)
    if categories:
        cp = 1.0 / np.arange(1, categories + 1) ** 0.6
        cp /= cp.sum()
        ent_cat = rng.choice(categories, size=num_nodes, p=cp)
        rel_hc = rng.integers(0, categories, size=num_direct_rel)
        rel_tc = rng.integers(0, categories, size=num_direct_rel)
        pools = [np.nonzero(ent_cat == c)[0] for c in range(categories)]
        pools = [po if len(po) else np.arange(num_nodes) for po in pools]
        pool_p = [p[po] / p[po].sum() for po in pools]
        h = np.empty(n_draw, np.int64)
        t = np.empty(n_draw, np.int64)
        for c in range(categories):
            mh = rel_hc[r] == c
            if mh.any():
                h[mh] = rng.choice(pools[c], size=int(mh.sum()), p=pool_p[c])
            mt = rel_tc[r] == c
            if mt.any():
                t[mt] = rng.choice(pools[c], size=int(mt.sum()), p=pool_p[c])
    else:
        h = rng.choice(num_nodes, size=n_draw, p=p)
        t = rng.choice(num_nodes, size=n_draw, p=p)
    keep = h != t
    trip = np.stack([h[keep], t[keep], r[keep]], axis=1)
    key = (trip[:, 0] * num_nodes + trip[:, 1]) * num_direct_rel + trip[:, 2]
    _, first = np.unique(key, return_index=True)
    trip = trip[np.sort(first)][:num_triples]
    return trip.astype(np.int64)


def with_inverses(triples: np.ndarray, num_direct_rel: int):
    """edge_index (2, 2T), edge_type (2T): originals then inverses
    (t, h, r + num_direct_rel)."""
    h, t, r = triples[:, 0], triples[:, 1], triples[:, 2]
    edge_index = np.concatenate([np.stack([h, t]), np.stack([t, h])], axis=1)
    edge_type = np.concatenate([r, r + num_direct_rel])
    return edge_index, edge_type


def synthetic_graph(
    num_nodes: int = 40,
    num_direct_rel: int = 6,
    num_triples: int = 150,
    seed: int = 0,
    device="cuda",
) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """(Graph with its relation graph, edge_index, edge_type host arrays)."""
    trip = random_kg_triples(num_nodes, num_direct_rel, num_triples, seed)
    edge_index, edge_type = with_inverses(trip, num_direct_rel)
    num_relations = 2 * num_direct_rel
    rel_graph = tasks.build_relation_graph(
        edge_index, edge_type, num_nodes, num_relations, device=device
    )
    graph = make_graph(
        edge_index, edge_type, num_nodes=num_nodes, num_relations=num_relations,
        relation_graph=rel_graph, device=device,
    )
    return graph, edge_index, edge_type

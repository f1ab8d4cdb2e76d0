"""Knowledge graphs in the shapes of the cells, from a seed.

Frozen copies of the port's generator (``ultra_tpu_torch/data/synthetic.py``:
``random_kg_triples``, ``with_inverses``): the benchmark keeps its own, so
that a change to the program cannot change the yardstick. ``tests/
test_bench_copies.py`` holds each copy to the original at seed 0.

A cell's graph has one structure for every ``--seed``: the triples are drawn
once from the traffic file's ``graph_seed``, and ``--seed`` then permutes
the entity ids and the direct relation ids (:func:`permutations`,
:func:`relabel`). Every seed
gets the same work (an isomorphic graph, the same degrees, the same split
sizes) under other ids, so runs with different seeds spread no more than
runs of one seed.
"""

from __future__ import annotations

import numpy as np


def random_kg_triples(
    num_nodes: int, num_direct_rel: int, num_triples: int, seed: int = 0,
    rel_dist: str = "uniform", categories: int = 0,
) -> np.ndarray:
    """(T, 3) unique (h, t, r) triples with power-law head/tail popularity;
    ``rel_dist="zipf"`` draws relations from a Zipf(1.0) table, and
    ``categories=K`` types each relation to one pair of K entity categories
    (Zipf sizes)."""
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


def split_triples(graph: dict):
    """The (train, valid, test) (T, 3) triples of a traffic file's ``graph``
    section: ``sum(splits)`` triples from :func:`random_kg_triples` at
    ``graph_seed``, shuffled by the same seed and cut into the splits'
    sizes. Raises where the generator gives fewer unique triples."""
    sizes = [int(n) for n in graph["splits"]]
    total = sum(sizes)
    trip = random_kg_triples(graph["entities"], graph["direct_relations"], total,
                             seed=graph["graph_seed"], rel_dist=graph["rel_dist"],
                             categories=graph["categories"])
    if len(trip) != total:
        raise ValueError(f"the generator gave {len(trip)} unique triples, not {total}")
    trip = trip[np.random.default_rng(graph["graph_seed"]).permutation(total)]
    return tuple(np.split(trip, np.cumsum(sizes)[:-1]))


def permutations(num_nodes: int, num_direct_rel: int, seed: int):
    """(entity permutation, direct relation permutation) drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.permutation(num_nodes), rng.permutation(num_direct_rel)


def relabel(splits, ent: np.ndarray, rel: np.ndarray):
    """``splits`` ((T, 3) (h, t, r) arrays) with entity ids through ``ent``
    and direct relation ids through ``rel``."""
    return tuple(np.stack([ent[s[:, 0]], ent[s[:, 1]], rel[s[:, 2]]], axis=1) for s in splits)

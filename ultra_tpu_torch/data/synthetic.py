"""Synthetic knowledge graphs for tests and the on-card smoke run.

Counterpart of ``ultra_tpu/data/synthetic.py``: the same numpy generator,
so one seed gives the same triples in both packages. Graphs carry explicit
inverse edges (type r + num_direct_rel) and an attached relation graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def rule_kg_splits(
    num_nodes: int,
    num_base_rel: int,
    num_comp_rel: int,
    num_base_triples: int,
    seed: int = 0,
    categories: int = 8,
    valid_frac: float = 0.15,
    test_frac: float = 0.15,
    rule_keep: float = 0.75,
    min_support: int = 30,
):
    """A synthetic KG with planted compositional rules, the JAX package's
    offline transfer benchmark; one seed gives its triples exactly.

    Base relations get Zipf/schema random triples (:func:`random_kg_triples`).
    Each of ``num_comp_rel`` extra relations c is defined by a rule
    c = r_a then r_b: its triples are the 2-hop join {(h, t) : h -a-> x -b-> t}
    over the base graph, thinned to ``rule_keep``. Valid and test targets are
    drawn only from derived triples, whose supporting paths stay in the train
    graph.

    Returns (train, valid, test) as (T, 3) int64 (h, t, r) arrays and a meta
    dict {"rules": {c: (a, b)}, "num_direct_rel": ...}.
    """
    rng = np.random.default_rng(seed)
    base = random_kg_triples(
        num_nodes, num_base_rel, num_base_triples, seed=seed,
        rel_dist="zipf", categories=categories,
    )
    by_rel = {r: base[base[:, 2] == r][:, :2] for r in range(num_base_rel)}

    def join(a: int, b: int) -> np.ndarray:
        """All (h, t) with h -a-> x -b-> t, h != t, deduplicated."""
        first_hop, second_hop = by_rel[a], by_rel[b]
        if not len(first_hop) or not len(second_hop):
            return np.empty((0, 2), np.int64)
        second = second_hop[np.argsort(second_hop[:, 0], kind="stable")]
        lo = np.searchsorted(second[:, 0], first_hop[:, 1], side="left")
        hi = np.searchsorted(second[:, 0], first_hop[:, 1], side="right")
        cnt = hi - lo
        if cnt.sum() == 0:
            return np.empty((0, 2), np.int64)
        rep = np.repeat(np.arange(len(first_hop)), cnt)
        offs = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi) if h > l])
        pairs = np.stack([first_hop[rep, 0], second[offs, 1]], axis=1)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        if not len(pairs):
            return pairs
        key = pairs[:, 0] * num_nodes + pairs[:, 1]
        _, first = np.unique(key, return_index=True)
        return pairs[np.sort(first)]

    rules = {}
    derived = []
    cap = max(min_support, 4 * num_base_triples // max(num_comp_rel, 1))
    for ci in range(num_comp_rel):
        c = num_base_rel + ci
        for _ in range(50):  # sample (a, b) until the join has support
            a, b = rng.integers(0, num_base_rel, size=2)
            pairs = join(int(a), int(b))
            if len(pairs) >= min_support:
                break
        else:
            raise ValueError(
                f"no composable relation pair with >= {min_support} paths; "
                "increase num_base_triples or lower min_support"
            )
        rules[c] = (int(a), int(b))
        pairs = pairs[rng.random(len(pairs)) < rule_keep]
        if len(pairs) > cap:
            pairs = pairs[rng.choice(len(pairs), size=cap, replace=False)]
        derived.append(np.concatenate([pairs, np.full((len(pairs), 1), c)], axis=1))

    train_parts, valid_parts, test_parts = [base], [], []
    for d in derived:
        perm = rng.permutation(len(d))
        n_te = max(int(len(d) * test_frac), 1)
        n_va = max(int(len(d) * valid_frac), 1)
        test_parts.append(d[perm[:n_te]])
        valid_parts.append(d[perm[n_te:n_te + n_va]])
        train_parts.append(d[perm[n_te + n_va:]])
    train = np.concatenate(train_parts).astype(np.int64)
    valid = np.concatenate(valid_parts).astype(np.int64)
    test = np.concatenate(test_parts).astype(np.int64)
    return train, valid, test, {"rules": rules, "num_direct_rel": num_base_rel + num_comp_rel}


def rule_kg_dataset(
    name: str,
    num_nodes: int,
    num_base_rel: int,
    num_comp_rel: int,
    num_base_triples: int,
    seed: int = 0,
    **kw,
):
    """:func:`rule_kg_splits` packaged as a ``data/kg.py::KGDataset``: the
    training triples with their inverses are the message graph of all three
    splits, each split's triples its targets (``datasets.py:240-353``)."""
    from ultra_tpu_torch.data import kg

    train, valid, test, meta = rule_kg_splits(
        num_nodes, num_base_rel, num_comp_rel, num_base_triples, seed=seed, **kw)
    num_rel = meta["num_direct_rel"]
    msg_ei, msg_et = with_inverses(train, num_rel)

    def split(trip):
        return kg.KGSplit(msg_ei, msg_et, num_nodes, 2 * num_rel,
                          trip[:, :2].T.copy(), trip[:, 2].copy())

    return kg.KGDataset(name, split(train), split(valid), split(test))


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
    pad_edges_to: Optional[int] = None,
) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """(Graph with its relation graph, edge_index, edge_type host arrays);
    ``pad_edges_to`` pads the message edges with weight-0 edges."""
    trip = random_kg_triples(num_nodes, num_direct_rel, num_triples, seed)
    edge_index, edge_type = with_inverses(trip, num_direct_rel)
    num_relations = 2 * num_direct_rel
    rel_graph = tasks.build_relation_graph(
        edge_index, edge_type, num_nodes, num_relations, device=device
    )
    graph = make_graph(
        edge_index, edge_type, num_nodes=num_nodes, num_relations=num_relations,
        pad_to=pad_edges_to, relation_graph=rel_graph, device=device,
    )
    return graph, edge_index, edge_type

"""Synthetic logical-query datasets in the BetaE format.

Counterpart of ``ultra_tpu/data/synthetic_queries.py`` (numpy, a copy
rather than an import: one seed writes the same files from both
packages). :func:`write_betae_dataset` writes a whole BetaE directory
(``id2ent``/``id2rel`` pickles, ``{split}.txt`` triples, query and answer
pickles) from a synthetic KG, which ``query/datasets.py::
LogicalQueryDataset`` loads, so query training and evaluation run offline
at any scale.

The BetaE conventions hold: relations come in (direct, inverse = direct +
1) pairs; ``{split}.txt`` holds both directions as ``h r t``; queries are
the nested tuples of ``query/datasets.py::STRUCT2TYPE``; an evaluation
split's easy answers are reachable on the previous split's graph and its
hard answers only with its own edges. A recursive sampler instantiates
each structure: chains walk backward from a target node, so every
projection is satisfiable; intersection branches reach that target;
negated branches sample freely and an instance is kept only if its answer
set is not empty. Answers come from a set-based evaluator over
per-relation adjacency, not from the executor, so the loader and the
executor are held against another implementation.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ultra_tpu_torch.data.synthetic import random_kg_triples

# the BetaE nested-tuple structures (query/datasets.py STRUCT2TYPE inverse)
TYPE2STRUCT = {
    "1p": ("e", ("r",)),
    "2p": ("e", ("r", "r")),
    "3p": ("e", ("r", "r", "r")),
    "2i": (("e", ("r",)), ("e", ("r",))),
    "3i": (("e", ("r",)), ("e", ("r",)), ("e", ("r",))),
    "ip": ((("e", ("r",)), ("e", ("r",))), ("r",)),
    "pi": (("e", ("r", "r")), ("e", ("r",))),
    "2in": (("e", ("r",)), ("e", ("r", "n"))),
    "3in": (("e", ("r",)), ("e", ("r",)), ("e", ("r", "n"))),
    "inp": ((("e", ("r",)), ("e", ("r", "n"))), ("r",)),
    "pin": (("e", ("r", "r")), ("e", ("r", "n"))),
    "pni": (("e", ("r", "r", "n")), ("e", ("r",))),
    "2u-DNF": (("e", ("r",)), ("e", ("r",)), ("u",)),
    "up-DNF": ((("e", ("r",)), ("e", ("r",)), ("u",)), ("r",)),
}

DEFAULT_TYPES = tuple(TYPE2STRUCT)


class _Adj:
    """Per-relation CSR over (h, r, t) int triples (relations include
    inverses): forward neighbors and a flat edge list for backward walks."""

    def __init__(self, h, r, t, num_nodes, num_relations):
        self.v = num_nodes
        order = np.lexsort((h, r))
        self.h, self.r, self.t = h[order], r[order], t[order]
        self.r_start = np.searchsorted(self.r, np.arange(num_relations))
        self.r_end = np.searchsorted(self.r, np.arange(num_relations), "right")

    def traverse(self, mask: np.ndarray, rel: int) -> np.ndarray:
        lo, hi = self.r_start[rel], self.r_end[rel]
        sel = mask[self.h[lo:hi]]
        out = np.zeros(self.v, dtype=bool)
        out[self.t[lo:hi][sel]] = True
        return out

    def rels_from(self, node: int, rng) -> Optional[Tuple[int, int]]:
        """A uniformly random outgoing (rel, tail) of ``node``."""
        idx = np.nonzero(self.h == node)[0]
        if idx.size == 0:
            return None
        e = idx[rng.integers(idx.size)]
        return int(self.r[e]), int(self.t[e])

    def rels_into(self, node: int, rng) -> Optional[Tuple[int, int]]:
        """A uniformly random incoming (rel, head) of ``node``."""
        idx = np.nonzero(self.t == node)[0]
        if idx.size == 0:
            return None
        e = idx[rng.integers(idx.size)]
        return int(self.r[e]), int(self.h[e])


def _evaluate(instance, struct, adj: _Adj) -> np.ndarray:
    """Boolean answer vector of a BetaE instance on ``adj``."""
    if struct[0] == "e":  # anchored chain
        anchor, rels = instance
        mask = np.zeros(adj.v, dtype=bool)
        mask[anchor] = True
        for r in rels:
            if r == -2:  # 'n' marker in instance encoding
                mask = ~mask
            else:
                mask = adj.traverse(mask, r)
        # trailing negation markers are encoded as rel id -2 in instances
        return mask
    if struct[-1] == ("r",) or struct[-1] == ("n", "r"):
        inner = _evaluate(instance[0], struct[0], adj)
        mask = inner
        for tok in instance[1]:
            if tok == -2:
                mask = ~mask
            else:
                mask = adj.traverse(mask, tok)
        return mask
    if struct[-1] == ("u",):  # union of branches
        out = np.zeros(adj.v, dtype=bool)
        for inst_b, struct_b in zip(instance[:-1], struct[:-1]):
            out |= _evaluate(inst_b, struct_b, adj)
        return out
    if struct[-1] == ("n",):  # Dm-form — not generated, kept for safety
        raise NotImplementedError
    # intersection of branches; 'n'-terminated branches complement
    out = np.ones(adj.v, dtype=bool)
    for inst_b, struct_b in zip(instance, struct):
        out &= _evaluate(inst_b, struct_b, adj)
    return out


def _chain_backward(target: int, length: int, adj: _Adj, rng, negate=False):
    """Sample an ('e', rels) chain instance REACHING ``target`` (so chains
    are always satisfiable), or None if the walk dead-ends. A negated chain
    samples forward from a random anchor instead (it must merely exist, not
    hit the target)."""
    if negate:
        for _ in range(8):
            anchor = int(rng.integers(adj.v))
            rels = []
            node = anchor
            ok = True
            for _ in range(length):
                step = adj.rels_from(node, rng)
                if step is None:
                    ok = False
                    break
                rels.append(step[0])
                node = step[1]
            if ok:
                return (anchor, tuple(rels) + (-2,))
        return None
    node = target
    rels = []
    for _ in range(length):
        step = adj.rels_into(node, rng)
        if step is None:
            return None
        rels.append(step[0])
        node = step[1]
    return (node, tuple(reversed(rels)))


def _sample_instance(qtype: str, adj: _Adj, rng):
    """One instance of ``qtype`` with a non-empty answer set on ``adj``
    (None on a failed attempt; caller retries)."""
    struct = TYPE2STRUCT[qtype]

    def chain_lens(s):  # ('r', 'r', 'n') -> (length, negated)
        rels = [x for x in s if x == "r"]
        return len(rels), s[-1] == "n"

    target = int(rng.integers(adj.v))

    if struct[0] == "e":  # plain chains: 1p/2p/3p
        length, _ = chain_lens(struct[1])
        return _chain_backward(target, length, adj, rng)

    if struct[-1] == ("r",):  # ip / inp / up-DNF: inner struct then project
        step = adj.rels_into(target, rng)
        if step is None:
            return None
        last_rel, mid = step
        inner = _sample_instance_from_target(struct[0], mid, adj, rng)
        if inner is None:
            return None
        return (inner, (last_rel,))

    return _sample_instance_from_target(struct, target, adj, rng)


def _sample_instance_from_target(struct, target: int, adj: _Adj, rng):
    """Instance of an intersection/union struct whose positive branches all
    reach ``target``."""
    if struct[0] == "e":
        length = len([x for x in struct[1] if x == "r"])
        if struct[1][-1] == "n":
            return _chain_backward(target, length, adj, rng, negate=True)
        return _chain_backward(target, length, adj, rng)
    if struct[-1] == ("u",):  # union: first branch reaches target, rest free
        insts = []
        for i, sb in enumerate(struct[:-1]):
            length = len([x for x in sb[1] if x == "r"])
            if i == 0:
                inst = _chain_backward(target, length, adj, rng)
            else:
                anchor = int(rng.integers(adj.v))
                inst = _chain_backward(anchor, length, adj, rng)
            if inst is None:
                return None
            insts.append(inst)
        return tuple(insts) + ((-1,),)
    insts = []
    for sb in struct:
        length = len([x for x in sb[1] if x == "r"])
        negate = sb[1][-1] == "n"
        inst = _chain_backward(target, length, adj, rng, negate=negate)
        if inst is None:
            return None
        insts.append(inst)
    return tuple(insts)


def write_betae_dataset(
    root: str,
    name: str = "synth-betae",
    num_nodes: int = 2000,
    num_direct_rel: int = 30,
    num_triples: int = 12000,
    queries_per_type: int = 32,
    train_queries_per_type: int = 64,
    types: Sequence[str] = DEFAULT_TYPES,
    train_types: Sequence[str] = (
        "1p", "2p", "3p", "2i", "3i", "2in", "3in", "inp", "pni", "pin"
    ),
    seed: int = 0,
    rel_dist: str = "zipf",
    categories: int = 0,
) -> Tuple[int, int]:
    """Write a full BetaE directory under ``root/name``; returns
    (num_entities, num_relations_incl_inverses)."""
    rng = np.random.default_rng(seed)
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)

    trip = random_kg_triples(
        num_nodes, num_direct_rel, num_triples, seed=seed,
        rel_dist=rel_dist, categories=categories,
    )
    h, t, r = trip[:, 0], trip[:, 1], trip[:, 2]
    num_rel = 2 * num_direct_rel  # BetaE: inverse = direct + 1
    perm = rng.permutation(len(h))
    n_tr = int(len(h) * 0.96)
    n_va = int(len(h) * 0.98)
    splits = {
        "train": perm[:n_tr], "valid": perm[n_tr:n_va], "test": perm[n_va:]
    }

    with open(os.path.join(path, "id2ent.pkl"), "wb") as f:
        pickle.dump({i: f"e{i}" for i in range(num_nodes)}, f)
    with open(os.path.join(path, "id2rel.pkl"), "wb") as f:
        pickle.dump(
            {2 * i + s: (f"r{i}" if s == 0 else f"r{i}_inv")
             for i in range(num_direct_rel) for s in (0, 1)}, f)

    for split, idx in splits.items():
        with open(os.path.join(path, f"{split}.txt"), "w") as f:
            for i in idx:
                f.write(f"{h[i]} {2 * r[i]} {t[i]}\n")
                f.write(f"{t[i]} {2 * r[i] + 1} {h[i]}\n")

    def both_dirs(idx):
        hh = np.concatenate([h[idx], t[idx]])
        tt = np.concatenate([t[idx], h[idx]])
        rr = np.concatenate([2 * r[idx], 2 * r[idx] + 1])
        return hh, rr, tt

    tr_h, tr_r, tr_t = both_dirs(splits["train"])
    adj_train = _Adj(tr_h, tr_r, tr_t, num_nodes, num_rel)
    va_h, va_r, va_t = both_dirs(np.concatenate([splits["train"], splits["valid"]]))
    adj_valid = _Adj(va_h, va_r, va_t, num_nodes, num_rel)
    all_h, all_r, all_t = both_dirs(perm)
    adj_full = _Adj(all_h, all_r, all_t, num_nodes, num_rel)

    def gen_split(qtypes, n_per_type, adj_easy, adj_hard, need_hard):
        struct2q: Dict = {}
        easy_ans, hard_ans = {}, {}
        for qt in qtypes:
            struct = TYPE2STRUCT[qt]
            got = set()
            tries = 0
            while len(got) < n_per_type and tries < n_per_type * 60:
                tries += 1
                inst = _sample_instance(qt, adj_hard, rng)
                if inst is None or inst in got:
                    continue
                full = _evaluate(inst, struct, adj_hard)
                easy = _evaluate(inst, struct, adj_easy)
                hard = full & ~easy
                if not full.any():
                    continue
                if need_hard and not hard.any():
                    continue
                got.add(inst)
                easy_ans[inst] = set(np.nonzero(easy)[0].tolist())
                hard_ans[inst] = set(np.nonzero(hard)[0].tolist())
            struct2q[struct] = got
        return struct2q, easy_ans, hard_ans

    tq, te, _ = gen_split(
        [t_ for t_ in train_types if t_ in types], train_queries_per_type,
        adj_train, adj_train, need_hard=False,
    )
    with open(os.path.join(path, "train-queries.pkl"), "wb") as f:
        pickle.dump(tq, f)
    with open(os.path.join(path, "train-answers.pkl"), "wb") as f:
        pickle.dump(te, f)

    for split, adj_e, adj_h in (
        ("valid", adj_train, adj_valid), ("test", adj_valid, adj_full)
    ):
        sq, se, sh = gen_split(
            types, queries_per_type, adj_e, adj_h, need_hard=True
        )
        with open(os.path.join(path, f"{split}-queries.pkl"), "wb") as f:
            pickle.dump(sq, f)
        with open(os.path.join(path, f"{split}-easy-answers.pkl"), "wb") as f:
            pickle.dump(se, f)
        with open(os.path.join(path, f"{split}-hard-answers.pkl"), "wb") as f:
            pickle.dump(sh, f)
    return num_nodes, num_rel

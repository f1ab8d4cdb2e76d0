"""Filtered ranking, worked out again from the triples, and how far a rank
the program gave lies from the reference's scores.

A filtered rank (Bordes et al., 2013) of a test triple (h, r, t) in the tail
direction is 1 + the number of candidate tails c that score at least as high
as t, where the candidates leave out t and every c with (h, r, c) among the
triples of any split; the head direction the same over heads c with (c, r,
t). Ties count against the triple.
"""

from __future__ import annotations

import numpy as np
import torch


IMPOSSIBLE = 1e30  # the gap of a rank that no scores can give


class Filter:
    """The known answers of (entity, relation) pairs in both directions, from
    (N, 3) (h, t, r) triples of every split."""

    def __init__(self, triples: np.ndarray, num_nodes: int):
        self.num_nodes = num_nodes
        self.tails = self._index(triples[:, 0], triples[:, 2], triples[:, 1])
        self.heads = self._index(triples[:, 1], triples[:, 2], triples[:, 0])

    @staticmethod
    def _index(anchor, rel, answer):
        key = anchor * (rel.max() + 1) + rel
        order = np.lexsort((answer, key))
        return key[order], answer[order], int(rel.max() + 1)

    def answers(self, direction: str, anchor: int, rel: int) -> np.ndarray:
        keys, answers, num_rel = self.tails if direction == "tail" else self.heads
        key = anchor * num_rel + rel
        lo, hi = np.searchsorted(keys, [key, key + 1])
        return answers[lo:hi]

    def candidates(self, direction: str, anchor: int, rel: int, target: int) -> np.ndarray:
        """(V,) bool: the nodes that count against ``target``."""
        mask = np.ones(self.num_nodes, dtype=bool)
        mask[self.answers(direction, anchor, rel)] = False
        mask[target] = False
        return mask


def rank_and_gap(scores: torch.Tensor, target: int, mask: np.ndarray, served_rank: int):
    """(the reference's filtered rank, the gap of ``served_rank``): how far
    the target's reference score lies from the candidate that the served rank
    counts differently. 0 where the ranks agree; where the served rank
    counts more candidates above the target than the reference does, the
    target's score less the highest candidate it wrongly counts; where it
    counts fewer, the lowest candidate it leaves out less the target's
    score; :data:`IMPOSSIBLE` for a rank that no scores can give (above the
    number of candidates plus one, or below 1)."""
    s = scores.double().cpu().numpy()
    cand = np.sort(s[mask])[::-1]
    st = s[target]
    ref_rank = 1 + int((cand >= st).sum())
    if served_rank == ref_rank:
        return ref_rank, 0.0
    if served_rank < 1 or served_rank > len(cand) + 1:
        return ref_rank, IMPOSSIBLE
    if served_rank > ref_rank:
        return ref_rank, float(st - cand[served_rank - 2])
    return ref_rank, float(cand[served_rank - 1] - st)

"""UltraQuery's answer to a BetaE query, in plain PyTorch, float32.

Written from the published method (Galkin et al., "Zero-shot Logical Query
Reasoning on any Knowledge Graph", NeurIPS 2024) on the plain ULTRA of
``reference/ultra.py``: the nested query is evaluated directly as a tree of
fuzzy sets over the entities, with no program, stack or batching. An anchor
is a one-hot set; a projection keeps the set's values above the threshold
(the others 0), puts set x query vector as the boundary of the entity model
(UltraQuery's QueryNBFNet, the relation model's output for the projected
relation as its relation input) and takes the sigmoid of the scores;
product logic: intersection x * y, union x + y - x * y, negation 1 - x.

A nested query is BetaE's: ``(anchor or sub-query, (r1, r2, ..., -2 for a
negation))`` is a chain; otherwise a tuple of branches is an intersection,
or a union when its last item is ``(-1,)``; n branches fold from the left.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ultra

LOGITS_EPS = 1e-10  # the answer's logit, as UltraQuery scores it


class Evaluator:
    """Answers nested queries over one graph with one set of weights.
    ``rel_reprs[r]`` (R, D) is the relation model's output for query
    relation r, computed on first use. ``min_margin`` is the smallest
    distance of a thresholded value from the threshold in the last query."""

    def __init__(self, w: dict, cfg: dict, graph: dict, rel_graph: dict):
        self.w, self.cfg, self.graph, self.rel_graph = w, cfg, graph, rel_graph
        q = cfg["query"]
        if q["logic"] != "product":
            raise ValueError(f"the reference holds product logic, not {q['logic']!r}")
        self.threshold = q["threshold"]
        self.device = graph["dst"].device
        self._reprs = {}
        self.min_margin = float("inf")

    def rel_repr(self, r: int):
        if r not in self._reprs:
            rels = torch.tensor([r], device=self.device)
            self._reprs[r] = ultra.relation_representations(
                self.w, self.cfg, self.rel_graph, rels)[0]
        return self._reprs[r]

    def project(self, x, r: int):
        """(V,) fuzzy set -> (V,) fuzzy set of its r-neighbours."""
        if self.threshold > 0:
            self.min_margin = min(self.min_margin,
                                  float((x - self.threshold).abs().min()))
            x = torch.where(x > self.threshold, x, torch.zeros_like(x))
        rep = self.rel_repr(r)  # (R, D)
        query = rep[r][None]  # (1, D)
        boundary = x[:, None, None] * query[None]
        logits = ultra.entity_scores(self.w, self.cfg, self.graph, rep[None], boundary, query)
        return torch.sigmoid(logits[0])

    def evaluate(self, nested):
        if len(nested) == 2 and isinstance(nested[-1][-1], int):  # a chain
            var, ops = nested
            if isinstance(var, int):
                x = torch.zeros(self.graph["num_nodes"], device=self.device)
                x[var] = 1.0
            else:
                x = self.evaluate(var)
            for op in ops:
                x = 1.0 - x if op == -2 else self.project(x, op)
            return x
        union = len(nested[-1]) == 1  # the (-1,) marker
        branches = [self.evaluate(b) for b in (nested[:-1] if union else nested)]
        x = branches[0]
        for y in branches[1:]:
            x = x + y - x * y if union else x * y
        return x

    def probs(self, nested) -> np.ndarray:
        """(V,) float64: the probability of each entity being an answer, as
        UltraQuery serves it (the sigmoid of the answer set's logit)."""
        self.min_margin = float("inf")
        t = self.evaluate(nested)
        logit = torch.log((t + LOGITS_EPS) / (1 - t + LOGITS_EPS))
        return torch.sigmoid(logit.double()).cpu().numpy()


def served_gaps(ref_probs: np.ndarray, entities, probs):
    """(order gap, probability error) of one served top-k: the largest amount
    by which the reference's j-th best probability exceeds the reference's
    probability of the j-th served entity, and the largest difference
    between a served probability and the reference's for the same entity."""
    ent = np.asarray(entities, dtype=np.int64)
    best = np.sort(ref_probs)[::-1][:len(ent)]
    ref_of_served = ref_probs[ent]
    return (float(np.max(best - ref_of_served)),
            float(np.max(np.abs(np.asarray(probs, dtype=np.float64) - ref_of_served))))

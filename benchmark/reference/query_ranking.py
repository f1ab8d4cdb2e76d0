"""UltraQuery's ranks of a query's answers and its predicted answer-set
size, judged on the plain reference's scores.

A hard answer's filtered rank (BetaE; ``query_utils.py:284-325`` of
UltraQuery) is 1 + the number of non-answers (nodes in neither the easy nor
the hard set) that score at least as high as it. :func:`hard_rank_gaps` is
``reference/ranking.py::rank_and_gap`` for every hard answer of one query
at once, with the non-answers as the candidates of each: one sort a query
rather than one an answer. :func:`answer_rank_gaps` is the same for the
unfiltered positions of all answers, with every other node a candidate;
:func:`predicted_size` bounds the predicted answer-set size that mape and
spearmanr are computed from.
"""

from __future__ import annotations

import numpy as np
import torch

from .query import LOGITS_EPS
from .ranking import IMPOSSIBLE


def logits(evaluator, nested) -> torch.Tensor:
    """(V,) the logit of each entity being an answer of ``nested``, as
    UltraQuery scores the answer set it ranks; ``evaluator.min_margin`` is
    the query's own afterwards."""
    evaluator.min_margin = float("inf")
    t = evaluator.evaluate(nested)
    return torch.log((t + LOGITS_EPS) / (1 - t + LOGITS_EPS))


def hard_rank_gaps(scores: torch.Tensor, easy, hard, served_ranks) -> np.ndarray:
    """The gap of each served filtered rank of the hard answers ``hard``
    (``served_ranks[j]`` that of ``hard[j]``), as ``rank_and_gap`` gives it:
    0 where the rank agrees with the reference's scores (ties counted
    against the answer), else how far the answer's score lies from the
    non-answer that the served rank counts differently; :data:`IMPOSSIBLE`
    for a rank that no scores can give."""
    s = scores.double().cpu().numpy()
    answer = np.zeros(len(s), dtype=bool)
    answer[np.asarray(easy, dtype=np.int64)] = True
    answer[np.asarray(hard, dtype=np.int64)] = True
    cand = np.sort(s[~answer])[::-1]  # descending
    st = s[np.asarray(hard, dtype=np.int64)]
    served = np.asarray(served_ranks, dtype=np.int64)
    ref_rank = 1 + np.searchsorted(-cand, -st, side="right")  # candidates >= the answer
    gap = np.zeros(len(st))
    out = (served < 1) | (served > len(cand) + 1)
    above = (served > ref_rank) & ~out
    below = (served < ref_rank) & ~out
    gap[above] = st[above] - cand[served[above] - 2]
    gap[below] = cand[served[below] - 1] - st[below]
    gap[out] = IMPOSSIBLE
    return gap


def answer_rank_gaps(scores: torch.Tensor, answers, served_positions) -> np.ndarray:
    """The gap of each served unfiltered position of the answers ``answers``
    (``served_positions[j]`` that of ``answers[j]``: how many nodes the
    served ranking puts before it), as ``rank_and_gap`` gives it with every
    other node a candidate. With the scores sorted in descending order that
    is the distance between the answer's score and the score at its served
    position (0 where ties or agreement put it there);
    :data:`IMPOSSIBLE` for a position outside the nodes."""
    s = scores.double().cpu().numpy()
    desc = np.sort(s)[::-1]
    st = s[np.asarray(answers, dtype=np.int64)]
    served = np.asarray(served_positions, dtype=np.int64)
    gap = np.full(len(st), IMPOSSIBLE)
    inside = (served >= 0) & (served < len(s))
    gap[inside] = np.abs(desc[served[inside]] - st[inside])
    return gap


def predicted_size(scores: torch.Tensor, band: float):
    """(low, high): the predicted answer-set size of the reference's logits,
    the sum of the probabilities above 0.5, with those within ``band`` of
    0.5 left out (low) or counted (high): a served size between the two
    agrees, whichever side of the gate rounding put such a probability."""
    p = torch.sigmoid(scores.double()).cpu().numpy()
    return float(p[p > 0.5 + band].sum()), float(p[p > 0.5 - band].sum())

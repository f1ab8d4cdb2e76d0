"""Complex-query evaluation metrics.

Counterpart of ``ultra_tpu/query/metrics.py``, a copy rather than an import
(``query_utils.py:284-430`` of the reference). :func:`batch_evaluate` gives
the filtered rank of each hard answer among all nodes: its unfiltered rank,
minus its rank among all answers (easy and hard), plus 1. :func:`evaluate`
rolls per-query scores into per-type, EPFO and negation averages, and adds
mape, spearmanr and auroc on the predicted answer-set size.

:func:`batch_evaluate_device` is :func:`batch_evaluate` in torch ops on the
logits' device, as the reference ranks (``query_utils.py:284-325``): the
answer sets go up as flat index lists (:func:`pack_answers`), and only the
per-query vectors need come back. :func:`predicted_size` is the predicted
answer-set size on the same device.
"""


from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch


def batch_evaluate(pred: np.ndarray, easy_masks, hard_masks, restrict_nodes=None):
    """pred (B, V) scores; easy/hard masks (B, V) bool.

    Returns (hard_ranking concat, answer_ranking concat, num_easy, num_hard)
    following query_utils.py:284-325 (ties broken by argsort order).
    """
    pred = np.array(pred, dtype=np.float64, copy=True)
    b, v = pred.shape
    if restrict_nodes is not None:
        keep = np.zeros(v, dtype=bool)
        keep[np.asarray(restrict_nodes)] = True
        pred[:, ~keep] = -np.inf

    order = np.argsort(-pred, axis=-1, kind="stable")
    ranking = np.empty((b, v), dtype=np.int64)
    rows = np.arange(b)[:, None]
    ranking[rows, order] = np.arange(v)[None, :]

    hard_rankings, answer_rankings = [], []
    num_easy = np.zeros(b, dtype=np.int64)
    num_hard = np.zeros(b, dtype=np.int64)
    for i in range(b):
        easy_r = ranking[i][easy_masks[i]]
        hard_r = ranking[i][hard_masks[i]]
        num_easy[i], num_hard[i] = len(easy_r), len(hard_r)
        # unfiltered ranks of all answers, easy block then hard block
        answer_r = np.concatenate([easy_r, hard_r])
        # rank of each answer among all answers (by unfiltered rank order)
        order_among = np.argsort(answer_r, kind="stable")
        rank_among = np.empty(len(answer_r), dtype=np.int64)
        rank_among[order_among] = np.arange(len(answer_r))
        filtered = answer_r - rank_among + 1
        hard_rankings.append(filtered[num_easy[i] :])
        answer_rankings.append(answer_r)

    return (
        np.concatenate(hard_rankings) if hard_rankings else np.zeros(0, np.int64),
        np.concatenate(answer_rankings) if answer_rankings else np.zeros(0, np.int64),
        num_easy,
        num_hard,
    )


class PackedAnswers(NamedTuple):
    """One batch's answer sets as flat lists on a device: entry j is node
    ``nodes[j]`` of query ``rows[j]``; each query's entries are its easy
    answers, then its hard answers, each block by ascending node id and
    without repeats, and the queries follow one another. ``first[j]`` is
    the position of the first entry of ``rows[j]``'s block, ``hard`` the
    positions of the hard entries in order."""

    rows: torch.Tensor
    nodes: torch.Tensor
    first: torch.Tensor
    hard: torch.Tensor
    num_easy: torch.Tensor
    num_hard: torch.Tensor

    @classmethod
    def split(cls, flat: torch.Tensor, sizes) -> "PackedAnswers":
        """The fields of :func:`pack_answers`'s ``flat`` on a device."""
        return cls(*torch.split(flat, list(sizes)))


def pack_answers(easy_answers, hard_answers):
    """(flat int64 host array, its split sizes): the answer sets of a batch
    (one array of node ids a query, each read as :func:`batch_evaluate`
    reads a mask) laid out as :class:`PackedAnswers`' fields one after the
    other, to go to a device in one copy."""
    b = len(easy_answers)
    ids = [np.unique(np.asarray(a, dtype=np.int64))
           for pair in zip(easy_answers, hard_answers) for a in pair]
    sizes = np.array([len(a) for a in ids], dtype=np.int64)
    num_easy, num_hard = sizes[0::2], sizes[1::2]
    per_query = num_easy + num_hard
    rows = np.repeat(np.arange(b, dtype=np.int64), per_query)
    first = (np.cumsum(per_query) - per_query)[rows]
    hard = np.flatnonzero(np.repeat(np.arange(2 * b) % 2, sizes))
    nodes = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    n = len(rows)
    flat = np.concatenate([rows, nodes, first, hard, num_easy, num_hard]).astype(np.int64)
    return flat, (n, n, n, len(hard), b, b)


def batch_evaluate_device(pred: torch.Tensor, answers: PackedAnswers, keep=None):
    """:func:`batch_evaluate` on ``pred``'s device: (hard ranking, answer
    ranking, num_easy, num_hard) int64 tensors, equal to
    :func:`batch_evaluate`'s arrays. ``pred`` (B, V) scores; ``answers``
    the batch's :class:`PackedAnswers`; ``keep`` (V,) bool, the nodes that
    ``restrict_nodes`` keeps (the others score -inf).

    A node's unfiltered rank is its position in a stable descending sort of
    its row (ties by node index, as numpy's stable ``argsort(-pred)``); an
    answer's rank among its query's answers is its position in a stable
    sort of (query, unfiltered rank) less its query's first position. Only
    sorts, gathers and scatters: nothing waits for the device."""
    b, v = pred.shape
    pred = pred + 0.0  # -0.0 to +0.0: the sort sees the bits, numpy the values
    if keep is not None:
        pred = pred.masked_fill(~keep, -torch.inf)
    order = torch.sort(pred, dim=-1, descending=True, stable=True).indices
    positions = torch.arange(v, device=pred.device).expand(b, v)
    ranking = torch.empty_like(order).scatter_(1, order, positions)
    answer_ranking = ranking[answers.rows, answers.nodes]
    by_rank = torch.sort(answers.rows * v + answer_ranking, stable=True).indices
    rank_among = torch.empty_like(answer_ranking)
    rank_among[by_rank] = torch.arange(len(by_rank), device=pred.device) - answers.first[by_rank]
    filtered = answer_ranking - rank_among + 1
    return filtered[answers.hard], answer_ranking, answers.num_easy, answers.num_hard


def predicted_size(pred: torch.Tensor) -> torch.Tensor:
    """(B,) float64: the predicted answer-set size of each row of logits,
    the sum of the probabilities above 0.5, on ``pred``'s device."""
    prob = torch.sigmoid(pred.double())
    return (prob * (prob > 0.5)).sum(dim=-1)


def _variadic_mean(values: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    out = np.zeros(len(sizes), dtype=np.float64)
    pos = 0
    for i, s in enumerate(sizes):
        out[i] = values[pos : pos + s].mean() if s else np.nan
        pos += s
    return out


def _scatter_mean(values: np.ndarray, index: np.ndarray, size: int) -> np.ndarray:
    sums = np.bincount(index, weights=values, minlength=size)
    counts = np.bincount(index, minlength=size)
    return np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)


def spearmanr(pred: np.ndarray, target: np.ndarray) -> float:
    """Spearman correlation with mean ranks for ties (query_utils.py:404-430)."""

    def get_ranking(x):
        uniq, inverse = np.unique(x, return_inverse=True)
        order = np.argsort(inverse, kind="stable")
        ranking = np.zeros(len(x))
        ranking[order] = np.arange(1, len(x) + 1)
        mean_rank = _scatter_mean(ranking, inverse, len(uniq))
        return mean_rank[inverse]

    p, t = get_ranking(pred), get_ranking(target)
    cov = (p * t).mean() - p.mean() * t.mean()
    return float(cov / (p.std() * t.std() + 1e-10))


def auroc(answer_ranking: np.ndarray, is_hard: np.ndarray) -> float:
    """AUROC of hard (positives) vs easy answers by unfiltered rank
    (query_utils.py:379-402 semantics, per query)."""
    pos = answer_ranking[is_hard]
    neg = answer_ranking[~is_hard]
    if len(pos) == 0 or len(neg) == 0:
        return np.nan
    # reference sorts by rank DESCENDING (variadic_sort(descending=True) on
    # rank values) and, for each easy answer (target 0), counts hard answers
    # seen so far — i.e. pairs where the hard answer has a *worse* rank.
    hit = 0.0
    order = np.argsort(-answer_ranking, kind="stable")
    ones_seen = 0
    for ti in is_hard[order]:
        if ti:
            ones_seen += 1
        else:
            hit += ones_seen
    return float(hit / (len(pos) * len(neg) + 1e-10))


def evaluate(
    hard_ranking: np.ndarray,
    answer_ranking: np.ndarray,
    num_easy: np.ndarray,
    num_hard: np.ndarray,
    types: np.ndarray,
    num_pred: np.ndarray,
    metrics: Sequence[str],
    id2type: Sequence[str],
) -> Dict[str, float]:
    """Per-type metric rollups + EPFO / negation averages
    (query_utils.py:327-377)."""
    n_types = len(id2type)
    out: Dict[str, float] = {}
    types = np.asarray(types)

    for metric in metrics:
        if metric == "mrr":
            answer_score = 1.0 / hard_ranking
            query_score = _variadic_mean(answer_score, num_hard)
            type_score = _scatter_mean(np.nan_to_num(query_score), types, n_types)
        elif metric.startswith("hits@"):
            k = int(metric[5:])
            answer_score = (hard_ranking <= k).astype(np.float64)
            query_score = _variadic_mean(answer_score, num_hard)
            type_score = _scatter_mean(np.nan_to_num(query_score), types, n_types)
        elif metric == "mape":
            query_score = np.abs(num_pred - num_easy - num_hard) / np.maximum(num_easy + num_hard, 1)
            type_score = _scatter_mean(query_score, types, n_types)
        elif metric == "spearmanr":
            type_score = np.array(
                [
                    spearmanr(num_pred[types == i], (num_easy + num_hard)[types == i])
                    if (types == i).any()
                    else 0.0
                    for i in range(n_types)
                ]
            )
        elif metric == "auroc":
            scores, pos = [], 0
            qmask = []
            for i in range(len(num_easy)):
                n = num_easy[i] + num_hard[i]
                ar = answer_ranking[pos : pos + n]
                is_hard = np.zeros(n, dtype=bool)
                is_hard[num_easy[i] :] = True
                scores.append(auroc(ar, is_hard))
                qmask.append(num_easy[i] > 0 and num_hard[i] > 0)
                pos += n
            scores = np.asarray(scores, dtype=np.float64)
            qmask = np.asarray(qmask)
            type_score = _scatter_mean(scores[qmask], types[qmask], n_types)
        else:
            raise ValueError(f"unknown metric {metric!r}")

        is_neg = np.array(["n" in t for t in id2type])
        for i, t in enumerate(id2type):
            out[f"[{t}] {metric}"] = float(type_score[i])
        if (~is_neg).any():
            out[f"[EPFO] {metric}"] = float(type_score[~is_neg].mean())
        if is_neg.any():
            out[f"[negation] {metric}"] = float(type_score[is_neg].mean())
        out[metric] = float(type_score.mean())
    return out

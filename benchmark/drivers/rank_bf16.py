"""Zero-shot filtered ranking under ``compute_dtype: bfloat16``: the traffic,
set-up and window of ``drivers/rank.py``, whose check scores the sample with
the bf16 reference (``reference/ultra_bf16.py``) in place of the float32 one.

This file takes a copy of ``rank.py``'s module of its own (``cells.driver``
executes the file anew) and points that copy's reference at the bf16 one, so
``rank.py`` and its cell are left as they are. The copy's ranking module
also records the gap of every compared query, so that the check adds
``rank_gap_median``, their median, to ``rank_gap``, their largest, and
``filter_mismatch``. Under bf16 operands a sound run's ranks differ from the
reference's by the rounding of single values that the float32 sums in
another order put on either side of a bf16 step (2^-8 of the value); such a
value moves the scores of the few queries near it, so ``rank_gap`` of a sound
run reaches the gaps that a lower precision gives everywhere, while
``rank_gap_median`` stays at the sums' noise (``PERF.md`` §4).

Control ``bf16`` (``harness/program.py``): in this cell the program already
computes its rspmm operands in bf16, so the control goes one step lower: the
model's weights held in bf16, every parameter rounded to bf16 (round to
nearest even) before the window, which the comparison has to fail. TF32,
the float32 cell's control, passes ``rank_gap`` here and fails
``rank_gap_median`` (``PERF.md`` §4).
"""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import torch

from benchmark.harness import cells
from benchmark.reference import ranking, ultra_bf16

_gaps = []  # the gap of each query compared by the check running


def _rank_and_gap(*args):
    ref_rank, gap = ranking.rank_and_gap(*args)
    _gaps.append(gap)
    return ref_rank, gap


_rank = cells.driver("rank")
_rank.ultra = ultra_bf16  # this copy's check scores with the bf16 reference
_rank.ranking = SimpleNamespace(Filter=ranking.Filter, rank_and_gap=_rank_and_gap)

window, work, end_to_end, graphs, release = (
    _rank.window, _rank.work, _rank.end_to_end, _rank.graphs, _rank.release)


def setup(cell: dict, seed: int, device, control=None):
    s = _rank.setup(cell, seed, device, None if control == "bf16" else control)
    if control == "bf16":
        with torch.no_grad():
            for p in s.model.parameters():
                p.copy_(p.to(torch.bfloat16).float())
    return s


def check(s) -> dict:
    """``rank.py``'s check against the bf16 reference, and the median of
    the compared queries' gaps, ``rank_gap_median``."""
    _gaps.clear()
    found = _rank.check(s)
    found["rank_gap_median"] = statistics.median(_gaps)
    return found

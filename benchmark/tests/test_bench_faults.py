"""A run of each cell on the CPU, past the harness's look for a card, at a
tiny size: sound, it comes out correct; with the timed path broken
underneath in each way the cell can break, it comes out not correct. The
limits are the cell's own (``limits/<cell>.json``)."""

import pytest
import torch

from benchmark.harness import runner
from benchmark.tests.conftest import tiny_cell

RANK, SERVE = "ultra_3g.rank.yago310", "ultraquery.serve.fb237_betae"


def _run(name):
    return runner.run_cell(name, 2**31 + 12345, 0.2, trace=False, device="cpu",
                           cell=tiny_cell(name))


@pytest.mark.parametrize("name", [RANK, SERVE])
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _altered_ranking(original):
    """An answer altered where it is produced: each batch's first rank."""
    def compute_ranking(pred, target, mask=None):
        ranks = original(pred, target, mask)
        ranks[0] += 7
        return ranks
    return compute_ranking


def _half_batch_scores(original):
    """Half of the batch left out: its scores are those of the other half."""
    def score_all(model, graph, rel, h, r):
        half = h.shape[0] // 2
        out = original(model, graph, rel[:half], h[:half], r[:half])
        return torch.cat([out, out])
    return score_all


def _unfiltered(original):
    """The filter left out: only the triple's own answer leaves the
    candidates (an answer's count altered where it is produced)."""
    def strict_negative_mask(index, batch):
        t_mask, h_mask = original(index, batch)
        rows = range(len(batch))
        t_mask[:], h_mask[:] = True, True
        t_mask[rows, batch[:, 1]] = h_mask[rows, batch[:, 0]] = False
        return t_mask, h_mask
    return strict_negative_mask


def _altered_answers(original):
    """An answer altered where it is produced: one entity of each request's
    first query lifted to the top."""
    def make(model, qcfg):
        fwd = original(model, qcfg)

        def altered(*args, **kw):
            out = fwd(*args, **kw)
            out[0, (out[0].argmin())] = out[0].max() + 5.0
            return out
        return altered
    return make


def _half_batch_answers(original):
    """Half of the batch left out: its answers are those of the other half."""
    def make(model, qcfg):
        fwd = original(model, qcfg)

        def halved(graph, kind, operand, rel_reprs=None):
            half = -(-len(kind) // 2)
            out = fwd(graph, kind[:half], operand[:half], rel_reprs)
            return torch.cat([out, out])[:len(kind)]
        return halved
    return make


@pytest.mark.parametrize("name,module,attr,fault", [
    (RANK, "ultra_tpu_torch.tasks", "compute_ranking", _altered_ranking),
    (RANK, "ultra_tpu_torch.train.eval", "entity_nbfnet_score_all", _half_batch_scores),
    (RANK, "ultra_tpu_torch.tasks", "strict_negative_mask", _unfiltered),
    (SERVE, "ultra_tpu_torch.query.trainer", "make_query_forward_grouped", _altered_answers),
    (SERVE, "ultra_tpu_torch.query.trainer", "make_query_forward_grouped", _half_batch_answers),
], ids=["rank-answer-altered", "rank-half-batch", "rank-unfiltered", "serve-answer-altered",
        "serve-half-batch"])
def test_a_broken_run_is_not_correct(name, module, attr, fault, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    res = _run(name)
    assert not res["correct"], res["checks"]
    if fault is _unfiltered:
        assert res["checks"]["filter_mismatch"]["value"] > 0

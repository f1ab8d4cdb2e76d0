"""The ranking loop's one-batch pipeline (``train/eval.py::collect_rankings``)
against the serial loop it replaced, kept here as :func:`serial_rankings`.

On the CPU the two must agree bit for bit, in all four arrays and their
dtypes. The test marked ``card`` runs the pipeline on a CUDA card, several
calls in a row, and holds its ranks to the CPU's within the near ties that
rounding may reorder (the rule of ``chip_smoke.py``'s ``[link-prediction]``
phase) and its counts exactly. The file imports no JAX, so that on the card
it runs alone: ``python -m pytest tests/test_torch_eval_pipeline.py -m card
--noconftest -p no:cacheprovider -o addopts=``.
"""

import numpy as np
import pytest
import torch

from ultra_tpu_torch import tasks
from ultra_tpu_torch.data.synthetic import random_kg_triples, synthetic_graph, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.train import eval as peval

V, R_DIRECT, T, D, BATCH = 40, 4, 150, 16, 4


def serial_rankings(model, graph, trips, filtered_index, batch_size, cache_relations):
    """The loop before the pipeline: each batch's masks, upload, pass,
    ranks read back and negatives counted, one after another."""
    model = model.eval()
    rel_reprs_all = (peval.precompute_relation_representations(model, graph)
                     if cache_relations else None)
    rankings, num_negatives, tail_rankings, num_tail_negs = [], [], [], []
    for start in range(0, len(trips), batch_size):
        batch = trips[start:start + batch_size]
        valid = len(batch)
        if valid < batch_size:
            batch = np.concatenate([batch, np.repeat(batch[-1:], batch_size - valid, axis=0)])
        t_mask, h_mask = tasks.strict_negative_mask(filtered_index, batch)
        args = [torch.as_tensor(a, device=graph.device) for a in (batch, t_mask, h_mask)]
        if rel_reprs_all is None:
            t_rank, h_rank = peval.score_and_rank_batch(model, graph, *args)
        else:
            t_rank, h_rank = peval.score_and_rank_batch_cached(model, graph, rel_reprs_all, *args)
        t_rank, h_rank = t_rank.cpu().numpy()[:valid], h_rank.cpu().numpy()[:valid]
        t_neg, h_neg = t_mask.sum(axis=-1)[:valid], h_mask.sum(axis=-1)[:valid]
        rankings += [t_rank, h_rank]
        num_negatives += [t_neg, h_neg]
        tail_rankings.append(t_rank)
        num_tail_negs.append(t_neg)
    return (np.concatenate(rankings), np.concatenate(num_negatives),
            np.concatenate(tail_rankings), np.concatenate(num_tail_negs))


@pytest.fixture(scope="module")
def ranking():
    graph, ei, et = synthetic_graph(V, R_DIRECT, T, seed=5, device="cpu")
    nb = lambda **kw: nbfnet.NBFNetConfig(input_dim=D, hidden_dims=(D, D), **kw)  # noqa: E731
    torch.manual_seed(0)
    model = nbfnet.Ultra(nbfnet.UltraConfig(
        relation_model=nb(num_relation=4),
        entity_model=nb(num_relation=1, project_relations=True)))
    index = tasks.GraphIndex.build(ei, et, V, 2 * R_DIRECT)
    trips = random_kg_triples(V, R_DIRECT, T, seed=5)
    return model, graph, index, trips


CASES = {
    "one_batch": lambda trips: trips[:3],
    "padded_last_batch": lambda trips: trips[:10],
    "exact_multiple": lambda trips: trips[:12],
    "duplicates_in_a_batch": lambda trips: trips[[0, 0, 1, 0, 2, 2, 2, 3, 1]],
}


@pytest.mark.parametrize("cache_relations", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_equals_the_serial_loop(ranking, case, cache_relations):
    model, graph, index, trips = ranking
    trips = CASES[case](trips)
    want = serial_rankings(model, graph, trips, index, BATCH, cache_relations)
    got = peval.collect_rankings(model, graph, trips, index, batch_size=BATCH,
                                 cache_relations=cache_relations)
    assert len(got) == 4 and len(got[0]) == 2 * len(trips)
    for w, g in zip(want, got, strict=True):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ the card

SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-4  # chip_smoke.py's rule for card against CPU ranks


def _near_ties(model, graph, trips, index, batch_size):
    """For each rank ``collect_rankings`` gives ``trips``, in its layout,
    the candidates the filter counts whose score lies within SCORE_ATOL +
    SCORE_RTOL * |positive| of the positive's: how far rounding may move
    that rank."""
    t_mask, h_mask = tasks.strict_negative_mask(index, trips)
    h, t, r = (torch.as_tensor(trips[:, i], device=graph.device) for i in range(3))
    num_direct = graph.num_relations // 2
    near = []
    with torch.no_grad():
        for kw, target, mask in ((dict(h_index=h, r_index=r), t, t_mask),
                                 (dict(h_index=t, r_index=r + num_direct, query_r_index=r),
                                  h, h_mask)):
            scores = nbfnet.ultra_score_all(model, graph, **kw)
            pos = scores.gather(1, target[:, None])
            close = (scores - pos).abs() <= SCORE_ATOL + SCORE_RTOL * pos.abs()
            near.append((close.cpu() & torch.as_tensor(mask)).sum(1).numpy())
    return np.concatenate([part[i:i + batch_size] for i in range(0, len(trips), batch_size)
                           for part in near])


@pytest.mark.card
def test_pipeline_on_the_card_equals_the_cpu_over_calls_in_a_row():
    """Four calls in a row on a 3,000-node graph at ULTRA's widths, batch 8,
    the last batch of each call padded: each call's ranks within the near
    ties of the CPU's; its counts equal the CPU's, and its ranks and counts
    the serial loop's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ultra_tpu_torch.train.loop import init_ultra_params

    nodes, rels = 3_000, 12
    trip = random_kg_triples(nodes, rels, 60_000, seed=0, rel_dist="zipf", categories=6)
    ei, et = with_inverses(trip, rels)
    rei, ret = tasks.build_relation_graph_arrays(ei, et, nodes, 2 * rels)
    graphs = {device: make_graph(ei, et, nodes, 2 * rels, device=device,
                                 relation_graph=make_graph(rei, ret, 2 * rels, 4, device=device))
              for device in ("cuda", "cpu")}
    index = tasks.GraphIndex.build(ei, et, nodes, 2 * rels)
    models = {device: init_ultra_params(nbfnet.UltraConfig(), torch.Generator().manual_seed(0),
                                        device=device).eval() for device in graphs}
    chunks = [trip[start:start + 37] for start in range(0, 4 * 37, 37)]
    card = [peval.collect_rankings(models["cuda"], graphs["cuda"], c, index, batch_size=8)
            for c in chunks]
    for chunk, got in zip(chunks, card, strict=True):
        cpu = peval.collect_rankings(models["cpu"], graphs["cpu"], chunk, index, batch_size=8)
        serial = serial_rankings(models["cuda"], graphs["cuda"], chunk, index, 8, True)
        near = _near_ties(models["cuda"], graphs["cuda"], chunk, index, 8)
        for w, g in zip(cpu, got, strict=True):
            assert w.dtype == g.dtype and w.shape == g.shape
        assert np.all(np.abs(got[0] - cpu[0]) <= near)
        np.testing.assert_array_equal(got[1], cpu[1])
        np.testing.assert_array_equal(got[3], cpu[3])
        for w, g in zip(serial, got, strict=True):
            np.testing.assert_array_equal(g, w)

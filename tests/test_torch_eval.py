"""The port's filtered evaluation (``ultra_tpu_torch.train.eval``) against
the JAX package: per-batch ranks, ``collect_rankings`` with and without the
relation precompute (on a JAX graph without plans, the XLA backend, and
with Pallas plans in interpret mode), ``evaluate`` with subsampling, and
``compute_metrics``.

Tolerances: ranks are integers and must be identical. The scores behind
them agree to f32 rounding (sums in other orders); each case first checks
that the two packages' scores differ by less than 1e-5 (delta) and that no
candidate it counts lies within 2 * delta of its positive, so rounding
cannot flip a comparison. Metrics from identical ranks are the same float64
arithmetic and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu import tasks as jtasks
from ultra_tpu.graph import make_graph as jax_make_graph
from ultra_tpu.models import nbfnet as jnbf
from ultra_tpu.ops.rspmm_pallas import attach_plans
from ultra_tpu.tasks import build_relation_graph
from ultra_tpu.train import eval as jeval
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu_torch import tasks
from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.tasks import build_relation_graph_arrays
from ultra_tpu_torch.train import eval as peval
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

V, R_DIRECT, T, D, BATCH = 40, 4, 150, 16, 4
METRICS = ("mr", "mrr", "hits@1", "hits@3", "hits@10", "hits@10_50", "mrr-tail",
           "hits@3-tail")


def _cfgs(entity_aggregate="sum"):
    def nb(mod, **kw):
        return mod.NBFNetConfig(input_dim=D, hidden_dims=(D, D), **kw)

    return (
        jnbf.UltraConfig(relation_model=nb(jnbf, num_relation=4),
                         entity_model=nb(jnbf, num_relation=1, project_relations=True,
                                         aggregate_func=entity_aggregate)),
        nbfnet.UltraConfig(relation_model=nb(nbfnet, num_relation=4),
                           entity_model=nb(nbfnet, num_relation=1, project_relations=True,
                                           aggregate_func=entity_aggregate)),
    )


@pytest.fixture(scope="module")
def setup():
    """(direct triples, port graph, {plans: JAX graph}, port index, JAX
    index, JAX params, port model)."""
    trip = random_kg_triples(V, R_DIRECT, T, seed=3)
    ei, et = with_inverses(trip, R_DIRECT)
    nrel = 2 * R_DIRECT
    rei, ret = build_relation_graph_arrays(ei, et, V, nrel)
    port = make_graph(ei, et, V, nrel, pad_to=384, device="cpu",
                      relation_graph=make_graph(rei, ret, nrel, 4, device="cpu"))
    jrel = build_relation_graph(ei, et, V, nrel)
    jgraphs = {False: jax_make_graph(ei, et, V, nrel, pad_to=384, relation_graph=jrel)}
    jgraphs[True] = attach_plans(
        jgraphs[False].replace(relation_graph=attach_plans(jrel, rb=32, chunk=64)),
        rb=32, chunk=64)
    jcfg, pcfg = _cfgs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0)))
    model = nbfnet.Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    return (trip, port, jgraphs, tasks.GraphIndex.build(ei, et, V, nrel),
            jtasks.GraphIndex.build(ei, et, V, nrel), params, model)


def _with_model(setup, entity_aggregate):
    """``setup`` with the JAX params and port model of ``entity_aggregate``."""
    if entity_aggregate == "sum":
        return setup
    jcfg, pcfg = _cfgs(entity_aggregate)
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(1)))
    model = nbfnet.Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    return setup[:5] + (params, model)


def _assert_no_near_ties(setup, trips, entity_aggregate="sum"):
    """The two packages' scores differ by at most delta, and every counted
    candidate scores more than 2 * delta from its positive (or exactly the
    same in both), so rounding cannot change a rank."""
    _, port, jgraphs, index, _, params, model = _with_model(setup, entity_aggregate)
    jcfg = _cfgs(entity_aggregate)[0]
    num_direct = port.num_relations // 2
    h, t, r = (trips[:, i] for i in range(3))
    t_mask, h_mask = tasks.strict_negative_mask(index, trips)
    for kw, target, mask in ((dict(h_index=h, r_index=r), t, t_mask),
                             (dict(h_index=t, r_index=r + num_direct, query_r_index=r),
                              h, h_mask)):
        with torch.no_grad():
            got = nbfnet.ultra_score_all(
                model, port, **{k: torch.as_tensor(v) for k, v in kw.items()}).numpy()
        want = np.asarray(jnbf.ultra_score_all(
            params, jcfg, jgraphs[False], **{k: jnp.asarray(v) for k, v in kw.items()}))
        delta = np.abs(got - want).max()
        assert delta < 1e-5
        rows = np.arange(len(trips))[:, None]
        for scores in (got, want):
            gap = np.abs(scores - scores[rows, target[:, None]])
            assert np.all((gap[mask] > 2 * delta) | (gap[mask] == 0))


@pytest.mark.parametrize("plans", [False, True])
def test_score_and_rank_batch_matches_jax(setup, plans):
    trip, port, jgraphs, index, _, params, model = setup
    batch = trip[[2, 7, 11, 40]]
    _assert_no_near_ties(setup, batch)
    t_mask, h_mask = tasks.strict_negative_mask(index, batch)
    args = [torch.as_tensor(a) for a in (batch, t_mask, h_mask)]
    got = peval.score_and_rank_batch(model, port, *args)
    want = jeval.score_and_rank_batch(params, _cfgs()[0], jgraphs[plans],
                                      *(jnp.asarray(a) for a in (batch, t_mask, h_mask)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cache_relations", [False, True])
@pytest.mark.parametrize("plans", [False, True])
def test_collect_rankings_matches_jax(setup, plans, cache_relations):
    """10 triples in batches of 4 (the last one padded): every rank and
    negative count of both directions, and of the tail direction alone."""
    trip, port, jgraphs, index, jindex, params, model = setup
    trips = trip[23:33]
    _assert_no_near_ties(setup, trips)
    got = peval.collect_rankings(model, port, trips, index, batch_size=BATCH,
                                 cache_relations=cache_relations)
    want = jeval.collect_rankings(params, _cfgs()[0], jgraphs[plans], trips, jindex,
                                  batch_size=BATCH, cache_relations=cache_relations)
    assert got[0].shape == (2 * len(trips),)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("cache_relations", [False, True])
def test_pna_collect_rankings_matches_jax(setup, cache_relations):
    """The same for a PNA entity model, on the graph with plans."""
    trip, port, jgraphs, index, jindex, params, model = _with_model(setup, "pna")
    trips = trip[23:33]
    _assert_no_near_ties(setup, trips, "pna")
    got = peval.collect_rankings(model, port, trips, index, batch_size=BATCH,
                                 cache_relations=cache_relations)
    want = jeval.collect_rankings(params, _cfgs("pna")[0], jgraphs[True], trips, jindex,
                                  batch_size=BATCH, cache_relations=cache_relations)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_evaluate_with_limit_matches_jax(setup):
    trip, port, jgraphs, index, jindex, params, model = setup
    trips = trip[23:63]
    got = peval.evaluate(model, port, trips, index, batch_size=BATCH, metrics=METRICS,
                         limit=9, rng=np.random.default_rng(4))
    picked = trips[np.random.default_rng(4).choice(len(trips), size=9, replace=False)]
    _assert_no_near_ties(setup, picked)
    want = jeval.evaluate(params, _cfgs()[0], jgraphs[False], trips, jindex,
                          batch_size=BATCH, metrics=METRICS, limit=9,
                          rng=np.random.default_rng(4))
    assert got == want


def test_compute_metrics_matches_jax():
    rng = np.random.default_rng(0)
    ranking = rng.integers(1, 60, 32)
    num_negative = rng.integers(60, 80, 32)
    args = (ranking, num_negative, ranking[::2], num_negative[::2])
    got = peval.compute_metrics(METRICS, *args)
    assert got == jeval.compute_metrics(METRICS, *args)
    with pytest.raises(ValueError, match="unknown metric"):
        peval.compute_metrics(("auroc",), *args)


def test_all_negative_matches_jax():
    batch = np.array([[3, 8, 1], [0, 5, 2]])
    got = tasks.all_negative(V, torch.as_tensor(batch))
    want = jtasks.all_negative(V, jnp.asarray(batch))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

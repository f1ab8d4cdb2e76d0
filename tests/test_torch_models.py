"""The port's convolution, NBFNets and Ultra against the JAX package, with
the same weights: ``init_ultra_params`` through ``params_from_jax``.

Each case runs on a JAX graph with Pallas plans attached (interpret mode
on the CPU) and on one without (the XLA backend), for every aggregator
(sum, mean, max, pna) and message (distmult, transe, rotate). The query
batch repeats a head, which pins the add-not-set boundary.

Tolerance: f32, rtol 1e-4 and atol 1e-5; sums run in other orders and the
error grows through the stacked layers. Gradients at ties are exact
(values built from small integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu.models import layers as jlayers
from ultra_tpu.models import nbfnet as jnbf
from ultra_tpu.ops.rspmm_pallas import attach_plans
from ultra_tpu.tasks import build_relation_graph
from ultra_tpu.graph import make_graph as jax_make_graph
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import layers, nbfnet
from ultra_tpu_torch.tasks import build_relation_graph_arrays
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
V, R_DIRECT, T, D, BATCH = 40, 4, 150, 16, 4
H = np.array([3, 3, 17, 25])  # duplicate head in one batch
R = np.array([1, 3, 0, 2])  # direct relations; r + 4 is the inverse


# (message, aggregate) of both models of an Ultra variant
VARIANTS = {"sum": ("distmult", "sum"), "max": ("distmult", "max"),
            "pna": ("distmult", "pna"), "rotate-sum": ("rotate", "sum"),
            "rotate-mean": ("rotate", "mean"), "rotate-max": ("rotate", "max"),
            "rotate-pna": ("rotate", "pna")}


def _cfgs(variant="sum"):
    message, aggregate = VARIANTS[variant]

    def nb(jmod, **kw):
        return jmod.NBFNetConfig(input_dim=D, hidden_dims=(D, D), message_func=message,
                                 aggregate_func=aggregate, **kw)

    jcfg = jnbf.UltraConfig(
        relation_model=nb(jnbf, num_relation=4),
        entity_model=nb(jnbf, num_relation=1, project_relations=True),
    )
    pcfg = nbfnet.UltraConfig(
        relation_model=nb(nbfnet, num_relation=4),
        entity_model=nb(nbfnet, num_relation=1, project_relations=True),
    )
    return jcfg, pcfg


@pytest.fixture(scope="module")
def graphs():
    """(port graph, {plans: JAX graph}) on one synthetic KG."""
    trip = random_kg_triples(V, R_DIRECT, T, seed=3)
    ei, et = with_inverses(trip, R_DIRECT)
    nrel = 2 * R_DIRECT
    rei, ret = build_relation_graph_arrays(ei, et, V, nrel)
    port = make_graph(ei, et, V, nrel, pad_to=384, device="cpu",
                      relation_graph=make_graph(rei, ret, nrel, 4, device="cpu"))
    jrel = build_relation_graph(ei, et, V, nrel)
    jax_graphs = {False: jax_make_graph(ei, et, V, nrel, pad_to=384, relation_graph=jrel)}
    jax_graphs[True] = attach_plans(
        jax_graphs[False].replace(relation_graph=attach_plans(jrel, rb=32, chunk=64)),
        rb=32, chunk=64,
    )
    return port, jax_graphs


def _models(variant="sum"):
    jcfg, pcfg = _cfgs(variant)
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0)))
    model = nbfnet.Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    return jcfg, params, model


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _conv_case(mode, aggregate, rng, message="distmult"):
    """(JAX conv config, params, port conv, query, relation_input) for one
    layer_relation mode."""
    cfg = dict(input_dim=D, output_dim=D, aggregate_func=aggregate, message_func=message)
    lin = lambda i, o: {"w": rng.normal(size=(i, o)).astype(np.float32) / np.sqrt(i),
                        "b": rng.normal(size=o).astype(np.float32)}
    params = {"linear": lin((13 if aggregate == "pna" else 2) * D, D),
              "layer_norm": {"scale": rng.uniform(0.5, 1.5, D).astype(np.float32),
                             "bias": rng.normal(size=D).astype(np.float32)}}
    nrel, relation_input = 2 * R_DIRECT, None
    if mode == "dependent":
        cfg.update(dependent=True, num_relation=nrel)
        params["relation_linear"] = lin(D, nrel * D)
    elif mode == "project_relations":
        cfg.update(project_relations=True, num_relation=nrel)
        l1, l2 = lin(D, D), lin(D, D)
        params["relation_projection"] = {"w1": l1["w"], "b1": l1["b"],
                                         "w2": l2["w"], "b2": l2["b"]}
        relation_input = rng.normal(size=(BATCH, nrel, D)).astype(np.float32)
    else:
        cfg.update(num_relation=nrel)
        params["relation"] = rng.normal(size=(nrel, D)).astype(np.float32)
    conv = layers.GeneralizedRelationalConv(layers.ConvConfig(**cfg))
    sd = params_from_jax({"relation_model": {"layers": [params]},
                          "entity_model": {"layers": []}})
    conv.load_state_dict({k[len("relation_model.layers.0."):]: v for k, v in sd.items()})
    query = rng.normal(size=(BATCH, D)).astype(np.float32)
    return jlayers.ConvConfig(**cfg), params, conv, query, relation_input


@pytest.mark.parametrize("plans", [False, True])
@pytest.mark.parametrize("message", ["distmult", "transe", "rotate"])
@pytest.mark.parametrize("aggregate", ["sum", "mean", "max", "pna"])
@pytest.mark.parametrize("mode", ["embedding", "dependent", "project_relations"])
def test_conv_matches_jax(graphs, plans, aggregate, message, mode):
    port, jax_graphs = graphs
    rng = np.random.default_rng(7)
    jcfg, params, conv, query, relation_input = _conv_case(mode, aggregate, rng, message)
    x = rng.normal(size=(V, BATCH, D)).astype(np.float32)
    boundary = rng.normal(size=(V, BATCH, D)).astype(np.float32)
    want = jlayers.conv_apply(
        jax.tree.map(jnp.asarray, params), jcfg, jax_graphs[plans], jnp.asarray(x),
        jnp.asarray(boundary), query=jnp.asarray(query),
        relation_input=None if relation_input is None else jnp.asarray(relation_input),
    )
    with torch.no_grad():
        got = conv(port, _t(x), _t(boundary), _t(query),
                   None if relation_input is None else _t(relation_input))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("plans", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_nbfnets_and_ultra_match_jax(graphs, plans, variant):
    port, jax_graphs = graphs
    jgraph = jax_graphs[plans]
    jcfg, params, model = _models(variant)
    h, r = jnp.asarray(H), jnp.asarray(R)
    nrel = 2 * R_DIRECT

    with torch.no_grad():
        rel_repr = nbfnet.rel_nbfnet_apply(model.relation_model, port.relation_graph, _t(R, torch.int64))
        want_rel = jnbf.rel_nbfnet_apply(
            params["relation_model"], jcfg.relation_model, jgraph.relation_graph, r)
        np.testing.assert_allclose(rel_repr.numpy(), np.asarray(want_rel), **TOL)

        got = nbfnet.entity_nbfnet_score_all(
            model.entity_model, port, rel_repr, _t(H, torch.int64), _t(R, torch.int64))
        want = jnbf.entity_nbfnet_score_all(
            params["entity_model"], jcfg.entity_model, jgraph, want_rel, h, r)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

        # (B, K, 3) batch: row 0 corrupts tails, row 1 corrupts heads
        batch = np.array([
            [[3, 8, 1], [3, 9, 1], [3, 30, 1]],
            [[12, 20, 2], [5, 20, 2], [39, 20, 2]],
        ])
        got = nbfnet.ultra_apply(model, port, _t(batch, torch.int64))
        want = jnbf.ultra_apply(params, jcfg, jgraph, jnp.asarray(batch))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

        for query_r in (None, R):
            r_index = R if query_r is None else R + nrel // 2
            got = nbfnet.ultra_score_all(
                model, port, _t(H, torch.int64), r_index=_t(r_index, torch.int64),
                query_r_index=None if query_r is None else _t(query_r, torch.int64))
            want = jnbf.ultra_score_all(
                params, jcfg, jgraph, h, r_index=jnp.asarray(r_index),
                query_r_index=None if query_r is None else jnp.asarray(query_r))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scatter_boundary_adds_duplicate_heads():
    query = np.arange(BATCH * D, dtype=np.float32).reshape(BATCH, D)
    got = nbfnet.scatter_boundary(_t(H, torch.int64), _t(query), V)
    want = jnbf.scatter_boundary(jnp.asarray(H), jnp.asarray(query), V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_negative_sample_to_tail_matches_jax():
    rng = np.random.default_rng(1)
    h = rng.integers(0, V, (4, 5))
    h[:2] = h[:2, :1]  # rows 0-1 corrupt tails, rows 2-3 heads
    t, r = rng.integers(0, V, (4, 5)), rng.integers(0, R_DIRECT, (4, 5))
    got = nbfnet.negative_sample_to_tail(*(_t(a, torch.int64) for a in (h, t, r)), R_DIRECT)
    want = jnbf.negative_sample_to_tail(jnp.asarray(h), jnp.asarray(t), jnp.asarray(r), R_DIRECT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unknown_aggregator_or_message_raises():
    for kw, match in ((dict(aggregate_func="median"), "aggregate_func"),
                      (dict(message_func="complex"), "message_func"),
                      (dict(message_func="rotate", input_dim=15), "even")):
        with pytest.raises(ValueError, match=match):
            layers.GeneralizedRelationalConv(layers.ConvConfig(**kw))


def test_pna_linear_takes_thirteen_widths():
    conv = layers.GeneralizedRelationalConv(layers.ConvConfig(aggregate_func="pna"))
    assert tuple(conv.linear.weight.shape) == (64, 13 * 64)


def test_pna_features_gradient_at_ties_matches_jax():
    """``pna_features``' clips split a tie's gradient in half, as
    ``jnp.clip``/``jnp.maximum`` do (``torch.clamp`` would give all of it to
    the input): max_, min_ and the boundary tie, mostly at 0; one row's
    variance is exactly 0 (under the EPS floor) and one's exactly EPS."""
    rng = np.random.default_rng(0)
    shape = (6, 2, 4)
    boundary = np.zeros(shape, np.float32)
    boundary[0] = rng.integers(-2, 3, size=shape[1:])
    max_ = np.maximum(boundary, rng.integers(-1, 2, size=shape).astype(np.float32))
    min_ = np.minimum(boundary, rng.integers(-1, 2, size=shape).astype(np.float32))
    sum_ = rng.integers(-2, 3, size=shape).astype(np.float32)
    deg = np.array([1, 2, 2, 4, 8, 8], np.float32)[:, None, None]
    sum_[2] = 0.0
    mean = (sum_ + boundary) / deg
    sq_sum = (mean ** 2) * deg - boundary ** 2  # variance 0 in row 1
    sq_sum[2] = 2 * np.float32(jlayers.EPS)  # deg 2: variance EPS in row 2
    var = (sq_sum + boundary ** 2) / deg - mean ** 2
    assert (var[1] == 0).all() and (var[2] == np.float32(jlayers.EPS)).all()
    g = rng.normal(size=(6, 2, 48)).astype(np.float32)
    args = [sum_, sq_sum, max_, min_, boundary]
    torch_args = [torch.from_numpy(a).requires_grad_() for a in args]
    out = layers.pna_features(*torch_args, torch.from_numpy(deg))
    out.backward(torch.from_numpy(g))
    want, vjp = jax.vjp(lambda *a: jlayers._pna_features(*a, jnp.asarray(deg)),
                        *map(jnp.asarray, args))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    for name, t, w in zip(("sum", "sq_sum", "max", "min", "boundary"), torch_args,
                          vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **TOL)
    # the ties are really there, and clamp would not split them
    assert (max_ == boundary).mean() > 0.3 and (min_ == boundary).mean() > 0.3


def test_pna_transe_sum_of_squares_is_rspmm_of_squares(graphs, monkeypatch):
    """A reference contract kept as it is: PNA's second moment is
    rspmm(rel^2, x^2), which for transe is sum_e w (r^2 + x^2) and not
    sum_e (w (r + x))^2."""
    port, _ = graphs
    rng = np.random.default_rng(3)
    jcfg, params, conv, query, _ = _conv_case("embedding", "pna", rng, "transe")
    seen = {}
    real = layers.pna_features
    monkeypatch.setattr(layers, "pna_features",
                        lambda *a: seen.setdefault("sq_sum", a[1]) is None or real(*a))
    x = rng.normal(size=(V, BATCH, D)).astype(np.float32)
    with torch.no_grad():
        conv(port, _t(x), _t(x), _t(query))
    ei, et, w = (a.numpy() for a in (port.edge_index, port.edge_type, port.edge_weight))
    rel = params["relation"][et][:, None, :]
    want = np.zeros((V, BATCH, D), np.float64)
    np.add.at(want, ei[0], w[:, None, None] * (rel ** 2 + x[ei[1]] ** 2))
    np.testing.assert_allclose(seen["sq_sum"].numpy(), want, **TOL)
    other = np.zeros_like(want)
    np.add.at(other, ei[0], (w[:, None, None] * (rel + x[ei[1]])) ** 2)
    assert not np.allclose(other, want, **TOL)

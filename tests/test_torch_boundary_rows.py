"""The boundary added as its rows (``models/layers.py``, ``_update``).

Where the boundary is scattered from one query vector a batch column
(``nbfnet.scatter_boundary``), the entity and relation models hand its B
nonzero rows to ``bellmanford`` (``nbfnet.boundary_rows``), and each sum or
mean conv adds them with one ``index_add_`` in place of the dense (V, B, D)
add. The result must be the dense path's bit for bit, through E2's tail and
through the composed ops; gradients must agree to f32 rounding (index_add's
backward routes the query's gradient); ``max`` and ``pna`` convs and
UltraQuery's dense fuzzy sets keep the dense add; and the profiling counter
``boundary_rows`` says how often the rows were added. Heads repeat across
the batch, as in a ranking batch. The file imports no JAX, so that on the
card it runs alone: ``python -m pytest tests/test_torch_boundary_rows.py -m
card --noconftest -p no:cacheprovider -o addopts=""``.
"""

import json

import pytest
import torch
import torch.nn.functional as F

from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import layers, nbfnet
from ultra_tpu_torch.ops import conv_tail_cuda
from ultra_tpu_torch.ops.conv_tail_cuda import conv_tail
from ultra_tpu_torch.tasks import build_relation_graph_arrays
from ultra_tpu_torch.utils import profiling

V, R_DIRECT, T = 40, 4, 150
HEADS = (3, 3, 17, 0, 3)  # a head repeated across the batch, and node 0
RELS = (0, 1, 1, 7, 2)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _graph(num_nodes=V, num_direct=R_DIRECT, num_triples=T, device="cpu", pad_to=384):
    trip = random_kg_triples(num_nodes, num_direct, num_triples, seed=3)
    ei, et = with_inverses(trip, num_direct)
    nrel = 2 * num_direct
    rei, ret = build_relation_graph_arrays(ei, et, num_nodes, nrel)
    return make_graph(ei, et, num_nodes, nrel, pad_to=pad_to, device=device,
                      relation_graph=make_graph(rei, ret, nrel, 4, device=device))


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _ultra(dims=(64,) * 6, **entity):
    cfg = nbfnet.UltraConfig(
        relation_model=nbfnet.NBFNetConfig(input_dim=64, hidden_dims=dims, num_relation=4),
        entity_model=nbfnet.NBFNetConfig(input_dim=64, hidden_dims=dims, num_relation=1,
                                         project_relations=True, **entity))
    torch.manual_seed(0)
    model = nbfnet.Ultra(cfg)
    with torch.no_grad():  # layer norms off their ones and zeros
        for conv in [*model.relation_model.layers, *model.entity_model.layers]:
            conv.layer_norm.weight.uniform_(0.5, 1.5)
            conv.layer_norm.bias.normal_()
    return model


def _conv_inputs(graph, dim=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    b = len(HEADS)
    heads = torch.tensor(HEADS)
    query = torch.randn(b, dim, generator=g)
    boundary = nbfnet.scatter_boundary(heads, query, graph.num_nodes)
    x = torch.randn(graph.num_nodes, b, dim, generator=g)
    rel_input = torch.randn(b, graph.num_relations, dim, generator=g)
    return x, boundary, query, rel_input, nbfnet.boundary_rows(heads, query, graph.num_nodes)


@pytest.fixture
def tails(monkeypatch):
    """How many times a conv ended in E2 (``conv_tail``)."""
    calls = []

    def tail(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return conv_tail(*args, **kwargs)

    monkeypatch.setattr(conv_tail_cuda, "conv_tail", tail)
    return calls


def test_rows_are_the_scattered_boundarys_nonzero_rows(graph):
    _, boundary, query, _, (index, values) = _conv_inputs(graph)
    flat = boundary.view(-1, boundary.shape[-1])
    assert index.tolist() == [h * len(HEADS) + b for b, h in enumerate(HEADS)]
    assert len(set(index.tolist())) == len(HEADS)
    assert values is query and torch.equal(flat[index], query)
    rest = torch.ones(flat.shape[0], dtype=torch.bool)
    rest[index] = False
    assert not flat[rest].any()
    # int32 where the (V*B, D) view's rows fit, else int64
    assert index.dtype == torch.int32
    wide, _ = nbfnet.boundary_rows(torch.tensor(HEADS), query, 2**31 // len(HEADS) + 1)
    assert wide.dtype == torch.int64 and wide.tolist() == index.tolist()


@pytest.mark.parametrize("path", ["E2", "composed"])
@pytest.mark.parametrize("aggregate", ["sum", "mean"])
@pytest.mark.parametrize("message", ["distmult", "transe", "rotate"])
def test_a_convs_rows_give_the_dense_adds_bits(graph, tails, path, aggregate, message):
    torch.manual_seed(0)
    conv = layers.GeneralizedRelationalConv(layers.ConvConfig(
        num_relation=graph.num_relations, message_func=message, aggregate_func=aggregate,
        project_relations=True))
    x, boundary, query, rel_input, rows = _conv_inputs(graph)
    before = boundary.clone()
    with torch.set_grad_enabled(path == "composed"):  # a gradient wanted: no E2
        want = conv(graph, x, boundary, query, rel_input, residual=x)
        got = conv(graph, x, boundary, query, rel_input, residual=x, rows=rows)
    assert torch.equal(got, want)
    assert torch.equal(boundary, before)  # the rows went onto the aggregate, not here
    assert len(tails) == (2 if path == "E2" else 0)


@pytest.mark.parametrize("aggregate", ["sum", "mean"])
def test_bf16_operands_keep_the_dense_adds_bits(graph, aggregate):
    torch.manual_seed(0)
    conv = layers.GeneralizedRelationalConv(layers.ConvConfig(
        num_relation=graph.num_relations, aggregate_func=aggregate, project_relations=True,
        compute_dtype="bfloat16"))
    x, boundary, query, rel_input, rows = _conv_inputs(graph)
    with torch.no_grad():
        want = conv(graph, x, boundary, query, rel_input)
        got = conv(graph, x, boundary, query, rel_input, rows=rows)
    assert torch.equal(got, want)


def _dense_entity_features(model, graph, rel_repr, h_index, r_index):
    """``entity_nbfnet_features`` with ``bellmanford`` given no rows."""
    query = rel_repr[torch.arange(h_index.shape[0], device=h_index.device), r_index]
    boundary = nbfnet.scatter_boundary(h_index, query, graph.num_nodes)
    hiddens = nbfnet.bellmanford(model, graph, boundary, query, relation_input=rel_repr)
    return nbfnet._features(model, hiddens, query)


def _dense_relation(model, rel_graph, query_rels):
    """``rel_nbfnet_apply`` with ``bellmanford`` given no rows."""
    query = torch.ones(query_rels.shape[0], model.cfg.input_dim, device=query_rels.device)
    boundary = nbfnet.scatter_boundary(query_rels, query, rel_graph.num_nodes)
    return nbfnet.bellmanford(model, rel_graph, boundary, query)[-1].transpose(0, 1)


@pytest.mark.parametrize("aggregate", ["sum", "mean"])
def test_score_all_and_the_relation_model_give_the_dense_paths_bits(graph, aggregate):
    model = _ultra(aggregate_func=aggregate)
    h, r = torch.tensor(HEADS), torch.tensor(RELS)
    with torch.no_grad():
        rel_repr = nbfnet.rel_nbfnet_apply(model.relation_model, graph.relation_graph, r)
        assert torch.equal(rel_repr, _dense_relation(model.relation_model,
                                                     graph.relation_graph, r))
        got = nbfnet.entity_nbfnet_score_all(model.entity_model, graph, rel_repr, h, r)
        feature = _dense_entity_features(model.entity_model, graph, rel_repr, h, r)
        want = model.entity_model.mlp(feature).squeeze(-1).T
    assert torch.equal(got, want)


def _batch(graph, k=4, seed=2):
    """(B, K, 3) (h, t, r): column 0 a positive-like triple, the rest tail
    corruptions, heads repeated as HEADS repeats them."""
    g = torch.Generator().manual_seed(seed)
    b = len(HEADS)
    h = torch.tensor(HEADS)[:, None].expand(b, k)
    t = torch.randint(0, graph.num_nodes, (b, k), generator=g)
    r = torch.tensor(RELS)[:, None].expand(b, k) % (graph.num_relations // 2)
    return torch.stack([h, t, r], dim=-1)


def _loss_grads(model, graph, batch, rows):
    """A binary cross-entropy's gradients with respect to every parameter
    and the relation model's output (which the queries are drawn from)."""
    model.zero_grad()
    rel_repr = nbfnet.rel_nbfnet_apply(model.relation_model, graph.relation_graph,
                                       batch[:, 0, 2])
    rel_repr.retain_grad()
    if rows:
        logits = nbfnet.entity_nbfnet_apply(model.entity_model, graph, rel_repr, batch)
    else:
        h, t, r = nbfnet.negative_sample_to_tail(batch[..., 0], batch[..., 1], batch[..., 2],
                                                 graph.num_relations // 2)
        feature = _dense_entity_features(model.entity_model, graph, rel_repr, h[:, 0], r[:, 0])
        logits = model.entity_model.mlp(
            feature[t, torch.arange(t.shape[0])[:, None]]).squeeze(-1)
    target = torch.zeros_like(logits)
    target[:, 0] = 1.0
    F.binary_cross_entropy_with_logits(logits, target).backward()
    return logits.detach(), {"query": rel_repr.grad.clone(), **{
        name: p.grad.clone() for name, p in model.entity_model.named_parameters()}}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("aggregate", ["sum", "mean"])
def test_gradients_match_the_dense_path(graph, aggregate, remat):
    model = _ultra(dims=(64,) * 3, aggregate_func=aggregate, remat=remat)
    batch = _batch(graph)
    got_logits, got = _loss_grads(model, graph, batch, rows=True)
    want_logits, want = _loss_grads(model, graph, batch, rows=False)
    assert torch.equal(got_logits, want_logits)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.allclose(got[name], want[name], rtol=GRAD_RTOL, atol=GRAD_ATOL), name
    assert want["query"].abs().max() > 0


@pytest.fixture
def seen_rows(monkeypatch):
    """The ``rows`` each conv's ``_update`` was handed."""
    seen = []
    update = layers.GeneralizedRelationalConv._update

    def spy(self, graph, input, boundary, relation, rows=None):
        seen.append(rows)
        return update(self, graph, input, boundary, relation, rows)

    monkeypatch.setattr(layers.GeneralizedRelationalConv, "_update", spy)
    return seen


@pytest.mark.parametrize("aggregate", ["max", "pna"])
def test_max_and_pna_convs_keep_the_dense_add(graph, tmp_path, aggregate):
    torch.manual_seed(0)
    conv = layers.GeneralizedRelationalConv(layers.ConvConfig(
        num_relation=graph.num_relations, aggregate_func=aggregate, project_relations=True))
    x, boundary, query, rel_input, rows = _conv_inputs(graph)
    with torch.no_grad(), profiling.trace(str(tmp_path)):
        want = conv(graph, x, boundary, query, rel_input)
        got = conv(graph, x, boundary, query, rel_input, rows=rows)
    assert torch.equal(got, want)
    assert profiling.counters["boundary_rows"] == 0


def test_query_nbfnet_keeps_the_dense_add(graph, seen_rows):
    model = _ultra(dims=(64,) * 2)
    g = torch.Generator().manual_seed(4)
    b = 3
    rel_repr = torch.randn(b, graph.num_relations, 64, generator=g)
    query = torch.randn(b, 64, generator=g)
    fuzzy = torch.rand(graph.num_nodes, b, generator=g)
    node_features = fuzzy[:, :, None] * query[None]
    with torch.no_grad():
        got = nbfnet.query_nbfnet_apply(model.entity_model, graph, node_features, rel_repr,
                                        query)
        hiddens = nbfnet.bellmanford(model.entity_model, graph, node_features, query, rel_repr)
        feature = torch.cat([hiddens[-1], query.expand(graph.num_nodes, b, 64)], dim=-1)
    assert seen_rows == [None] * 4
    assert torch.equal(got, model.entity_model.mlp(feature).squeeze(-1).T)


def test_attribution_keeps_the_dense_add(graph, seen_rows):
    from ultra_tpu_torch.models.visualize import edge_gradients

    model = _ultra(dims=(64,) * 2)
    edge_gradients(model, graph, h_index=3, t_index=17, r_index=1)
    assert len(seen_rows) == 4
    assert all(rows is not None for rows in seen_rows[:2])  # the relation model's convs
    assert seen_rows[2:] == [None] * 2  # the entity convs, called one by one


def test_the_counter_reads_each_conv_that_added_rows(graph, tmp_path):
    model = _ultra()
    h, r = torch.tensor(HEADS), torch.tensor(RELS)
    profiling.counters.clear()
    with torch.no_grad():
        nbfnet.ultra_score_all(model, graph, h, r_index=r)  # outside a trace: not counted
        assert profiling.counters["boundary_rows"] == 0
        with profiling.trace(str(tmp_path / "rank")):
            nbfnet.ultra_score_all(model, graph, h, r_index=r)
        assert profiling.counters["boundary_rows"] == 12  # 6 relation, 6 entity convs
        written = json.loads((tmp_path / "rank" / "counters.json").read_text())
        assert written["boundary_rows"] == 12
        with profiling.trace(str(tmp_path / "query")):
            nbfnet.query_nbfnet_apply(model.entity_model, graph,
                                      torch.ones(graph.num_nodes, 2, 64), torch.ones(2, 8, 64),
                                      torch.ones(2, 64))
        assert profiling.counters["boundary_rows"] == 0


@pytest.mark.card
def test_card_ranking_forward_is_the_dense_path(card):
    """A ranking batch of 16 on a 3,000-node graph at ULTRA's widths, on
    the card: the relation model, every entity hidden state and the scores
    with rows the dense path's bits (B1, E2 and index_add_ on the card; the
    scores of both through the scorer S1)."""
    g = _graph(num_nodes=3000, num_direct=20, num_triples=40_000, device=card, pad_to=None)
    model = _ultra().to(card)
    gen = torch.Generator().manual_seed(5)
    h = torch.randint(0, g.num_nodes, (16,), generator=gen).to(card)
    h[1::2] = h[0]
    r = torch.randint(0, g.num_relations, (16,), generator=gen).to(card)
    with torch.no_grad():
        rel_repr = nbfnet.rel_nbfnet_apply(model.relation_model, g.relation_graph, r)
        assert torch.equal(rel_repr, _dense_relation(model.relation_model, g.relation_graph, r))
        query = rel_repr[torch.arange(16, device=card), r]
        boundary = nbfnet.scatter_boundary(h, query, g.num_nodes)
        rows = nbfnet.boundary_rows(h, query, g.num_nodes)
        got = nbfnet.bellmanford(model.entity_model, g, boundary, query, rel_repr, rows)
        want = nbfnet.bellmanford(model.entity_model, g, boundary, query, rel_repr)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        scores = nbfnet.entity_nbfnet_score_all(model.entity_model, g, rel_repr, h, r)
        assert torch.equal(scores, nbfnet._score_nodes(model.entity_model, want, query))

"""The scorer (``ops/mlp_score_cuda.py``, S1): the entity model's scoring
MLP, ``Linear(128, 128)``, ReLU, ``Linear(128, 1)`` over every node's
``[last hidden | query]``, in one call where no gradient is wanted.

On the CPU the wrapper runs its plain twin, which must be the composed ops
(``mlp(torch.cat(...))``) bit for bit, and refuses what the kernel does not
take; ``models/nbfnet.py`` must call it exactly where the conditions it can
observe hold (the gradient mode, ``concat_hidden``, the MLP's layers and
widths, the batch, dtypes and layout), once a pass, and the composed ops
elsewhere. Tests marked ``card`` hold the kernel to its plain twin on a
CUDA card and skip without one. The file imports no JAX, so that on the
card it runs alone: ``python -m pytest tests/test_torch_mlp_score.py -m card
--noconftest -p no:cacheprovider -o addopts=""``.

Tolerance, on the card and for the split form on the CPU: max |got - want|
<= 1e-5 of the logits' largest |value|. Both compute in f32; the kernel sums
a row's 64 hidden products in k order, then adds the query half, which it
sums once a query (the split form's association), where the composed ops
sum the 128 products of ``[h | q]`` in cuBLAS's (or the CPU GEMM's) order;
the 128 ReLU outputs times ``w2`` are summed in other orders too.
"""

import re
from pathlib import Path

import pytest
import torch

from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.ops import mlp_score_cuda
from ultra_tpu_torch.ops.mlp_score_cuda import MAX_BATCH, mlp_score, mlp_score_plain
from ultra_tpu_torch.tasks import build_relation_graph_arrays
from ultra_tpu_torch.train import eval as eval_mod

REL_TOL = 1e-5
V, R_DIRECT, T = 40, 4, 150
HEADS = (3, 3, 17, 0)
RELS = (0, 1, 5, 7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mlp(seed=0, width=64):
    """The published scoring MLP (``NBFNet(score_mlp=True).mlp`` at D = 64)
    with weights from ``seed``."""
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(2 * width, 2 * width), torch.nn.ReLU(),
                               torch.nn.Linear(2 * width, 1))


def _operands(v, b, seed=0, device="cpu"):
    """h (V, B, 64) as the last conv leaves it (a layer norm's ReLU plus a
    short cut: mostly positive), q (B, 64), and the MLP's four tensors."""
    g = torch.Generator().manual_seed(seed)
    h = torch.relu(torch.randn(v, b, 64, generator=g)) + 0.5 * torch.randn(v, b, 64, generator=g)
    q = torch.randn(b, 64, generator=g)
    mlp = _mlp(seed)
    params = [p.detach() for p in (mlp[0].weight, mlp[0].bias, mlp[2].weight, mlp[2].bias)]
    return [t.to(device) for t in (h, q, *params)]


def _composed(h, q, w1, b1, w2, b2):
    mlp = _mlp()
    with torch.no_grad():
        for p, t in zip((mlp[0].weight, mlp[0].bias, mlp[2].weight, mlp[2].bias),
                        (w1, b1, w2, b2)):
            p.copy_(t)
        return mlp(torch.cat([h, q.expand(h.shape[0], *q.shape)], dim=-1)).squeeze(-1)


@pytest.mark.parametrize("v, b", [(1, 1), (37, 1), (13, 5), (101, 8), (50, 16), (7, 32),
                                  (3, 3)])
def test_plain_twin_is_the_composed_mlp_bit_for_bit(v, b):
    ops = _operands(v, b, seed=v + b)
    want = _composed(*ops)
    assert want.shape == (v, b)
    for got in (mlp_score_plain(*ops), mlp_score(*ops)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("v, b", [(37, 1), (101, 8), (50, 16), (33, 32)])
def test_split_form_is_within_the_tolerance_of_the_composed_ops(v, b):
    """The kernel's association, the hidden half plus the query half with
    its bias, in plain torch: within REL_TOL of the composed ops. The halves
    in the other order (the query half against the hidden columns) must
    not be."""
    h, q, w1, b1, w2, b2 = _operands(v, b, seed=3)
    want = _composed(h, q, w1, b1, w2, b2)
    hidden = h @ w1[:, :64].T + (q @ w1[:, 64:].T + b1)
    got = (torch.relu(hidden) @ w2.T + b2).squeeze(-1)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= REL_TOL * scale
    swapped = h @ w1[:, 64:].T + (q @ w1[:, :64].T + b1)
    bad = (torch.relu(swapped) @ w2.T + b2).squeeze(-1)
    assert float((bad - want).abs().max()) > 100 * REL_TOL * scale


def test_source_holds_as_many_queries_as_the_wrapper_allows():
    text = (Path(nbfnet.__file__).resolve().parents[1] / "csrc" / "mlp_score.cu").read_text()
    assert int(re.search(r"constexpr int kMaxBatch = (\d+);", text).group(1)) == MAX_BATCH
    assert MAX_BATCH >= 32


@pytest.mark.parametrize("case, error, match", [
    ("h f64", TypeError, "float32"),
    ("q bf16", TypeError, "float32"),
    ("w1 f64", TypeError, "float32"),
    ("h of width 32", ValueError, "want"),
    ("h of two dimensions", ValueError, "want"),
    ("q of another batch", ValueError, "want"),
    ("w1 of concat_hidden's width", ValueError, "w1"),
    ("w2 of two outputs", ValueError, "w1"),
    ("b2 a scalar", ValueError, "w1"),
    ("batch over the limit", ValueError, "batch"),
    ("h not contiguous", ValueError, "contiguous"),
    ("w1 not contiguous", ValueError, "contiguous"),
    ("q on another device", ValueError, "device|on meta"),
    ("h not 16-byte aligned", ValueError, "aligned"),
    ("b1 None", ValueError, "None"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    h, q, w1, b1, w2, b2 = _operands(6, 4)
    args = dict(h=h, q=q, w1=w1, b1=b1, w2=w2, b2=b2)
    if case == "h f64":
        args["h"] = h.double()
    elif case == "q bf16":
        args["q"] = q.bfloat16()
    elif case == "w1 f64":
        args["w1"] = w1.double()
    elif case == "h of width 32":
        args["h"] = h[..., :32].contiguous()
    elif case == "h of two dimensions":
        args["h"] = h.reshape(24, 64)
    elif case == "q of another batch":
        args["q"] = q[:3]
    elif case == "w1 of concat_hidden's width":
        args["w1"] = torch.zeros(128, 7 * 64)
    elif case == "w2 of two outputs":
        args["w2"] = torch.zeros(2, 128)
    elif case == "b2 a scalar":
        args["b2"] = b2.reshape(())
    elif case == "batch over the limit":
        args["h"], args["q"] = torch.zeros(2, MAX_BATCH + 1, 64), torch.zeros(MAX_BATCH + 1, 64)
    elif case == "h not contiguous":
        args["h"] = h.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "w1 not contiguous":
        args["w1"] = w1.T.contiguous().T
    elif case == "h not 16-byte aligned":
        args["h"] = torch.empty(h.numel() + 1)[1:].view(h.shape).copy_(h)
    elif case == "b1 None":
        args["b1"] = None
    else:
        args["q"] = q.to("meta")
    calls = mlp_score.launches.copy()
    assert mlp_score_cuda.takes(h, q, w1, b1, w2, b2)
    assert not mlp_score_cuda.takes(**args)
    with pytest.raises(error, match=match):
        mlp_score(**args)
    assert mlp_score.launches == calls


def _graph(device="cpu"):
    trip = random_kg_triples(V, R_DIRECT, T, seed=3)
    ei, et = with_inverses(trip, R_DIRECT)
    nrel = 2 * R_DIRECT
    rei, ret = build_relation_graph_arrays(ei, et, V, nrel)
    return make_graph(ei, et, V, nrel, pad_to=384, device=device,
                      relation_graph=make_graph(rei, ret, nrel, 4, device=device))


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _ultra(dim=64, dims=(64, 64), **entity):
    cfg = nbfnet.UltraConfig(
        relation_model=nbfnet.NBFNetConfig(input_dim=dim, hidden_dims=dims, num_relation=4),
        entity_model=nbfnet.NBFNetConfig(input_dim=dim, hidden_dims=dims, num_relation=1,
                                         project_relations=True, **entity))
    torch.manual_seed(0)
    return nbfnet.Ultra(cfg)


@pytest.fixture
def scorer(monkeypatch):
    """The (rows, B) of each call of S1's wrapper: on the card, one launch
    each (``test_launch_counter_counts_a_pass_on_the_card``)."""
    calls = []

    def spy(*args, **kwargs):
        calls.append((args[0].shape[0] * args[0].shape[1], args[0].shape[1]))
        return mlp_score(*args, **kwargs)

    monkeypatch.setattr(mlp_score_cuda, "mlp_score", spy)
    return calls


def _score_all(model, graph, b=len(HEADS)):
    h = torch.tensor(HEADS * 32, device=graph.device)[:b]
    r = torch.tensor(RELS * 32, device=graph.device)[:b]
    rel_repr = nbfnet.rel_nbfnet_apply(model.relation_model, graph.relation_graph, r)
    return nbfnet.entity_nbfnet_score_all(model.entity_model, graph, rel_repr, h, r)


B = len(HEADS)


@pytest.mark.parametrize("case, want", [
    ("published", [(V * B, B)]),
    ("gradient wanted", []),
    ("gradient of the queries alone", []),
    ("concat_hidden", []),
    ("num_mlp_layer 3", []),
    ("width 32", []),
    ("batch at the limit", [(V * MAX_BATCH, MAX_BATCH)]),
    ("batch over the limit", []),
])
def test_score_all_takes_s1_exactly_where_it_can(graph, scorer, case, want):
    kw = {"concat_hidden": dict(concat_hidden=True), "num_mlp_layer 3": dict(num_mlp_layer=3),
          "width 32": dict(dim=32, dims=(32, 32))}.get(case, {})
    model = _ultra(**kw)
    b = {"batch at the limit": MAX_BATCH, "batch over the limit": MAX_BATCH + 1}.get(case, B)
    if case == "gradient wanted":
        _score_all(model, graph, b)
    elif case == "gradient of the queries alone":
        model.requires_grad_(False)
        h, r = torch.tensor(HEADS), torch.tensor(RELS)
        rel_repr = nbfnet.rel_nbfnet_apply(model.relation_model, graph.relation_graph, r)
        nbfnet.entity_nbfnet_score_all(model.entity_model, graph, rel_repr.requires_grad_(),
                                       h, r)
    else:
        with torch.no_grad():
            _score_all(model, graph, b)
    assert scorer == want


@pytest.mark.parametrize("case", ["published", "hidden not contiguous",
                                  "hidden not 16-byte aligned", "queries not contiguous"])
def test_the_rule_reads_the_layout(case):
    model = _ultra().entity_model
    g = torch.Generator().manual_seed(5)
    hidden, query = torch.randn(V, B, 64, generator=g), torch.randn(B, 64, generator=g)
    if case == "hidden not contiguous":
        hidden = hidden.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "hidden not 16-byte aligned":
        hidden = torch.randn(V * B * 64 + 1, generator=g)[1:].view(V, B, 64)
    elif case == "queries not contiguous":
        query = torch.randn(64, B, generator=g).T
    with torch.no_grad():
        assert nbfnet._scorer_fused(model, hidden, query) == (case == "published")
    assert not nbfnet._scorer_fused(model, hidden, query)  # the parameters want a gradient


@pytest.mark.parametrize("case", ["hidden not contiguous", "hidden not 16-byte aligned"])
def test_the_composed_ops_score_what_s1_refuses_with_the_same_bits(scorer, case):
    model = _ultra().entity_model
    g = torch.Generator().manual_seed(6)
    hidden, query = torch.randn(V, B, 64, generator=g), torch.randn(B, 64, generator=g)
    if case == "hidden not contiguous":
        odd = hidden.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        odd = torch.empty(V * B * 64 + 1)[1:].view(V, B, 64).copy_(hidden)
    with torch.no_grad():
        got = nbfnet._score_nodes(model, [odd], query)
        assert scorer == []
        want = nbfnet._score_nodes(model, [hidden], query)
    assert scorer == [(V * B, B)]
    assert torch.equal(got, want)


def test_score_all_gives_todays_bits(graph):
    """``entity_nbfnet_score_all`` through S1's twin against the composed
    ops over ``_node_features``, as the function computed them before."""
    model = _ultra(dims=(64,) * 3)
    h, r = torch.tensor(HEADS), torch.tensor(RELS)
    with torch.no_grad():
        rel_repr = nbfnet.rel_nbfnet_apply(model.relation_model, graph.relation_graph, r)
        got = nbfnet.entity_nbfnet_score_all(model.entity_model, graph, rel_repr, h, r)
        feature = nbfnet.entity_nbfnet_features(model.entity_model, graph, rel_repr, h, r)
        want = model.entity_model.mlp(feature).squeeze(-1).T
    assert got.shape == (B, V)
    assert torch.equal(got, want)


def _query_inputs(graph, b=3, seed=2):
    g = torch.Generator().manual_seed(seed)
    boundary = torch.rand(graph.num_nodes, b, 64, generator=g)
    rel_reprs = torch.randn(b, graph.num_relations, 64, generator=g)
    query = torch.randn(b, 64, generator=g)
    return boundary, rel_reprs, query


def test_query_nbfnet_apply_gives_todays_bits(graph):
    model = _ultra().entity_model
    boundary, rel_reprs, query = _query_inputs(graph)
    with torch.no_grad():
        got = nbfnet.query_nbfnet_apply(model, graph, boundary, rel_reprs, query)
        hiddens = nbfnet.bellmanford(model, graph, boundary, query, relation_input=rel_reprs)
        want = model.mlp(nbfnet._features(model, hiddens, query)).squeeze(-1).T
    assert torch.equal(got, want)


def test_one_call_a_ranking_forward_and_a_query_pass_none_under_a_gradient(graph, scorer):
    """The calls the launch counter counts on the card: one a ranking
    forward (both directions in one entity pass of 2B queries), one a
    QueryNBFNet pass, none for a training forward or under a gradient."""
    model = _ultra().eval()
    b = 3
    batch = torch.tensor([[3, 9, 1], [17, 2, 0], [0, 5, 3]])
    rel_all = eval_mod.precompute_relation_representations(model, graph)
    masks = torch.ones(b, V, dtype=torch.bool)
    eval_mod.score_and_rank_batch_cached(model, graph, rel_all, batch, masks, masks)
    assert scorer == [(V * 2 * b, 2 * b)]
    eval_mod.score_and_rank_batch(model, graph, batch, masks, masks)
    assert scorer == [(V * 2 * b, 2 * b)] + [(V * b, b)] * 2
    scorer.clear()
    boundary, rel_reprs, query = _query_inputs(graph, b)
    with torch.no_grad():
        nbfnet.query_nbfnet_apply(model.entity_model, graph, boundary, rel_reprs, query)
    assert scorer == [(V * b, b)]
    scorer.clear()
    nbfnet.query_nbfnet_apply(model.entity_model, graph, boundary, rel_reprs, query)
    triples = torch.stack([batch[:, :1].expand(b, 4), torch.randint(0, V, (b, 4)),
                           batch[:, 2:].expand(b, 4)], dim=-1)
    nbfnet.ultra_apply(model, graph, triples)
    assert scorer == []


def _card_case(v, b, card, seed=0):
    ops = _operands(v, b, seed=seed, device=card)
    want = mlp_score_plain(*ops)
    before = mlp_score.launches[(v * b, b)]
    got = mlp_score(*ops)
    torch.cuda.synchronize()
    assert mlp_score.launches[(v * b, b)] == before + 1
    assert got.shape == (v, b) and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= REL_TOL * float(want.abs().max()), err
    return got


@pytest.mark.card
@pytest.mark.parametrize("v, b", [
    (123_182, 16),  # the ranking cell's entity pass: 1,970,912 rows
    (14_505, 32),  # the eval cell's: 464,160
    (14_541, 8),  # serving on FB15k-237 at a batch of 8: 116,328
    (1_001, 3),  # ragged: the last tile mostly past the end
    (5, MAX_BATCH),  # the largest batch, fewer rows than a tile
    (77, 1),
])
def test_kernel_matches_plain_twin(card, v, b):
    _card_case(v, b, card, seed=v)


@pytest.mark.card
def test_kernel_is_deterministic_and_reads_only_its_rows(card):
    """Two launches give the same bits, and a view of the first V - 1 nodes
    scores them as the whole does (the rows past the end are not read)."""
    h, q, w1, b1, w2, b2 = _operands(3_001, 16, seed=9, device=card)
    first = mlp_score(h, q, w1, b1, w2, b2)
    assert torch.equal(first, mlp_score(h, q, w1, b1, w2, b2))
    assert torch.equal(first[:-1], mlp_score(h[:-1], q, w1, b1, w2, b2))


@pytest.mark.card
def test_launch_counter_counts_a_pass_on_the_card(card):
    graph = _graph(card)
    model = _ultra().to(card).eval()
    mlp_score.launches.clear()
    with torch.no_grad():
        got = _score_all(model, graph)
        h, r = torch.tensor(HEADS, device=card), torch.tensor(RELS, device=card)
        rel_repr = nbfnet.rel_nbfnet_apply(model.relation_model, graph.relation_graph, r)
        feature = nbfnet.entity_nbfnet_features(model.entity_model, graph, rel_repr, h, r)
        want = model.entity_model.mlp(feature).squeeze(-1).T
    assert dict(mlp_score.launches) == {(V * B, B): 1}
    err = float((got - want).abs().max())
    assert err <= REL_TOL * float(want.abs().max()), err

"""The conv epilogue (``ops/epilogue_cuda.py``, E1): layer norm, ReLU and
the short cut of a conv layer in one call where no gradient is wanted.

On the CPU the wrapper runs its plain twin, which must be the conv's
composed ops bit for bit; the conv must call it only where no gradient is
wanted, and ``bellmanford``'s hidden states and gradients (with and without
remat) must equal the composition the conv and ``bellmanford`` ran before
the epilogue, bit for bit. Tests marked ``card`` hold the kernel to its
plain twin on a CUDA card and skip without one. The file imports no JAX, so
that on the card it runs alone: ``python -m pytest
tests/test_torch_epilogue.py -m card --noconftest -p no:cacheprovider``.

Tolerance on the card: max |kernel - twin| <= 2e-6 of the output's largest
|value|. Both compute f32 layer norm with different reduction orders (the
kernel a two-pass sum over a butterfly, PyTorch's Welford); each output
element is a few roundings of values of order 1.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ultra_tpu_torch import tasks
from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import layers, nbfnet
from ultra_tpu_torch.ops import epilogue_cuda
from ultra_tpu_torch.ops.conv_tail_cuda import conv_tail
from ultra_tpu_torch.ops.epilogue_cuda import conv_epilogue, conv_epilogue_plain
from ultra_tpu_torch.tasks import build_relation_graph_arrays

CARD_REL_TOL = 2e-6
V, R_DIRECT, T, BATCH = 40, 4, 150, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(rows, n, residual, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(rows, n, generator=g) * 3 + 0.5
    gamma = torch.rand(n, generator=g) + 0.5
    beta = torch.randn(n, generator=g)
    res = torch.randn(rows, n, generator=g) if residual else None
    return [None if t is None else t.to(device) for t in (y, gamma, beta, res)]


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_twin_is_the_composed_ops(n, residual, relu):
    y, gamma, beta, res = _operands(37, n, residual)
    ln = torch.nn.LayerNorm(n, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(gamma)
        ln.bias.copy_(beta)
        want = ln(y)
        if relu:
            want = F.relu(want)
        if residual:
            want = want + res
    for got in (conv_epilogue_plain(y, gamma, beta, 1e-5, relu, res),
                conv_epilogue(y, gamma, beta, 1e-5, relu, res)):
        assert torch.equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    y, gamma, beta, res = _operands(8, 64, True)
    with pytest.raises(ValueError, match="contiguous"):
        conv_epilogue(y.t().contiguous().t(), gamma, beta, 1e-5, True, res)
    with pytest.raises(ValueError, match="contiguous"):
        conv_epilogue(y, gamma, beta, 1e-5, True, res.t().contiguous().t())
    with pytest.raises(ValueError, match="multiple of 4"):
        conv_epilogue(y[:, :62].contiguous(), gamma[:62], beta[:62], 1e-5, True)
    with pytest.raises(TypeError, match="float32"):
        conv_epilogue(y.double(), gamma, beta, 1e-5, True)
    with pytest.raises(TypeError, match="float32"):
        conv_epilogue(y, gamma, beta, 1e-5, True, res.bfloat16())
    with pytest.raises(ValueError, match="residual"):
        conv_epilogue(y, gamma, beta, 1e-5, True, res[:4])


@pytest.fixture(scope="module")
def graph():
    trip = random_kg_triples(V, R_DIRECT, T, seed=3)
    ei, et = with_inverses(trip, R_DIRECT)
    nrel = 2 * R_DIRECT
    rei, ret = build_relation_graph_arrays(ei, et, V, nrel)
    return make_graph(ei, et, V, nrel, pad_to=384, device="cpu",
                      relation_graph=make_graph(rei, ret, nrel, 4, device="cpu"))


def _model(remat=False, dims=(64, 64, 64), dim=64):
    cfg = nbfnet.NBFNetConfig(input_dim=dim, hidden_dims=dims, num_relation=1,
                              project_relations=True, remat=remat)
    torch.manual_seed(0)
    model = nbfnet.NBFNet(cfg)
    with torch.no_grad():  # a layer norm off its ones and zeros
        for conv in model.layers:
            conv.layer_norm.weight.uniform_(0.5, 1.5)
            conv.layer_norm.bias.normal_()
    return model


def _inputs(graph, dim=64):
    g = torch.Generator().manual_seed(1)
    query = torch.randn(BATCH, dim, generator=g)
    boundary = nbfnet.scatter_boundary(torch.tensor([3, 3, 17]), query, graph.num_nodes)
    rel_input = torch.randn(BATCH, graph.num_relations, dim, generator=g)
    return boundary, query, rel_input


def _parent_conv(conv, graph, x, boundary, query, rel_input):
    """The conv as it ran before the epilogue: layer norm and activation
    composed, no short cut."""
    relation = conv.layer_relation(query, rel_input)
    update = conv._update(graph, x, boundary, relation)
    out = conv.linear(torch.cat([x, update], dim=-1))
    return F.relu(conv.layer_norm(out))


def _parent_bellmanford(model, graph, boundary, query, rel_input):
    """``bellmanford`` as it ran before the epilogue: the short cut added
    after each conv, outside remat's checkpoint."""
    layer_input, hiddens = boundary, []
    remat = model.cfg.remat and torch.is_grad_enabled()
    for conv in model.layers:
        args = (conv, graph, layer_input, boundary, query, rel_input)
        hidden = (checkpoint(_parent_conv, *args, use_reentrant=False) if remat
                  else _parent_conv(*args))
        if model.cfg.short_cut and hidden.shape == layer_input.shape:
            hidden = hidden + layer_input
        hiddens.append(hidden)
        layer_input = hidden
    return hiddens


def test_conv_calls_the_epilogue_only_without_gradients(graph, monkeypatch):
    """E1 ends the layers that E2 (``ops/conv_tail_cuda.py``) does not
    take: at inference a 64 -> 64 layer is E2's, a 128 -> 128 layer E1's,
    and with a gradient wanted, or at a width E1 is not built for (32), the
    ops are composed."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return conv_epilogue(*args, **kwargs)

    monkeypatch.setattr(epilogue_cuda, "conv_epilogue", spy)
    model = _model(dims=(128, 128), dim=128)
    boundary, query, rel_input = _inputs(graph, dim=128)
    with torch.no_grad():
        nbfnet.bellmanford(model, graph, boundary, query, rel_input)
    assert calls == [(V, BATCH, 128)] * 2
    calls.clear()
    nbfnet.bellmanford(model, graph, boundary, query, rel_input)
    assert calls == []
    # a gradient wanted of an input alone, the parameters frozen: composed
    model.requires_grad_(False)
    nbfnet.bellmanford(model, graph, boundary.requires_grad_(), query, rel_input)
    assert calls == []
    # 64 -> 64 (E2's), then a width E1 is not built for (32): composed
    model = _model(dims=(64, 32))
    boundary, query, rel_input = _inputs(graph)
    with torch.no_grad():
        nbfnet.bellmanford(model, graph, boundary, query, rel_input)
    assert calls == []


@pytest.mark.parametrize("remat", [False, True])
def test_bellmanford_equals_the_parent_composition(graph, remat):
    model = _model(remat)
    boundary, query, rel_input = _inputs(graph)
    with torch.no_grad():
        got = nbfnet.bellmanford(model, graph, boundary, query, rel_input)
        want = _parent_bellmanford(model, graph, boundary, query, rel_input)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))

    weight = torch.randn(V, BATCH, 64, generator=torch.Generator().manual_seed(2))
    grads = []
    for fn in (nbfnet.bellmanford, _parent_bellmanford):
        model.zero_grad()
        q, r = query.clone().requires_grad_(), rel_input.clone().requires_grad_()
        b = nbfnet.scatter_boundary(torch.tensor([3, 3, 17]), q, graph.num_nodes)
        hiddens = fn(model, graph, b, q, r)
        (hiddens[-1] * weight).sum().backward()
        grads.append([hiddens[-1].detach(), q.grad, r.grad]
                     + [p.grad.clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads, strict=True))


def _card_case(rows, n, residual, card):
    y, gamma, beta, res = _operands(rows, n, residual, card, seed=rows)
    want = conv_epilogue_plain(y, gamma, beta, 1e-5, True, res)
    before = conv_epilogue.launches[(rows, n)]
    got = conv_epilogue(y.clone(), gamma, beta, 1e-5, True, res)
    torch.cuda.synchronize()
    assert conv_epilogue.launches[(rows, n)] == before + 1
    err = float((got - want).abs().max())
    assert err <= CARD_REL_TOL * float(want.abs().max()), err


@pytest.mark.card
@pytest.mark.parametrize("rows, n, residual", [
    (1_970_912, 64, True),  # the ranking cell's entity pass: 123,182 nodes x 16 queries
    (4_736, 64, True),  # the relation precompute: 74 relations x 64
    (1_001, 64, True),  # ragged: a warp's second row past the end
    (1_001, 128, False),
])
def test_kernel_matches_plain_twin(card, rows, n, residual):
    _card_case(rows, n, residual, card)


@pytest.mark.card
def test_collect_rankings_same_ranks_with_the_kernel(card, monkeypatch):
    from ultra_tpu_torch.train.eval import collect_rankings
    from ultra_tpu_torch.train.loop import init_ultra_params

    trip = random_kg_triples(300, 5, 1500, seed=4)
    ei, et = with_inverses(trip, 5)
    rei, ret = build_relation_graph_arrays(ei, et, 300, 10)
    g = make_graph(ei, et, 300, 10, device=card,
                   relation_graph=make_graph(rei, ret, 10, 4, device=card))
    index = tasks.GraphIndex.build(ei, et, 300, 10)
    model = init_ultra_params(nbfnet.UltraConfig(), torch.Generator().manual_seed(0),
                              device=card).eval()
    trips = trip[:48]
    conv_epilogue.launches.clear()
    conv_tail.launches.clear()
    fused = collect_rankings(model, g, trips, index, batch_size=8)
    layers_ = len(model.entity_model.layers)
    # E2 ends every layer (64 -> 64): 6 launches a pass of the entity model a
    # batch (both directions: 16 queries), and 6 in the relation model's
    # precompute (10 relations x a chunk of 64 queries); E1 none
    assert dict(conv_tail.launches) == {(300 * 16, 64): layers_ * 6, (10 * 64, 64): layers_}
    assert not conv_epilogue.launches
    monkeypatch.setattr(layers.GeneralizedRelationalConv, "_tail", lambda *a: False)
    monkeypatch.setattr(layers.GeneralizedRelationalConv, "_fused", lambda *a: False)
    composed = collect_rankings(model, g, trips, index, batch_size=8)
    for a, b in zip(fused, composed, strict=True):
        np.testing.assert_array_equal(a, b)

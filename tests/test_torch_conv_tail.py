"""The conv's tail (``ops/conv_tail_cuda.py``, E2): the linear of
``[input | update]``, layer norm, ReLU and the short cut of a 64 -> 64 conv
layer in one call where no gradient is wanted.

On the CPU the wrapper runs its plain twin, which must be the conv's
composed ops (``linear(cat)``, then E1's twin) bit for bit, and refuses what
the kernel does not take; the conv must call it exactly where the
conditions it can observe hold (shapes, dtypes, layout, the gradient mode
and the short cut's identity), and E1 or the composed ops elsewhere. Tests
marked ``card`` hold the kernel to its plain twin on a CUDA card and skip
without one. The file imports no JAX, so that on the card it runs alone:
``python -m pytest tests/test_torch_conv_tail.py -m card --noconftest -p
no:cacheprovider -o addopts=""``.

Tolerance on the card: max |kernel - twin| <= 1e-5 of the output's largest
|value|. Both compute in f32 and sum the 128 products of a row's linear in
other orders (the kernel in k order with FFMA, cuBLAS in its own tiles),
then reduce the layer norm in other orders (E1 note in
``test_torch_epilogue.py``); the normalisation divides each difference by
the row's standard deviation, so it is read against the output's scale.
"""

import pytest
import torch
import torch.nn.functional as F

from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.ops import conv_tail_cuda, epilogue_cuda
from ultra_tpu_torch.ops.conv_tail_cuda import conv_tail, conv_tail_plain
from ultra_tpu_torch.ops.epilogue_cuda import conv_epilogue, conv_epilogue_plain
from ultra_tpu_torch.tasks import build_relation_graph_arrays

CARD_REL_TOL = 1e-5
V, R_DIRECT, T, BATCH = 40, 4, 150, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(rows, device="cpu", seed=0):
    """x, u (rows, 64) and a linear and layer norm's parameters, as a conv
    layer at inference sees them (u holds the boundary: larger)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, 64, generator=g)
    u = 4 * torch.randn(rows, 64, generator=g) + 0.5
    lin = torch.nn.Linear(128, 64)
    with torch.no_grad():
        lin.weight.copy_((torch.rand(64, 128, generator=g) - 0.5) / 4)
        lin.bias.copy_(torch.randn(64, generator=g) / 4)
    gamma = torch.rand(64, generator=g) + 0.5
    beta = torch.randn(64, generator=g)
    return [t.detach().to(device) for t in (x, u, lin.weight, lin.bias, gamma, beta)]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_twin_is_linear_of_cat_then_the_epilogue(residual, relu):
    x, u, w, b, gamma, beta = _operands(37)
    res = x if residual else None
    want = conv_epilogue_plain(F.linear(torch.cat([x, u], dim=-1), w, b), gamma, beta, 1e-5,
                               relu, res)
    for got in (conv_tail_plain(x, u, w, b, gamma, beta, 1e-5, relu, res),
                conv_tail(x, u, w, b, gamma, beta, 1e-5, relu, res)):
        assert torch.equal(got, want)
    # (V, B, 64) states, as the conv passes them
    x3, u3 = x[:36].view(12, 3, 64), u[:36].view(12, 3, 64)
    got = conv_tail(x3, u3, w, b, gamma, beta, 1e-5, relu, x3 if residual else None)
    assert torch.equal(got.view(36, 64), conv_tail_plain(x[:36], u[:36], w, b, gamma, beta,
                                                         1e-5, relu, x[:36] if residual
                                                         else None))


@pytest.mark.parametrize("case, error, match", [
    ("x f64", TypeError, "float32"),
    ("u bf16", TypeError, "float32"),
    ("weight f64", TypeError, "float32"),
    ("width 32", ValueError, "shape"),
    ("u of another shape", ValueError, "shape"),
    ("weight of PNA's width", ValueError, "weight"),
    ("x not contiguous", ValueError, "contiguous"),
    ("u not contiguous", ValueError, "contiguous"),
    ("residual a copy of x", ValueError, "x itself"),
    ("residual u", ValueError, "x itself"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    x, u, w, b, gamma, beta = _operands(8)
    args = dict(x=x, u=u, weight=w, bias=b, gamma=gamma, beta=beta, residual=None)
    if case == "x f64":
        args["x"] = x.double()
    elif case == "u bf16":
        args["u"] = u.bfloat16()
    elif case == "weight f64":
        args["weight"] = w.double()
    elif case == "width 32":
        args.update(x=x[:, :32].contiguous(), u=u[:, :32].contiguous())
    elif case == "u of another shape":
        args["u"] = u[:4]
    elif case == "weight of PNA's width":
        args["weight"] = torch.zeros(64, 13 * 64)
    elif case == "x not contiguous":
        args["x"] = x.t().contiguous().t()
    elif case == "u not contiguous":
        args["u"] = u.t().contiguous().t()
    elif case == "residual a copy of x":
        args["residual"] = x.clone()
    else:
        args["residual"] = u
    calls = conv_tail.launches.copy()
    with pytest.raises(error, match=match):
        conv_tail(eps=1e-5, relu=True, **args)
    assert conv_tail.launches == calls


@pytest.fixture(scope="module")
def graph():
    trip = random_kg_triples(V, R_DIRECT, T, seed=3)
    ei, et = with_inverses(trip, R_DIRECT)
    nrel = 2 * R_DIRECT
    rei, ret = build_relation_graph_arrays(ei, et, V, nrel)
    return make_graph(ei, et, V, nrel, pad_to=384, device="cpu",
                      relation_graph=make_graph(rei, ret, nrel, 4, device="cpu"))


def _model(dims=(64, 64, 64), dim=64, **kw):
    cfg = nbfnet.NBFNetConfig(input_dim=dim, hidden_dims=dims, num_relation=1,
                              project_relations=True, **kw)
    torch.manual_seed(0)
    return nbfnet.NBFNet(cfg)


def _inputs(graph, dim=64):
    g = torch.Generator().manual_seed(1)
    query = torch.randn(BATCH, dim, generator=g)
    boundary = nbfnet.scatter_boundary(torch.tensor([3, 3, 17]), query, graph.num_nodes)
    rel_input = torch.randn(BATCH, graph.num_relations, dim, generator=g)
    return boundary, query, rel_input


@pytest.fixture
def spies(monkeypatch):
    """The shapes the conv hands E2 (``tail``) and E1 (``epilogue``)."""
    calls = {"tail": [], "epilogue": []}

    def tail(*args, **kwargs):
        calls["tail"].append(tuple(args[0].shape))
        return conv_tail(*args, **kwargs)

    def epilogue(*args, **kwargs):
        calls["epilogue"].append(tuple(args[0].shape))
        return conv_epilogue(*args, **kwargs)

    monkeypatch.setattr(conv_tail_cuda, "conv_tail", tail)
    monkeypatch.setattr(epilogue_cuda, "conv_epilogue", epilogue)
    return calls


SHAPE = (V, BATCH, 64)


@pytest.mark.parametrize("case, want_tail, want_epilogue", [
    ("inference", [SHAPE] * 3, []),
    ("no activation", [SHAPE] * 3, []),
    ("no short cut", [SHAPE] * 3, []),
    ("gradient wanted", [], []),
    ("gradient of the input alone", [], []),
    ("64 then 32", [SHAPE], []),  # the 64 -> 32 layer's linear is composed, E1 takes no 32
    ("width 128", [], [(V, BATCH, 128)] * 3),  # 128 -> 128: E1
    ("pna", [], [SHAPE] * 3),  # linear over 13 * 64: E1
    ("bf16 operands", [SHAPE] * 3, []),  # the bf16-x instance rounds the f32 input itself
    ("tanh", [], []),
    ("no layer norm", [], []),
])
def test_conv_takes_e2_exactly_where_it_can(graph, spies, case, want_tail, want_epilogue):
    kw = {"no activation": dict(activation=None), "no short cut": dict(short_cut=False),
          "64 then 32": dict(dims=(64, 32)), "width 128": dict(dim=128, dims=(128,) * 3),
          "pna": dict(aggregate_func="pna"), "bf16 operands": dict(compute_dtype="bfloat16"),
          "tanh": dict(activation="tanh"), "no layer norm": dict(layer_norm=False)}.get(case, {})
    model = _model(**kw)
    boundary, query, rel_input = _inputs(graph, model.cfg.input_dim)
    if case == "gradient wanted":
        nbfnet.bellmanford(model, graph, boundary, query, rel_input)
    elif case == "gradient of the input alone":
        model.requires_grad_(False)
        nbfnet.bellmanford(model, graph, boundary.requires_grad_(), query, rel_input)
    else:
        with torch.no_grad():
            nbfnet.bellmanford(model, graph, boundary, query, rel_input)
    assert spies == {"tail": want_tail, "epilogue": want_epilogue}


@pytest.mark.parametrize("case", ["residual another tensor", "input not contiguous",
                                  "input not 16-byte aligned"])
def test_conv_leaves_other_operands_to_e1(graph, spies, case):
    conv = _model().layers[0]
    boundary, query, rel_input = _inputs(graph)
    x = torch.randn(V, BATCH, 64, generator=torch.Generator().manual_seed(5))
    residual = x
    if case == "residual another tensor":
        residual = x.clone()
    elif case == "input not contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
        residual = x
    else:
        x = torch.randn(V * BATCH * 64 + 1)[1:].view(V, BATCH, 64)
        residual = x
    with torch.no_grad():
        got = conv(graph, x, boundary, query, rel_input, residual=residual)
        assert spies == {"tail": [], "epilogue": [SHAPE]}
        x = x.contiguous().clone()  # a new buffer: contiguous and aligned
        want = conv(graph, x, boundary, query, rel_input, residual=x)
    assert spies["tail"] == [SHAPE]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _card_case(rows, residual, card):
    x, u, w, b, gamma, beta = _operands(rows, card, seed=rows)
    res = x if residual else None
    want = conv_tail_plain(x, u, w, b, gamma, beta, 1e-5, True, res)
    before = conv_tail.launches[(rows, 64)]
    got = conv_tail(x, u, w, b, gamma, beta, 1e-5, True, res)
    torch.cuda.synchronize()
    assert conv_tail.launches[(rows, 64)] == before + 1
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= CARD_REL_TOL * float(want.abs().max()), err


@pytest.mark.card
@pytest.mark.parametrize("rows", [
    1_970_912,  # the ranking cell's entity pass: 123,182 nodes x 16 queries
    464_160,  # the eval cell's: 14,505 nodes x 32 queries
    116_328,  # serving on FB15k-237 at a batch of 8: 14,541 x 8
    4_736,  # the ranking cell's relation precompute: 74 relations x 64
    1_001,  # ragged: the last tile mostly past the end
])
@pytest.mark.parametrize("residual", [True, False])
def test_kernel_matches_plain_twin(card, rows, residual):
    _card_case(rows, residual, card)

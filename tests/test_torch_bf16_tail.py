"""ULTRA under ``compute_dtype: bfloat16`` with E2's bf16-x instance
(``ops/conv_tail_cuda.py``, ``round_x``): each conv rounds its rspmm
operands to bf16, and at inference its tail reads the f32 layer input,
rounds it to bf16 for the linear and adds it unrounded as the short cut.

Held here:
- the port with the benchmark's ``ultra_3g_bf16`` settings against the bf16
  plain reference (``benchmark/reference/ultra_bf16.py``), which shares no
  code with the port. Tolerance ``REF_REL_TOL`` of the largest |value|: both
  round the same f32 values to bf16 and sum exact bf16 products in f32, so
  only the order of those f32 sums may differ, as in the f32 comparisons
  of ``test_torch_models.py`` (rtol 1e-4, atol 1e-5); on the CPU the two
  come out equal at this size. The float32 reference misses the bound by
  two orders of magnitude (about 1e-3 of the largest score): the test fails
  if the port skips the rounding;
- the plain twin's ``round_x`` against the conv's composed ops, bit for
  bit, and the conv's choice of E2 under bf16 (the composed ops where a
  gradient is wanted, which round in the same place);
- the profiling counter ``cast_bytes``: the bytes of the conv's casts of
  node states and relation features, counted while a profiler records, and
  none on an f32 model;
- on the card (``card``, skipped without one): the bf16-x instance against
  its plain twin at the ranking cell's 1,970,912 rows within E2's tolerance
  (``tests/test_torch_conv_tail.py``), the launch keys of both instances,
  and the f32 instance's output bit for bit what it was before the bf16-x
  instance was added (a hash of its output on inputs drawn on the CPU).
  The file imports no JAX: ``python -m pytest tests/test_torch_bf16_tail.py
  -m card --noconftest -p no:cacheprovider -o addopts=""`` on the card.
"""

import hashlib

import pytest
import torch
import torch.nn.functional as F

from benchmark.data import kg
from benchmark.data.weights import make_weights
from benchmark.harness import cells, program
from benchmark.reference import relgraph, ultra, ultra_bf16
from ultra_tpu_torch.data.kg import KGSplit, split_to_graph
from ultra_tpu_torch.models import layers, nbfnet
from ultra_tpu_torch.models.nbfnet import entity_nbfnet_score_all
from ultra_tpu_torch.ops import conv_tail_cuda
from ultra_tpu_torch.ops.conv_tail_cuda import conv_tail, conv_tail_plain
from ultra_tpu_torch.ops.epilogue_cuda import conv_epilogue_plain
from ultra_tpu_torch.train.eval import precompute_relation_representations
from ultra_tpu_torch.utils import profiling

REF_REL_TOL = 1e-5
CARD_REL_TOL = 1e-5  # E2 against its plain twin (tests/test_torch_conv_tail.py)
V, R, T = 200, 5, 900
HEADS, QRELS = [3, 9, 40, 41, 100, 150], [0, 5, 2, 7, 1, 9]
# sha256 of the f32 instance's output bytes on _operands(RANKING_ROWS) with
# ReLU and the short cut, on an H100, before the bf16-x instance was added
F32_INSTANCE_SHA256 = "a08c702ff0a83b9152a96b0f8eb9078a12e47efc157f993ca3b0cfe4a506bad7"
RANKING_ROWS = 123_182 * 16  # the ranking cell's entity pass: 16 queries


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _config(name):
    return cells.load_json(cells.BENCH_DIR / "configs" / f"{name}.json")


@pytest.fixture(scope="module")
def case():
    trip = kg.random_kg_triples(V, R, T, seed=0, rel_dist="zipf")
    edges = kg.with_inverses(trip, R)
    split = KGSplit(*edges, V, 2 * R, trip[:, :2].T.copy(), trip[:, 2])
    return (split_to_graph(split, device="cpu"), relgraph.entity_graph(*edges, V, 2 * R, "cpu"),
            relgraph.relation_graph(*edges, V, 2 * R, "cpu"))


def _reference(module, w, cfg, ref_graph, ref_rel_graph):
    rels = torch.arange(2 * R)
    reprs = module.relation_representations(w, cfg, ref_rel_graph, rels)
    qrels = torch.tensor(QRELS)
    return reprs, module.score_all(w, cfg, ref_graph, reprs[qrels], torch.tensor(HEADS), qrels)


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
@torch.no_grad()
def test_port_matches_the_bf16_reference_and_the_f32_one_does_not(case, seed):
    graph, ref_graph, ref_rel_graph = case
    cfg = _config("ultra_3g_bf16")
    w = make_weights(cfg, seed % (1 << 63), "cpu")
    model = program.ultra_model(cfg, w, "cpu")
    assert all(c.cfg.compute_dtype == "bfloat16"
               for m in (model.relation_model, model.entity_model) for c in m.layers)
    reprs = precompute_relation_representations(model, graph)
    qrels = torch.tensor(QRELS)
    scores = entity_nbfnet_score_all(model.entity_model, graph, reprs[qrels],
                                     torch.tensor(HEADS), qrels)
    want_reprs, want = _reference(ultra_bf16, w, cfg, ref_graph, ref_rel_graph)
    assert _rel_err(reprs, want_reprs) <= REF_REL_TOL
    assert _rel_err(scores, want) <= REF_REL_TOL
    f32_reprs, f32 = _reference(ultra, w, _config("ultra_3g"), ref_graph, ref_rel_graph)
    assert _rel_err(f32_reprs, want_reprs) > 100 * REF_REL_TOL
    assert _rel_err(f32, want) > 100 * REF_REL_TOL


def _operands(rows, device="cpu", seed=0):
    """x, u (rows, 64), a linear and a layer norm's parameters, drawn on the
    CPU (the same values on every machine)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, 64, generator=g)
    u = 4 * torch.randn(rows, 64, generator=g) + 0.5
    w = (torch.rand(64, 128, generator=g) - 0.5) / 4
    b = torch.randn(64, generator=g) / 4
    gamma = torch.rand(64, generator=g) + 0.5
    beta = torch.randn(64, generator=g)
    return [t.to(device) for t in (x, u, w, b, gamma, beta)]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_twin_rounds_x_for_the_linear_alone(residual, relu):
    x, u, w, b, gamma, beta = _operands(37)
    res = x if residual else None
    want = conv_epilogue_plain(F.linear(torch.cat([x.to(torch.bfloat16).float(), u], dim=-1),
                                        w, b), gamma, beta, 1e-5, relu, res)
    for got in (conv_tail_plain(x, u, w, b, gamma, beta, 1e-5, relu, res, round_x=True),
                conv_tail(x, u, w, b, gamma, beta, 1e-5, relu, res, round_x=True)):
        assert torch.equal(got, want)
    unrounded = conv_tail_plain(x, u, w, b, gamma, beta, 1e-5, relu, res)
    assert not torch.equal(unrounded, want)


def _model(compute_dtype="bfloat16"):
    """An entity model of three 64 -> 64 layers."""
    cfg = nbfnet.NBFNetConfig(num_relation=1, project_relations=True,
                              hidden_dims=(64, 64, 64), compute_dtype=compute_dtype)
    torch.manual_seed(0)
    return nbfnet.NBFNet(cfg)


def _entity_inputs(graph):
    """A boundary, queries, relation input and rows of 3 queries."""
    g = torch.Generator().manual_seed(1)
    heads = torch.tensor([3, 3, 17])
    query = torch.randn(3, 64, generator=g)
    boundary = nbfnet.scatter_boundary(heads, query, graph.num_nodes)
    rel_input = torch.randn(3, graph.num_relations, 64, generator=g)
    return boundary, query, rel_input, nbfnet.boundary_rows(heads, query, graph.num_nodes)


@pytest.mark.parametrize("mode", ["inference", "gradient wanted"])
def test_bf16_conv_ends_in_the_bf16_x_instance_at_inference(case, monkeypatch, mode):
    graph = case[0]
    model = _model()
    boundary, query, rel_input, rows = _entity_inputs(graph)
    calls = []

    def tail(*args, **kwargs):
        calls.append((tuple(args[0].shape), args[0].dtype, kwargs.get("round_x")))
        return conv_tail(*args, **kwargs)

    monkeypatch.setattr(conv_tail_cuda, "conv_tail", tail)
    with torch.set_grad_enabled(mode == "gradient wanted"):
        got = nbfnet.bellmanford(model, graph, boundary, query, rel_input, rows=rows)
    shape = (graph.num_nodes, 3, 64)
    assert calls == ([(shape, torch.float32, True)] * 3 if mode == "inference" else [])
    monkeypatch.setattr(layers.GeneralizedRelationalConv, "_tail", lambda *a: False)
    monkeypatch.setattr(layers.GeneralizedRelationalConv, "_fused", lambda *a: False)
    with torch.no_grad():
        composed = nbfnet.bellmanford(model, graph, boundary, query, rel_input, rows=rows)
    for a, c in zip(got, composed):
        assert torch.equal(a.detach(), c)


def test_f32_conv_keeps_the_f32_instance(case, monkeypatch):
    graph = case[0]
    model = _model(None)
    boundary, query, rel_input, rows = _entity_inputs(graph)
    calls = []

    def tail(*args, **kwargs):
        calls.append(kwargs.get("round_x"))
        return conv_tail(*args, **kwargs)

    monkeypatch.setattr(conv_tail_cuda, "conv_tail", tail)
    with torch.no_grad():
        nbfnet.bellmanford(model, graph, boundary, query, rel_input, rows=rows)
    assert calls == [False] * 3


@pytest.mark.parametrize("dtype", ["bfloat16", None])
@torch.no_grad()
def test_cast_bytes_counts_the_convs_casts(case, dtype):
    graph = case[0]
    model = _model(dtype)
    boundary, query, rel_input, rows = _entity_inputs(graph)
    profiling.counters.clear()
    nbfnet.bellmanford(model, graph, boundary, query, rel_input, rows=rows)  # no profiler
    assert "cast_bytes" not in profiling.counters
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        nbfnet.bellmanford(model, graph, boundary, query, rel_input, rows=rows)
    if dtype is None:
        assert "cast_bytes" not in profiling.counters
        return
    # each of the 3 convs casts its (V, 3, 64) input and its (R, 3, 64)
    # relation features, 4 bytes read and 2 written an element
    per_conv = (graph.num_nodes + graph.num_relations) * 3 * 64 * (4 + 2)
    assert profiling.counters["cast_bytes"] == 3 * per_conv
    profiling.counters.clear()


def _sha256(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.card
@pytest.mark.parametrize("rows", [RANKING_ROWS, 4_736, 1_001])
@pytest.mark.parametrize("residual", [True, False])
def test_bf16_x_instance_matches_its_plain_twin(card, rows, residual):
    x, u, w, b, gamma, beta = _operands(rows, card, seed=rows)
    res = x if residual else None
    want = conv_tail_plain(x, u, w, b, gamma, beta, 1e-5, True, res, round_x=True)
    conv_tail.launches.clear()
    got = conv_tail(x, u, w, b, gamma, beta, 1e-5, True, res, round_x=True)
    f32 = conv_tail(x, u, w, b, gamma, beta, 1e-5, True, res)
    torch.cuda.synchronize()
    assert dict(conv_tail.launches) == {(rows, 64, "bf16_x"): 1, (rows, 64): 1}
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= CARD_REL_TOL * float(want.abs().max()), err
    assert not torch.equal(got, f32)  # the linear read x rounded


@pytest.mark.card
def test_f32_instance_keeps_its_bits(card):
    x, u, w, b, gamma, beta = _operands(RANKING_ROWS, card)
    got = conv_tail(x, u, w, b, gamma, beta, 1e-5, True, x)
    torch.cuda.synchronize()
    assert _sha256(got) == F32_INSTANCE_SHA256

"""UltraQuery's filtered ranking on the device (``query/metrics.py::
batch_evaluate_device``, ``query/trainer.py::rank_queries``) against the
numpy ranking it replaces on the evaluation path (``batch_evaluate``, which
the JAX package's tests hold); the grouped executor's plan of its cheap ops
(``query/executor.py::cheap_schedule``) against running every slot; and the
spans and counters of the grouped executor and of ``rank_queries``, on the
CPU.

The ranks, answer ranks and answer counts must be equal as integers;
``num_pred`` is summed in float64 on the device where the host summed
float32, so it agrees within 1e-6 relative, the two metrics read from it
(mape, spearmanr) within 1e-6 absolute (as ``test_torch_query.py`` holds
the metrics to the JAX package's), every other metric exactly.
"""

import numpy as np
import pytest
import torch

from tests.test_query_trainer import toy_query_dataset
from tests.test_torch_query import betae_batch, configs, write_inductive_fixture
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.query import datasets as qds
from ultra_tpu_torch.query import executor as exe
from ultra_tpu_torch.query import metrics as qmetrics
from ultra_tpu_torch.query import ops
from ultra_tpu_torch.query import trainer
from ultra_tpu_torch.utils import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]
NAMES = ("mrr", "hits@1", "hits@3", "hits@10", "mape", "spearmanr", "auroc")
FROM_NUM_PRED = ("mape", "spearmanr")


def _as_lists(masks):
    return [np.flatnonzero(m) for m in masks]


def _case(name):
    """(pred (B, V) float32, easy masks, hard masks, restrict_nodes)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, v = 6, 50
    pred = rng.standard_normal((b, v)).astype(np.float32)
    easy = rng.random((b, v)) < 0.15
    hard = (rng.random((b, v)) < 0.15) & ~easy
    restrict = None
    if name == "ties":
        pred = rng.integers(0, 4, (b, v)).astype(np.float32)
        pred[0, ::2] = 0.0
        pred[0, 1::2] = -0.0  # equal to numpy, other bits to a radix sort
        pred[1] = 1.5  # one value across the row
    elif name == "restrict_nodes":
        restrict = np.sort(rng.permutation(v)[:30])
        pred[:, :5] = 100.0  # the best scores, some of them on excluded nodes
    elif name == "no_easy_answers":
        easy[::2] = False
        hard[1] = False  # and a row with no hard answer
    elif name == "large_answer_sets":
        b, v = 4, 1200
        pred = rng.standard_normal((b, v)).astype(np.float32)
        easy = rng.random((b, v)) < 0.2
        hard = (rng.random((b, v)) < 0.25) & ~easy
        easy[3] = False
    elif name == "easy_and_hard_overlap":
        hard = rng.random((b, v)) < 0.15  # a node may sit in both sets, as masks allow
    return pred, easy, hard, restrict


@pytest.mark.parametrize("name", ["ties", "restrict_nodes", "no_easy_answers",
                                  "large_answer_sets", "easy_and_hard_overlap"])
def test_batch_evaluate_device_equals_batch_evaluate(name):
    pred, easy, hard, restrict = _case(name)
    want = qmetrics.batch_evaluate(pred, easy, hard, restrict)
    flat, sizes = qmetrics.pack_answers(_as_lists(easy), _as_lists(hard))
    answers = qmetrics.PackedAnswers.split(torch.as_tensor(flat), sizes)
    keep = None
    if restrict is not None:
        keep = torch.zeros(pred.shape[1], dtype=torch.bool)
        keep[torch.as_tensor(restrict)] = True
    got = qmetrics.batch_evaluate_device(torch.as_tensor(pred), answers, keep)
    if name == "large_answer_sets":
        assert want[3].max() >= 200  # answer sets of a few hundred nodes
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)
    # unsorted lists with repeats read as the masks read them
    shuffled = [np.concatenate([a[::-1], a[:2]]) for a in _as_lists(easy)]
    flat2, sizes2 = qmetrics.pack_answers(shuffled, _as_lists(hard))
    np.testing.assert_array_equal(flat2, flat)
    assert sizes2 == sizes


def test_predicted_size_is_the_sum_above_one_half():
    pred = torch.tensor([[0.0, 2.0, -1.0, 0.5], [-3.0, -0.1, -2.0, -4.0]])
    p = 1.0 / (1.0 + np.exp(-pred.double().numpy()))
    want = (p * (p > 0.5)).sum(-1)
    got = qmetrics.predicted_size(pred)
    assert got.dtype == torch.float64 and got[1] == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


def _model(seed=0):
    _, pcfg = configs()
    torch.manual_seed(seed)
    return Ultra(pcfg).eval()


def _host_vectors(model, qcfg, graph, ds, indices, batch_size, restrict_nodes=None):
    """The per-query vectors as the evaluation computed them on the host:
    the logits copied back, ``batch_evaluate`` on (B, V) masks, ``num_pred``
    in numpy float32."""
    fwd = trainer.make_query_forward_grouped(model, qcfg)
    rel = trainer.precompute_relation_representations(model, graph)
    out = [[] for _ in range(6)]
    for start in range(0, len(indices), batch_size):
        take = indices[start:start + batch_size]
        valid = len(take)
        take = np.concatenate([take, np.repeat(take[-1:], batch_size - valid)])
        kind, operand = ops.decompose(ds.queries[take])
        pred = fwd(graph, kind, operand, rel).cpu().numpy()[:valid]
        take = take[:valid]
        easy = trainer.answers_to_mask([ds.easy_answers[i] for i in take], graph.num_nodes)
        hard = trainer.answers_to_mask([ds.hard_answers[i] for i in take], graph.num_nodes)
        prob = 1.0 / (1.0 + np.exp(-pred))
        for k, x in enumerate((*qmetrics.batch_evaluate(pred, easy, hard, restrict_nodes),
                               ds.types[take], (prob * (prob > 0.5)).sum(axis=-1))):
            out[k].append(x)
    return [np.concatenate(x) for x in out]


def _toy():
    """The toy set with every second answer of each query made hard."""
    ds = toy_query_dataset(n_queries=14)
    answers = [np.sort(a) for a in ds.easy_answers]
    ds = ds._replace(easy_answers=[a[::2] for a in answers],
                     hard_answers=[a[1::2] for a in answers])
    (_, _), (_, _), (_, hi) = ds.split_ranges()
    return ds, ds.graphs[2], np.arange(hi)[::-1], 4, None


def _inductive(tmp_path):
    write_inductive_fixture(str(tmp_path))
    ds = qds.build_query_dataset("InductiveFB15k237Query", str(tmp_path), version=9999).load()
    (_, _), (_, _), (lo, hi) = ds.split_ranges()
    return ds, ds.graphs[2], np.arange(lo, hi), 2, ds.graphs[2].restrict_nodes


@pytest.mark.parametrize("fixture", ["toy", "inductive_restricted"])
@pytest.mark.parametrize("threshold", [0.0, 0.8])
def test_evaluate_queries_is_unchanged_against_the_host_ranking(fixture, threshold, tmp_path):
    ds, qg, idx, bs, restrict = _toy() if fixture == "toy" else _inductive(tmp_path)
    model = _model()
    qcfg = exe.QueryConfig(threshold=threshold)
    graph = trainer.prepare_query_graph(qg, device="cpu")
    want = _host_vectors(model, qcfg, graph, ds, idx, bs, restrict)
    got = trainer.rank_queries(model, qcfg, graph, ds, idx, bs, restrict_nodes=restrict)
    assert want[0].size and want[1].size > want[0].size
    for k in range(5):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6, atol=0)

    got_dict = trainer.evaluate_queries(model, qcfg, graph, ds, idx, bs, metric_names=NAMES,
                                        restrict_nodes=restrict)
    want_dict = qmetrics.evaluate(*want, NAMES, ds.id2type)
    assert list(got_dict) == list(want_dict)
    for key, value in want_dict.items():
        if key.split()[-1] in FROM_NUM_PRED:
            np.testing.assert_allclose(got_dict[key], value, rtol=0, atol=1e-6)
        else:
            assert got_dict[key] == value or (np.isnan(value) and np.isnan(got_dict[key])), key


@pytest.fixture
def record_function_calls(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    profiling.counters.clear()
    yield calls
    profiling.counters.clear()


def test_rank_queries_records_its_spans_and_counts_only_under_a_profiler(
        record_function_calls):
    """The toy set's 14 queries in batches of 4: 7 of type 1p (one
    projection), then 7 of type 2i (two); the batches are
    [1p x4], [1p x3, 2i], [2i x4], [2i x2 + 2 padded rows], so 1 + 2 + 2 + 2
    passes and 4 + 5 + 8 + 8 projections. Traced, the vectors are the same
    bit for bit."""
    ds = toy_query_dataset(n_queries=14)
    idx = np.argsort(ds.types, kind="stable")  # 1p, then 2i
    assert ds.types[idx].tolist() == [0] * 7 + [1] * 7
    model = _model(1)
    qcfg = exe.QueryConfig(threshold=0.8)
    graph = trainer.prepare_query_graph(ds.graphs[2], device="cpu")
    plain = trainer.rank_queries(model, qcfg, graph, ds, idx, 4)
    assert record_function_calls == [] and not profiling.counters

    with torch.profiler.profile(activities=CPU) as prof:
        traced = trainer.rank_queries(model, qcfg, graph, ds, idx, 4)
    for want, got in zip(plain, traced):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)
    assert dict(profiling.counters) == {"query_passes": 7, "query_projections": 25}

    spans = [e for e in prof.events() if e.name.startswith("ultra.query.")]
    calls = [e for e in spans if e.name == "ultra.query.rank_queries"]
    assert len(calls) == 1
    got = {}
    for e in spans:
        if e is not calls[0]:
            got[e.name] = got.get(e.name, 0) + 1
            assert e.cpu_parent is calls[0], e.name
    # a batch of n rounds has n + 1 cheap passes and n projections; its
    # answer lists and its program each go up under a schedule span
    assert got == {"ultra.query.precompute": 1, "ultra.query.schedule": 8,
                   "ultra.query.metrics": 4, "ultra.query.download": 1,
                   "ultra.query.cheap": 7 + 4, "ultra.query.project": 7}
    order = [e.name.split(".")[-1] for e in sorted((e for e in spans if e is not calls[0]),
                                                   key=lambda e: e.time_range.start)]
    batch = lambda n: ["schedule"] * 2 + ["cheap", "project"] * n + ["cheap", "metrics"]  # noqa: E731
    assert order == (["precompute"] + batch(1) + batch(2) + batch(2) + batch(2)
                     + ["download"])


def test_execute_grouped_records_its_rounds_only_under_a_profiler(record_function_calls):
    """The serving and training paths share the executor: its spans cost a
    flag check unless a profiler records."""
    ds = toy_query_dataset(n_queries=4)
    model = _model(2)
    graph = trainer.prepare_query_graph(ds.graphs[2], device="cpu")
    fwd = trainer.make_query_forward_grouped(model, exe.QueryConfig())
    kind, operand = ops.decompose(ds.queries[np.arange(4)])
    plain = fwd(graph, kind, operand)
    assert record_function_calls == []
    with torch.profiler.profile(activities=CPU):
        traced = fwd(graph, kind, operand)
    torch.testing.assert_close(traced, plain, rtol=0, atol=0)
    assert record_function_calls == ["ultra.query.schedule"] + [
        "ultra.query.cheap", "ultra.query.project"] * 2 + ["ultra.query.cheap"]
    # the toy set's first four queries: two 1p, two 2i; nothing goes to a card
    assert dict(profiling.counters) == {"query_passes": 2, "query_projections": 6}


def test_cheap_schedule_by_hand():
    """A 3in query, ``e r e r i e r n i stop``: an operand in each of the
    first three passes, the first intersection beside the third operand,
    the negation and the last intersection in the fourth; a 2u query in the
    same batch (``e r e r u stop``) adds its union to the third pass's
    slot 4."""
    three_in = ((0, (1,)), (2, (3,)), (4, (5, -2)))
    two_u = ((6, (1,)), (7, (2,)), (-1,))
    kind, _ = ops.decompose(ops.pad_queries([ops.from_nested(three_in)], 10))
    round_of, _, _, n_rounds = exe.projection_schedule(kind)
    o, i, u, n = ops.K_OPERAND, ops.K_INTERSECTION, ops.K_UNION, ops.K_NEGATION
    want = [[(0, {o})], [(2, {o})], [(4, {i}), (5, {o})], [(7, {n}), (8, {i})]]
    assert exe.cheap_schedule(kind, round_of, n_rounds) == want
    kind, _ = ops.decompose(ops.pad_queries([ops.from_nested(q) for q in (three_in, two_u)],
                                            10))
    round_of, _, _, n_rounds = exe.projection_schedule(kind)
    want[2][0] = (4, {i, u})
    assert exe.cheap_schedule(kind, round_of, n_rounds) == want


@pytest.mark.parametrize("logic", ["product", "godel"])
def test_the_cheap_schedule_changes_no_bit_of_logits_or_gradients(logic):
    """The 14 BetaE types in one batch, with a threshold, under autograd:
    the grouped executor on its cheap schedule and on every slot give the
    same logits and the same gradients of every parameter, bit for bit,
    while the schedule runs under a third of the (pass, slot) pairs."""
    ds = toy_query_dataset()
    graph = trainer.prepare_query_graph(ds.graphs[2], device="cpu")
    query, _ = betae_batch(np.random.default_rng(4), graph.num_nodes, graph.num_relations)
    kind, operand = ops.decompose(query)
    schedule = exe.projection_schedule(kind)
    round_of, has_proj, arg_slot, n_rounds = schedule
    cheap = exe.cheap_schedule(kind, round_of, n_rounds)
    assert sum(map(len, cheap)) * 3 < (n_rounds + 1) * kind.shape[1]
    qcfg = exe.QueryConfig(logic=logic, threshold=0.3, dropout_ratio=0.0)
    model = _model(3).train()
    on = torch.from_numpy
    runs = []
    for plan in (None, cheap):
        model.zero_grad(set_to_none=True)
        pred = exe.execute_grouped(model, qcfg, graph, on(kind), on(operand), on(round_of),
                                   on(has_proj), on(arg_slot), n_rounds, cheap=plan)
        trainer.query_bce_loss(pred, on(trainer.answers_to_mask(
            [ds.easy_answers[0]] * len(kind), graph.num_nodes).astype(np.float32)), 1.0
        ).backward()
        runs.append((pred.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                                     if p.grad is not None}))
    (want, want_grads), (got, got_grads) = runs
    assert torch.equal(got, want)
    assert want_grads and set(got_grads) == set(want_grads)
    for name, grad in want_grads.items():
        assert torch.equal(got_grads[name], grad), name


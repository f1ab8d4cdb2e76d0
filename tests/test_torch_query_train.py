"""UltraQuery training in the port (``tasks.RelGraphMasker``, the host's
symbolic machine and traversal dropout in ``query/executor.py``, the train
steps, ``train_queries`` and ``query/pretrain.py``) against the JAX package
on the CPU, at a small size (2 layers of width 16), from the same weights
and the same numpy inputs.

Tolerances: the masker's weights, the dropped edges and the plans' weights
bit for bit (the same numpy code on one generator). Losses and gradients
within rtol 1e-4 and atol 1e-5 (``test_torch_train.py``'s TOL: f32 sums in
other orders through a few chained projections of 2 conv layers), the
weights after a few AdamW updates within the same bound. Logged epoch
losses are printed with 6 decimals and compared within TOL plus 1e-6;
validation MRR within TOL, or where a toy's scores nearly tie, within
MRR_ATOL.
"""

import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_query_datasets import write_transductive_fixture
from tests.test_query_trainer import toy_query_dataset
from tests.test_torch_query import configs, instantiate, query_graph
from ultra_tpu import tasks as jtasks
from ultra_tpu.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu.query import datasets as jds
from ultra_tpu.query import executor as jexe
from ultra_tpu.query import ops as jops
from ultra_tpu.query import pretrain as jpretrain
from ultra_tpu.query import trainer as jtrainer
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu_torch import tasks
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.query import datasets as qds
from ultra_tpu_torch.query import executor as exe
from ultra_tpu_torch.query import pretrain as qpretrain
from ultra_tpu_torch.query import trainer
from ultra_tpu_torch.train.loop import init_train_state
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
# the 10 BetaE training types (datasets.py DEFAULT_TRAIN_PATTERNS)
TRAIN_TYPES = {t: s for s, t in jds.STRUCT2TYPE.items() if t in qds.DEFAULT_TRAIN_PATTERNS}
# two members' validation MRR over 2 queries each, on 12-node graphs whose
# trained scores of nodes the model cannot tell apart tie or nearly tie
MRR_ATOL = 0.05


def edge_set(ei, et):
    return set(zip(ei[0].tolist(), ei[1].tolist(), et.tolist()))


@pytest.mark.parametrize("seed,shape", [(0, (40, 6, 150)), (1, (200, 12, 1200)),
                                        (2, (90, 3, 400))])
def test_relgraph_masker_matches_jax_and_a_rebuild(seed, shape):
    """Each dropout ratio's mask equals the JAX package's, and its surviving
    relation edges are the relation graph rebuilt from the live edges."""
    v, rr, t = shape
    ei, et = with_inverses(random_kg_triples(v, rr, t, seed=seed), rr)
    r, e = 2 * rr, ei.shape[1]
    base_ei, base_et = tasks.build_relation_graph_arrays(ei, et, v, r)
    masker = tasks.RelGraphMasker(ei, et, v, r)
    jmasker = jtasks.RelGraphMasker(ei, et, v, r, base_ei, base_et)
    np.testing.assert_array_equal(np.stack([masker.rel_src, masker.rel_dst]), base_ei)
    np.testing.assert_array_equal(masker.rel_type, base_et)
    rng = np.random.default_rng(seed + 100)
    for ratio in (0.0, 0.05, 0.3, 0.7, 1.0):
        drop = np.nonzero(rng.random(e) < ratio)[0]
        w = masker.edge_weights(drop)
        np.testing.assert_array_equal(w, jmasker.edge_weights(drop))
        live = np.ones(e, bool)
        live[drop] = False
        ref_ei, ref_et = tasks.build_relation_graph_arrays(ei, et, v, r, live=live)
        assert edge_set(base_ei[:, w > 0], base_et[w > 0]) == edge_set(ref_ei, ref_et)


class Setup:
    """A BetaE-convention query graph in both packages, the host arrays,
    the planners, one batch of every training type twice, and one set of
    weights."""

    def __init__(self):
        self.qg = query_graph()
        self.jcfg, pcfg = configs()
        self.params = jax.device_get(jax_init_ultra_params(self.jcfg, jax.random.key(5)))
        self.model = Ultra(pcfg)
        self.model.load_state_dict(params_from_jax(self.params))
        self.graph = trainer.prepare_query_graph(self.qg, device="cpu")
        self.jgraph = jtrainer.prepare_query_graph(self.qg, with_plans=False)
        self.host = trainer.graph_host(self.qg, self.graph)
        self.jhost = dict(self.host, e_pad=self.jgraph.num_edges_padded)
        self.planner = trainer.dropout_planner(self.host, self.graph)
        self.jplanner = jexe.DropoutPlanner(self.jhost)
        rng = np.random.default_rng(0)
        progs = [jops.from_nested(instantiate(s, rng, self.qg.num_nodes, self.qg.num_relations))
                 for s in list(TRAIN_TYPES.values()) * 2]
        self.kind, self.operand = jops.decompose(
            jops.pad_queries(progs, max(len(p) for p in progs)))
        self.target = (rng.random((len(progs), self.qg.num_nodes)) < 0.1).astype(np.float32)


_SETUP = []


@pytest.fixture
def setup():
    if not _SETUP:
        _SETUP.append(Setup())
    return _SETUP[0]


def assert_same_plan(got, want, e):
    assert len(got.slot_weights) == len(want.slot_weights)
    for w, jw, rw, jrw in zip(got.slot_weights, want.slot_weights, got.slot_rel_graphs,
                              want.slot_rel_graphs):
        assert (w is None) == (jw is None)
        if w is None:
            continue
        np.testing.assert_array_equal(w, jw[:e])
        assert not jw[e:].any()
        np.testing.assert_array_equal(rw, jrw)


@pytest.mark.parametrize("ratio,more", [(0.25, 0.0), (0.5, 0.1)])
def test_traversal_dropout_and_plans_match_jax_bit_for_bit(setup, ratio, more):
    """From one numpy seed: the edges one projection drops, the per-slot
    plan and the per-round plan of a batch of the 10 training types, and
    the symbolic traversal, equal to the JAX package's."""
    s = setup
    qcfg = exe.QueryConfig(dropout_ratio=ratio, more_dropout=more)
    jqcfg = jexe.QueryConfig(dropout_ratio=ratio, more_dropout=more)
    ei, et = s.qg.edge_index, s.qg.edge_type
    e, v = ei.shape[1], s.qg.num_nodes
    rng = np.random.default_rng(3)
    h_sets = rng.random((6, v)) < 0.3
    r_index = rng.integers(0, s.qg.num_relations, 6)
    live = np.ones(e, bool)
    got = exe.traversal_dropout_host(h_sets, r_index, ei, et, live, s.qg.num_relations,
                                     np.random.default_rng(9), ratio, more, True)
    want = jexe.traversal_dropout_host(h_sets, r_index, ei, et, live, s.qg.num_relations,
                                       np.random.default_rng(9), ratio, more, True)
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0
    live[got] = False
    np.testing.assert_array_equal(
        exe.symbolic_traversal_host(h_sets, r_index, ei, et, live),
        jexe.symbolic_traversal_host(h_sets, r_index, ei, et, live))

    plan = exe.simulate_symbolic(s.kind, s.operand, s.host, qcfg, np.random.default_rng(42),
                                 planner=s.planner)
    jplan = jexe.simulate_symbolic(s.kind, s.operand, s.jhost, jqcfg,
                                   np.random.default_rng(42), planner=s.jplanner)
    assert_same_plan(plan, jplan, e)
    assert any((w < 1).any() for w in plan.slot_weights if w is not None)
    # the planner is built when not given; no dropout without training
    assert_same_plan(exe.simulate_symbolic(s.kind, s.operand, s.host, qcfg,
                                           np.random.default_rng(42)), jplan, e)
    idle = exe.simulate_symbolic(s.kind, s.operand, s.host, qcfg, np.random.default_rng(42),
                                 training=False, planner=s.planner)
    assert all(w.all() for w in idle.slot_weights if w is not None)

    schedule = exe.projection_schedule(s.kind)
    plan = exe.simulate_symbolic_grouped(s.kind, s.operand, *schedule, s.host, qcfg,
                                         np.random.default_rng(42), s.planner)
    jplan = jexe.simulate_symbolic_grouped(s.kind, s.operand, *schedule, s.jhost, jqcfg,
                                           np.random.default_rng(42), s.jplanner)
    assert len(plan.slot_weights) == schedule[3] == 3
    assert_same_plan(plan, jplan, e)


def test_graphs_for_slots_share_the_base_layouts(setup):
    s = setup
    plan = exe.simulate_symbolic(s.kind, s.operand, s.host, exe.QueryConfig(),
                                 np.random.default_rng(1), planner=s.planner)
    graphs = exe.graphs_for_slots(s.graph, plan)
    for g, w, rw in zip(graphs, plan.slot_weights, plan.slot_rel_graphs):
        if w is None:
            assert g is s.graph
            continue
        assert g.csr is s.graph.csr and g.segments is s.graph.segments
        assert g.relation_graph.csr is s.graph.relation_graph.csr
        np.testing.assert_array_equal(g.edge_weight.numpy(), w)
        np.testing.assert_array_equal(g.relation_graph.edge_weight.numpy(), rw)


@pytest.mark.parametrize("temperature", [0.0, 0.2, 1.0])
def test_query_bce_loss_matches_jax(temperature):
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(5, 30)).astype(np.float32) * 3
    target = (rng.random((5, 30)) < 0.2).astype(np.float32)
    target[0] = 0.0  # a query with no positive
    got = trainer.query_bce_loss(torch.from_numpy(pred), torch.from_numpy(target), temperature)
    want = jtrainer.query_bce_loss(jnp.asarray(pred), jnp.asarray(target), temperature)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def _jax_loss_and_grads(s, jqcfg, graphs, rows_list, grouped, temperature=1.0):
    """The JAX loss and gradients of one step: the mean over micro-batches
    ``rows_list`` of jax.value_and_grad of the JAX loss."""

    def loss_fn(params, rows):
        kind, operand = s.kind[rows], s.operand[rows]
        if grouped:
            round_of, has_proj, arg_slot, n_rounds = jexe.projection_schedule(kind)
            pred = jexe.execute_grouped(params, s.jcfg, jqcfg, graphs[:n_rounds],
                                        jnp.asarray(kind), jnp.asarray(operand),
                                        jnp.asarray(round_of), jnp.asarray(has_proj),
                                        jnp.asarray(arg_slot), n_rounds)
        else:
            pred = jexe.execute(params, s.jcfg, jqcfg, graphs, jnp.asarray(kind),
                                jnp.asarray(operand))
        return jtrainer.query_bce_loss(pred, jnp.asarray(s.target[rows]), temperature)

    params = jax.tree.map(jnp.asarray, s.params)
    losses, grads = [], []
    for rows in rows_list:
        loss, g = jax.value_and_grad(loss_fn)(params, rows)
        losses.append(float(loss))
        grads.append(params_from_jax(jax.device_get(g)))
    return (float(np.mean(losses)),
            {k: sum(g[k] for g in grads) / len(grads) for k in grads[0]})


@pytest.mark.parametrize("grouped,accum", [(False, 1), (True, 1), (True, 2)],
                         ids=["per-slot", "grouped", "grouped-accum2"])
def test_train_step_loss_and_gradients_match_jax(setup, grouped, accum):
    """One port step on a plan (per slot, or per round with ``grad_accum``
    1 and 2) against jax.value_and_grad of the JAX loss on the same plan:
    the loss, and every gradient it leaves in ``.grad``. The stack is
    written in place under autograd; this holds its gradients."""
    s = setup
    qcfg = exe.QueryConfig(dropout_ratio=0.5)
    jqcfg = jexe.QueryConfig(dropout_ratio=0.5)
    rng, jrng = np.random.default_rng(8), np.random.default_rng(8)
    if grouped:
        schedule = exe.projection_schedule(s.kind)
        plan = exe.simulate_symbolic_grouped(s.kind, s.operand, *schedule, s.host, qcfg, rng,
                                             s.planner)
        jplan = jexe.simulate_symbolic_grouped(s.kind, s.operand, *schedule, s.jhost, jqcfg,
                                               jrng, s.jplanner)
        step = trainer.make_grouped_query_train_step(qcfg, 1.0, grad_accum=accum)
    else:
        plan = exe.simulate_symbolic(s.kind, s.operand, s.host, qcfg, rng, planner=s.planner)
        jplan = jexe.simulate_symbolic(s.kind, s.operand, s.jhost, jqcfg, jrng,
                                       planner=s.jplanner)
        step = trainer.make_query_train_step(qcfg, 1.0)
    model = Ultra(s.model.cfg)
    model.load_state_dict(s.model.state_dict())
    state = init_train_state(model)
    loss = step(state, exe.graphs_for_slots(s.graph, plan), s.kind, s.operand, s.target)
    assert state.step == 1

    rows = np.split(np.arange(len(s.kind)), accum)
    want_loss, want_grads = _jax_loss_and_grads(s, jqcfg, jexe.graphs_for_slots(s.jgraph, jplan),
                                                rows, grouped)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), err_msg=k, **TOL)


def test_grouped_accum_equals_the_full_batch(setup):
    """``grad_accum`` 2 on the grouped step gives the full batch's loss and
    gradients (micro-batches share the round graphs)."""
    s = setup
    qcfg = exe.QueryConfig(dropout_ratio=0.5)
    schedule = exe.projection_schedule(s.kind)
    plan = exe.simulate_symbolic_grouped(s.kind, s.operand, *schedule, s.host, qcfg,
                                         np.random.default_rng(2), s.planner)
    graphs = exe.graphs_for_slots(s.graph, plan)
    out = []
    for accum in (1, 2, 3):  # gcd(20, 3) = 1: the full batch
        model = Ultra(s.model.cfg)
        model.load_state_dict(s.model.state_dict())
        state = init_train_state(model)
        loss = trainer.make_grouped_query_train_step(qcfg, 1.0, grad_accum=accum)(
            state, graphs, s.kind, s.operand, s.target)
        out.append((float(loss), {k: p.grad.clone() for k, p in model.named_parameters()}))
    for loss, grads in out[1:]:
        np.testing.assert_allclose(loss, out[0][0], rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), out[0][1][k].numpy(), err_msg=k, **TOL)


def _port_dataset(ds):
    """A JAX QueryDataset as the port's record."""
    return qds.QueryDataset(ds.name, tuple(qds.QueryGraph(*g) for g in ds.graphs),
                            *ds[2:])


def _logged(caplog, pattern):
    return [float(x) for x in re.findall(pattern, caplog.text)]


@pytest.mark.parametrize("grouped", [False, True], ids=["per-slot", "grouped"])
def test_train_queries_matches_jax(tmp_path, caplog, grouped):
    """``train_queries`` for 1 epoch of 3 steps against the JAX package's
    from the same weights and seed: the logged epoch loss, the validation
    MRR and the weights it returns."""
    ds = toy_query_dataset(seed=1, n_queries=16)
    jcfg, pcfg = configs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(2)))
    model = Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    cfg = {"train": {"batch_size": 4, "num_epoch": 1, "batch_per_epoch": 3,
                     "grouped_projections": grouped},
           "task": {"adversarial_temperature": 0.2}, "optimizer": {"lr": 1e-3}}
    with caplog.at_level(logging.WARNING):
        out = trainer.train_queries(cfg, model, exe.QueryConfig(dropout_ratio=0.25),
                                    _port_dataset(ds), str(tmp_path / "port"), seed=0)
        port_log = caplog.text
        caplog.clear()
        jout = jtrainer.train_queries(cfg, jcfg, jexe.QueryConfig(dropout_ratio=0.25), params,
                                      ds, str(tmp_path / "jax"), seed=0)
        jax_log = caplog.text
    for pattern in (r"avg bce ([0-9.]+)", r"valid after epoch 0: mrr ([0-9.]+)"):
        got = [float(x) for x in re.findall(pattern, port_log)]
        want = [float(x) for x in re.findall(pattern, jax_log)]
        assert len(got) == len(want) == 1, pattern
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 + 1e-6)
    final = params_from_jax(jax.device_get(jout))
    for k, v in out.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k, **TOL)
    assert sorted(os.listdir(tmp_path / "port")) == ["model_epoch_1.pth", "model_latest.pth"]


def test_train_queries_resumes_and_refuses_data_parallel(tmp_path, monkeypatch):
    ds = _port_dataset(toy_query_dataset(seed=1, n_queries=16))
    _, pcfg = configs()
    cfg = {"train": {"batch_size": 4, "num_epoch": 1, "batch_per_epoch": 2},
           "task": {"adversarial_temperature": 0.2}, "optimizer": {"lr": 1e-3}}
    qcfg = exe.QueryConfig()
    fresh = lambda: Ultra(pcfg)  # noqa: E731
    monkeypatch.setenv("ULTRA_RESUME_FROM", str(tmp_path / "missing.pth"))
    trainer.train_queries(cfg, fresh(), qcfg, ds, str(tmp_path / "a"))
    latest = str(tmp_path / "a" / "model_latest.pth")
    assert torch.load(latest, weights_only=True)["step"] == 2
    monkeypatch.setenv("ULTRA_RESUME_FROM", latest)
    trainer.train_queries(cfg, fresh(), qcfg, ds, str(tmp_path / "b"))
    assert torch.load(tmp_path / "b" / "model_latest.pth", weights_only=True)["step"] == 4
    monkeypatch.delenv("ULTRA_RESUME_FROM")
    trainer.train_queries(dict(cfg, resume_from=latest), fresh(), qcfg, ds,
                          str(tmp_path / "c"))
    assert torch.load(tmp_path / "c" / "model_latest.pth", weights_only=True)["step"] == 4
    # per-rank dropout without data parallelism is refused, as the JAX
    # package asserts; data parallelism without a process group is one rank:
    # the plain run's weights
    with pytest.raises(ValueError, match="requires train.data_parallel"):
        trainer.train_queries({**cfg, "task": {"per_rank_traversal_dropout": True}}, fresh(),
                              qcfg, ds, str(tmp_path / "d"))
    start = fresh().state_dict()
    out = []
    for name, train in (("e", cfg["train"]), ("f", dict(cfg["train"], data_parallel=True))):
        model = fresh()
        model.load_state_dict(start)
        out.append(trainer.train_queries({**cfg, "train": train}, model, qcfg, ds,
                                         str(tmp_path / name), seed=3).state_dict())
    for k, v in out[0].items():
        assert torch.equal(v, out[1][k]), k


def _fixture_members(root, monkeypatch):
    """Two BetaE fixture members registered in both packages' mixtures."""
    for name in ("toy-a-betae", "toy-b-betae"):
        write_transductive_fixture(root, name=name)
    for module, base in ((qds, qds.LogicalQueryDataset), (jds, jds.LogicalQueryDataset)):
        for key, name in (("TA", "toy-a-betae"), ("TB", "toy-b-betae")):
            monkeypatch.setitem(module.JointQueryDataset.datasets_map, key,
                                type(key, (base,), {"name": name}))


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "per-slot"])
def test_pretrain_queries_matches_jax(tmp_path, caplog, monkeypatch, grouped):
    """``pretrain_queries`` on two fixture members
    (``write_transductive_fixture``) against the JAX package's: the same
    member and loss at every step, the validation MRR and the weights."""
    root = str(tmp_path / "q")
    _fixture_members(root, monkeypatch)
    got_ds = qds.build_query_dataset("JointQueryDataset", root, graphs=["TA", "TB"]).load()
    want_ds = jds.build_query_dataset("JointQueryDataset", root, graphs=["TA", "TB"]).load()
    assert len(got_ds) == len(want_ds) == 2
    jcfg, pcfg = configs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(6)))
    model = Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    cfg = {"train": {"batch_size": 2, "num_epoch": 1, "batch_per_epoch": 4, "log_interval": 1,
                     "grouped_projections": grouped},
           "task": {"adversarial_temperature": 0.2}, "optimizer": {"lr": 1e-3}}
    with caplog.at_level(logging.WARNING):
        out = qpretrain.pretrain_queries(cfg, model, exe.QueryConfig(),
                                         qpretrain.QueryPretrainGraphs(got_ds, device="cpu"),
                                         str(tmp_path / "port"), seed=3)
        port_log = caplog.text
        caplog.clear()
        jout = jpretrain.pretrain_queries(cfg, jcfg, jexe.QueryConfig(), params,
                                          jpretrain.QueryPretrainGraphs(want_ds),
                                          str(tmp_path / "jax"), seed=3)
        jax_log = caplog.text
    step = r"step \d+ \[([\w-]+)\] loss ([0-9.]+)"
    got, want = re.findall(step, port_log), re.findall(step, jax_log)
    assert [m for m, _ in got] == [m for m, _ in want] and len(got) == 4
    assert len({m for m, _ in got}) == 2, "both members should be drawn"
    np.testing.assert_allclose([float(x) for _, x in got], [float(x) for _, x in want],
                               rtol=1e-4, atol=1e-5 + 1e-6)
    mrr = r"avg valid mrr after epoch 0: ([0-9.]+)"
    np.testing.assert_allclose([float(x) for x in re.findall(mrr, port_log)],
                               [float(x) for x in re.findall(mrr, jax_log)], rtol=0,
                               atol=MRR_ATOL)
    final = params_from_jax(jax.device_get(jout))
    for k, v in out.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k, **TOL)


def _tree(root):
    """{relative path: file bytes (text) or unpickled object} under ``root``."""
    import pickle

    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = (pickle.load(fh) if f.endswith(".pkl")
                                                    else fh.read())
    return out


def test_write_betae_dataset_matches_jax(tmp_path):
    """One seed writes the same BetaE directory from both packages, which
    both loaders read as the same dataset."""
    from tests.test_torch_query import assert_same_query_dataset
    from ultra_tpu.data.synthetic_queries import write_betae_dataset as jax_write
    from ultra_tpu_torch.data.synthetic_queries import write_betae_dataset

    keys = dict(name="FB15k-237-betae", num_nodes=150, num_direct_rel=6, num_triples=900,
                queries_per_type=4, train_queries_per_type=6, seed=3, categories=4)
    assert write_betae_dataset(str(tmp_path / "port"), **keys) == \
        jax_write(str(tmp_path / "jax"), **keys)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 13
    for k in got:
        assert got[k] == want[k], k
    assert_same_query_dataset(
        qds.build_query_dataset("FB15k237LogicalQuery", str(tmp_path / "port")).load(),
        jds.build_query_dataset("FB15k237LogicalQuery", str(tmp_path / "jax")).load())


def test_gen_query_mixture_cli_matches_jax(tmp_path):
    """``scripts/torch_gen_query_mixture.py --tiny`` writes the files
    ``scripts/gen_query_mixture.py --tiny`` writes."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for script, out in (("gen_query_mixture.py", "jax"), ("torch_gen_query_mixture.py", "port")):
        proc = subprocess.run([sys.executable, os.path.join(repo, "scripts", script), "--root",
                               str(tmp_path / out), "--tiny", "--seed", "2"],
                              capture_output=True, text=True, timeout=600, cwd=repo,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 39
    for k in got:
        assert got[k] == want[k], k

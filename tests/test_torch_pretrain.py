"""Pretraining on a mixture of graphs in the port (``data/synthetic.py::
rule_kg_dataset``, ``data/kg.py::JointDataset``, ``train/pretrain.py``,
``scripts/torch_pretrain.py``) against the JAX package on the CPU, at a
small size (2-3 layers of width 16-32).

Tolerances: datasets, member draws and batches exactly (the same numpy
code on one generator). Per-step losses within rtol 1e-4 and atol 1e-5,
and the final weights within the same bound (``test_torch_train.py``'s
TOL): f32 sums in other orders through stacked layers and a few AdamW
updates. The command lines' logged losses are printed with 6 decimals, so
they agree to within 2e-6 of the rounding; their valid MRR within
MRR_ATOL (near ties on toy graphs, below). The transfer twin is a
threshold on held-out MRR, as the JAX package's own gate.
"""

import logging
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_data import assert_same_dataset
from ultra_tpu.data import kg as jkg
from ultra_tpu.data.synthetic import rule_kg_dataset as jax_rule_kg_dataset
from ultra_tpu.models import nbfnet as jnbf
from ultra_tpu.train import pretrain as jpretrain
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu.utils import ckpt as jckpt
from ultra_tpu_torch import tasks
from ultra_tpu_torch.data import kg
from ultra_tpu_torch.data.synthetic import rule_kg_dataset
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.train import eval as eval_lib
from ultra_tpu_torch.train import pretrain
from ultra_tpu_torch.train.loop import init_train_state, init_ultra_params, make_train_step
from ultra_tpu_torch.train.runner import prepare_graph, triples_of
from ultra_tpu_torch.utils.torch_ckpt import load_ultra_checkpoint, params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_KEYS = dict(num_nodes=300, num_base_rel=6, num_comp_rel=3, num_base_triples=1200,
                seed=2, categories=4)


def _cfgs(dim=16, layers=2):
    def nb(mod, **kw):
        return mod.NBFNetConfig(input_dim=dim, hidden_dims=(dim,) * layers, **kw)

    return (jnbf.UltraConfig(relation_model=nb(jnbf, num_relation=4),
                             entity_model=nb(jnbf, num_relation=1, project_relations=True)),
            nbfnet.UltraConfig(relation_model=nb(nbfnet, num_relation=4),
                               entity_model=nb(nbfnet, num_relation=1, project_relations=True)))


def write_toy(root, name, seed):
    """Raw files of a small transductive graph (the JAX package's
    ``tests/test_pretrain.py::make_toy``)."""
    rng = np.random.default_rng(seed)
    lines = set()
    while len(lines) < 60:
        h, t = rng.choice(15, 2, replace=False)
        lines.add(f"{name}{h} r{rng.integers(0, 3)} {name}{t}")
    lines = sorted(lines)
    raw = os.path.join(root, name, "raw")
    os.makedirs(raw, exist_ok=True)
    for fname, part in (("train.txt", lines[:40]), ("valid.txt", lines[40:50]),
                        ("test.txt", lines[50:])):
        with open(os.path.join(raw, fname), "w") as f:
            f.write("\n".join(part) + "\n")


def toy_class(module, name):
    return type(name.upper(), (module.TransductiveDataset,), {"name": name, "urls": ()})


@pytest.mark.parametrize("seed", [0, 3])
def test_rule_kg_dataset_matches_jax(seed):
    keys = dict(num_nodes=250, num_base_rel=8, num_comp_rel=4, num_base_triples=1100,
                seed=seed)
    assert_same_dataset(rule_kg_dataset("g", **keys), jax_rule_kg_dataset("g", **keys))


def test_joint_dataset_matches_jax(tmp_path, monkeypatch):
    """A mixture of a named member and a parameterised SyntheticRuleKG, each
    package on its own root: the same members in order."""
    members = ["TOYA", {"class": "SyntheticRuleKG", **TOY_KEYS}]
    for side in ("port", "jax"):
        write_toy(str(tmp_path / side), "toya", seed=1)
    monkeypatch.setitem(kg.JointDataset.datasets_map, "TOYA", toy_class(kg, "toya"))
    monkeypatch.setitem(jkg.JointDataset.datasets_map, "TOYA", toy_class(jkg, "toya"))
    got = kg.build_dataset("JointDataset", str(tmp_path / "port"), graphs=members).load()
    want = jkg.build_dataset("JointDataset", str(tmp_path / "jax"), graphs=members).load()
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert_same_dataset(a, b)
    assert set(kg.DATASETS) == set(jkg.DATASETS)
    assert set(kg.JointDataset.datasets_map) == set(jkg.JointDataset.datasets_map)


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """Two toy members in both packages: (port datasets, JAX datasets)."""
    root = tmp_path_factory.mktemp("members")
    out = {}
    for side, module in (("port", kg), ("jax", jkg)):
        datasets = []
        for name, seed in (("ga", 1), ("gb", 2)):
            write_toy(str(root / side), name, seed)
            datasets.append(toy_class(module, name)(str(root / side)).load())
        out[side] = datasets
    return out["port"], out["jax"]


def test_graph_probs_and_graphs_match_jax(members):
    port, ref = members
    got = pretrain.PretrainGraphs(port, device="cpu")
    want = jpretrain.PretrainGraphs(ref, with_plans=False)
    np.testing.assert_array_equal(got.graph_probs, want.graph_probs)
    assert abs(got.graph_probs.sum() - 1.0) < 1e-12
    for a, b in zip(got.train_triples, want.train_triples):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.train_graphs, want.train_graphs):
        assert a.num_edges_padded == b.num_edges_padded
        np.testing.assert_array_equal(a.edge_index.numpy(), np.asarray(b.edge_index))
    for a, b in zip(got.filtered, want.filtered):
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_array_equal(a.edge_type, b.edge_type)


CFG = {"train": {"batch_size": 4, "num_epoch": 1, "batch_per_epoch": 6, "fast_test": 5,
                 "log_interval": 1},
       "task": {"num_negative": 4, "strict_negative": True, "adversarial_temperature": 1},
       "optimizer": {"lr": 1e-3}}


def member_of(graphs, graph):
    return next(i for i, g in enumerate(graphs.train_graphs) if g is graph)


def _record_port_steps(monkeypatch, graphs, record):
    real = pretrain.make_train_step

    def make(**kw):
        step = real(**kw)

        def recorded(state, graph, batch, ew):
            loss = step(state, graph, batch, ew)
            record.append((member_of(graphs, graph), float(loss)))
            return loss

        return recorded

    monkeypatch.setattr(pretrain, "make_train_step", make)


def test_pretrain_matches_jax(members, tmp_path, monkeypatch):
    """``pretrain`` against the JAX package's on two toy members from the
    same weights and seed: the same member at every step, each step's loss,
    and the weights it returns."""
    port, ref = members
    jcfg, pcfg = _cfgs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0)))
    model = nbfnet.Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))

    graphs = pretrain.PretrainGraphs(port, device="cpu")
    jgraphs = jpretrain.PretrainGraphs(ref, with_plans=False)
    got, want = [], []
    _record_port_steps(monkeypatch, graphs, got)
    real = jpretrain.make_train_step

    def make_jax(*a, **kw):
        step = real(*a, **kw)

        def recorded(state, graph, batch, ew):
            state, loss = step(state, graph, batch, ew)
            want.append((member_of(jgraphs, graph), float(loss)))
            return state, loss

        return recorded

    monkeypatch.setattr(jpretrain, "make_train_step", make_jax)
    out = pretrain.pretrain(CFG, model, graphs, str(tmp_path / "port"), seed=0)
    jout = jpretrain.pretrain(CFG, jcfg, params, jgraphs, str(tmp_path / "jax"), seed=0)

    assert [g for g, _ in got] == [g for g, _ in want]
    assert len(set(g for g, _ in got)) == 2, "both members should be drawn"
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want], **TOL)
    final = params_from_jax(jax.device_get(jout))
    for k, v in out.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k, **TOL)
    assert sorted(os.listdir(tmp_path / "port")) == ["model_epoch_1.pth", "model_latest.pth"]


def test_pretrain_resumes_from_model_latest(members, tmp_path, monkeypatch):
    """An epoch writes ``model_latest.pth``; a run with
    ``$ULTRA_RESUME_FROM`` naming it starts from its weights, optimizer and
    step count (a missing file is ignored), and ``resume_from`` wins."""
    port, _ = members
    _, pcfg = _cfgs()
    graphs = pretrain.PretrainGraphs(port, device="cpu")
    fresh = lambda s: init_ultra_params(pcfg, torch.Generator().manual_seed(s), device="cpu")
    monkeypatch.setenv("ULTRA_RESUME_FROM", str(tmp_path / "missing.pth"))
    pretrain.pretrain(CFG, fresh(0), graphs, str(tmp_path / "a"), seed=0)
    latest = str(tmp_path / "a" / "model_latest.pth")
    first = torch.load(latest, weights_only=True)
    assert first["step"] == CFG["train"]["batch_per_epoch"]

    monkeypatch.setenv("ULTRA_RESUME_FROM", latest)
    losses = []
    _record_port_steps(monkeypatch, graphs, losses)
    pretrain.pretrain(CFG, fresh(1), graphs, str(tmp_path / "b"), seed=5)
    again = torch.load(tmp_path / "b" / "model_latest.pth", weights_only=True)
    assert again["step"] == 2 * CFG["train"]["batch_per_epoch"]

    # the resumed run's first step is a step from the checkpoint's weights
    monkeypatch.delenv("ULTRA_RESUME_FROM")
    model = fresh(1)
    model.load_state_dict(first["model"])
    rng = np.random.default_rng(5)
    gi, batch, ew = graphs.sample(rng, 4, 4, True, False)
    state = init_train_state(model, lr=1e-3)
    state.optimizer.load_state_dict(first["optimizer"])
    loss = make_train_step(num_negative=4)(state, graphs.train_graphs[gi],
                                           torch.as_tensor(batch), torch.as_tensor(ew))
    assert losses[0] == (gi, float(loss))


@pytest.mark.parametrize("bpe", [0, None], ids=["zero", "null"])
def test_pretrain_batch_per_epoch_zero_or_null_as_jax(members, tmp_path, caplog, bpe):
    """``batch_per_epoch: 0`` takes no step: the epoch's logged loss is nan
    and the weights come back as they went in, as from the JAX package's
    ``pretrain``. ``None`` (``--bpe null``) raises ``ValueError`` naming
    ``--bpe``, where the JAX package raises ``TypeError``."""
    port, ref = members
    jcfg, pcfg = _cfgs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0)))
    model = nbfnet.Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    cfg = dict(CFG, train=dict(CFG["train"], batch_per_epoch=bpe))
    graphs = pretrain.PretrainGraphs(port, device="cpu")
    jgraphs = jpretrain.PretrainGraphs(ref, with_plans=False)
    if bpe is None:
        with pytest.raises(ValueError, match="--bpe"):
            pretrain.pretrain(cfg, model, graphs, str(tmp_path / "port"), seed=0)
        with pytest.raises(TypeError):
            jpretrain.pretrain(cfg, jcfg, params, jgraphs, str(tmp_path / "jax"), seed=0)
        return
    with caplog.at_level(logging.WARNING):
        out = pretrain.pretrain(cfg, model, graphs, str(tmp_path / "port"), seed=0)
        port_log = caplog.text
        caplog.clear()
        jout = jpretrain.pretrain(cfg, jcfg, params, jgraphs, str(tmp_path / "jax"), seed=0)
        jax_log = caplog.text
    for log in (port_log, jax_log):
        assert re.findall(r"epoch 0: avg bce (\S+)", log) == ["nan"]
        assert " step " not in log
    start, final = params_from_jax(params), params_from_jax(jax.device_get(jout))
    for k, v in out.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), start[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(final[k].numpy(), start[k].numpy(), err_msg=k)


def _cli_config(tmp_path, root, ckpt):
    cfg_file = tmp_path / "p.yaml"
    cfg_file.write_text(f"""
output_dir: {tmp_path}/out
dataset:
  class: JointDataset
  graphs: [GA, GB]
  root: {root}
model:
  relation_model: {{input_dim: 16, hidden_dims: [16, 16]}}
  entity_model: {{input_dim: 16, hidden_dims: [16, 16]}}
task:
  name: MultiGraphPretraining
  num_negative: 4
  strict_negative: yes
  adversarial_temperature: 1
optimizer: {{lr: 1.0e-3}}
train:
  batch_size: 4
  num_epoch: {{{{ epochs }}}}
  batch_per_epoch: {{{{ bpe }}}}
  log_interval: 1
  fast_test: 5
checkpoint: {ckpt}
""")
    return cfg_file


def _launcher(tmp_path, package, script, cfg_file, extra=()):
    """A launcher script that registers the two toy members in ``package``'s
    ``JointDataset`` and runs ``script`` with the config."""
    prelude = "import tests.conftest\n" if package == "ultra_tpu" else ""
    launcher = tmp_path / f"{script}.launch.py"
    launcher.write_text(f"""
import sys
sys.path.insert(0, {REPO!r})
{prelude}from {package}.data import kg

for name in ("ga", "gb"):
    kg.JointDataset.datasets_map[name.upper()] = type(
        name.upper(), (kg.TransductiveDataset,), {{"name": name, "urls": ()}})
sys.argv = ["{script}", "-c", {str(cfg_file)!r}, "--epochs", "1", "--bpe", "5",
            *{list(extra)!r}]
exec(open({os.path.join(REPO, "scripts", script)!r}).read())
""")
    return launcher


# The command lines' valid MRR averages 2 members x 5 triples x 2
# directions on 15-node graphs, where a trained model's scores of nodes it
# cannot tell apart tie or nearly tie: one rank moved by one among them
# moves the average by at most 1 / 20 * (1 - 1/2) = 0.025
MRR_ATOL = 0.025


def test_pretrain_cli_matches_jax(members, tmp_path):
    """``scripts/torch_pretrain.py --device cpu`` against
    ``scripts/pretrain.py``, each in its own process from one ``.pth``: the
    same logged loss at every step and valid MRR, final weights within TOL;
    the port writes ``model_latest.pth`` and ``model_final.pth``."""
    root = str(tmp_path / "kg")
    for name, seed in (("ga", 1), ("gb", 2)):
        write_toy(root, name, seed)
    jcfg, _ = _cfgs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(4)))
    ckpt = str(tmp_path / "init.pth")
    torch.save({"model": params_from_jax(params)}, ckpt)
    cfg_file = _cli_config(tmp_path, root, ckpt)

    logs = {}
    for tag, package, script, extra in (
        ("jax", "ultra_tpu", "pretrain.py", ()),
        ("port", "ultra_tpu_torch", "torch_pretrain.py", ("--device", "cpu")),
    ):
        env = dict(os.environ, ULTRA_WORKDIR=str(tmp_path / tag))
        env.pop("ULTRA_RESUME_FROM", None)
        proc = subprocess.run([sys.executable, str(_launcher(tmp_path, package, script,
                                                           cfg_file, extra))],
                              capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        logs[tag] = proc.stderr

    def numbers(pattern, text):
        return [float(x) for x in re.findall(pattern, text)]

    for pattern, atol in ((r"epoch 0 step \d+ loss ([0-9.]+)", 2e-6),
                          (r"avg valid mrr after epoch 0: ([0-9.]+)", MRR_ATOL)):
        got, want = numbers(pattern, logs["port"]), numbers(pattern, logs["jax"])
        assert len(got) == len(want) > 0, pattern
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    assert {"model_latest.pth", "model_final.pth"} <= set(os.listdir(tmp_path / "port"))
    final = params_from_jax(jckpt.load_model_checkpoint(str(tmp_path / "jax" / "model_final")))
    for k, v in load_ultra_checkpoint(str(tmp_path / "port" / "model_final.pth")).items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k, **TOL)


def _holdout_mrr(model, ds, limit=120):
    splits = (ds.train, ds.valid, ds.test)
    filt = tasks.GraphIndex.build(
        np.concatenate([s.target_edge_index for s in splits], axis=1),
        np.concatenate([s.target_edge_type for s in splits]),
        ds.test.num_nodes, ds.test.num_relations)
    return eval_lib.evaluate(model, prepare_graph(ds.test, device="cpu"), triples_of(ds.test),
                             filt, batch_size=8, metrics=("mrr",), limit=limit,
                             rng=np.random.default_rng(0))["mrr"]


@pytest.fixture
def two_threads():
    """Torch on 2 threads: this test's small ops spend most of their time
    waiting on a thread pool that other test processes share (a run took
    300 s with one thread a core beside five other workers, 24 s alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_pretraining_transfers_zero_shot(two_threads):
    """The twin of the JAX package's transfer gate
    (``tests/test_transfer.py::test_pretraining_transfers_zero_shot``):
    150 steps on two rule-KGs must raise filtered MRR on a held-out rule-KG
    with a vocabulary of its own, from about 0.04 to above 0.25."""
    _, pcfg = _cfgs(dim=32, layers=3)
    mix = [rule_kg_dataset("mix0", num_nodes=300, num_base_rel=12, num_comp_rel=6,
                           num_base_triples=1400, seed=0),
           rule_kg_dataset("mix1", num_nodes=250, num_base_rel=8, num_comp_rel=4,
                           num_base_triples=1100, seed=2)]
    held = rule_kg_dataset("held", num_nodes=350, num_base_rel=14, num_comp_rel=7,
                           num_base_triples=1600, seed=10)
    graphs = pretrain.PretrainGraphs(mix, device="cpu")
    state = init_train_state(init_ultra_params(pcfg, torch.Generator().manual_seed(42),
                                               device="cpu"), lr=5e-4)
    step = make_train_step(adversarial_temperature=1.0, num_negative=32)
    rng = np.random.default_rng(7)

    untrained = _holdout_mrr(state.model, held)
    for _ in range(150):
        gi, batch, ew = graphs.sample(rng, 16, 32, True, False)
        step(state, graphs.train_graphs[gi], torch.as_tensor(batch), torch.as_tensor(ew))
    trained = _holdout_mrr(state.model, held)
    assert trained > untrained + 0.12, (untrained, trained)
    assert trained > 0.25, trained

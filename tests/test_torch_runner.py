"""The port's link-prediction entry point (``ultra_tpu_torch/train/runner.py``
``run_link_prediction``, ``build_filtered_index``, ``default_metrics``) and
its command lines (``scripts/torch_run.py``, ``scripts/torch_run_many.py``)
against the JAX package's, on toy datasets written to a temporary directory
in the real classes' layouts: FB15k237 (transductive), FBIngram (InGram's
inductive layout, filtered on the inference graph) and HM (validation on
the training graph with nodes no edge touches).

Tolerances: filters and CSV rows are integer and string work and must be
equal. Metrics come from integer ranks; before comparing them a case checks
that the two packages' scores differ by less than 1e-5 (delta) and that no
candidate it counts lies within 2 * delta of its positive, so rounding
cannot flip a rank, and then the metrics (the same float64 arithmetic on
equal ranks) must be equal to rtol 1e-12.
"""

import ast
import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu.data import kg as jkg
from ultra_tpu.models import nbfnet as jnbf
from ultra_tpu.train import runner as jrunner
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu.utils.torch_ckpt import export_ultra_checkpoint
from ultra_tpu_torch import tasks
from ultra_tpu_torch.data import kg
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.train import runner
from ultra_tpu_torch.utils import ckpt

from tests.test_torch_inductive import write_inductive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16
MODEL = {"class": "Ultra",
         "relation_model": {"class": "RelNBFNet", "input_dim": D, "hidden_dims": [D, D]},
         "entity_model": {"class": "EntityNBFNet", "input_dim": D, "hidden_dims": [D, D]}}
METRICS = ["mr", "mrr", "hits@1", "hits@3", "hits@10"]
# (class, constructor keys, task): one toy of each filter branch
DATASETS = {
    "transductive": ("FB15k237", {}, "TransductiveInference"),
    "inference": ("FBIngram", {"version": "toy"}, "InductiveInference"),
    "inductive": ("HM", {"version": "1k"}, "InductiveInference"),
}


def write_transductive(root, seed=0):
    """FB15k237's three raw files: 60 triples over 20 entities and 3
    relations, a 40/10/10 split."""
    rng = np.random.default_rng(seed)
    lines = set()
    while len(lines) < 60:
        h, t = rng.choice(20, 2, replace=False)
        lines.add(f"n{h} r{rng.integers(3)} n{t}")
    lines = sorted(lines)
    raw = os.path.join(root, "fb15k237", "raw")
    os.makedirs(raw)
    for name, part in (("train.txt", lines[:40]), ("valid.txt", lines[40:50]),
                       ("test.txt", lines[50:])):
        with open(os.path.join(raw, name), "w") as f:
            f.write("\n".join(part) + "\n")


def write_dataset(root, which):
    """The raw files of ``DATASETS[which]`` under ``root``; returns its
    ``cfg["dataset"]``."""
    name, keys, _ = DATASETS[which]
    if which == "transductive":
        write_transductive(root)
    else:
        write_inductive(kg.build_dataset(name, root, **keys), seed=3)
    return {"class": name, "root": root, **keys}


def make_cfg(dataset_cfg, task_name, epochs=0, batch_per_epoch=None):
    return {"dataset": dict(dataset_cfg), "model": MODEL,
            "task": {"name": task_name, "num_negative": 4, "strict_negative": True,
                     "adversarial_temperature": 1, "metric": METRICS},
            "optimizer": {"lr": 1e-3},
            "train": {"batch_size": 4, "num_epoch": epochs, "batch_per_epoch": batch_per_epoch}}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(path of a .pth the JAX package exported from seed-0 weights, the JAX
    params, the JAX model config)."""
    jcfg = jrunner.model_config_from_dict(MODEL)
    params = jax.tree.map(np.asarray, jax_init_ultra_params(jcfg, jax.random.key(0)))
    path = str(tmp_path_factory.mktemp("ckpt") / "ultra_seed0.pth")
    export_ultra_checkpoint(params, path)
    return path, params, jcfg


def assert_no_near_ties(dataset, name, task_name, ckpt_path, params, jcfg):
    """For the valid and test triples of ``dataset``, both directions: the
    two packages' scores on the split's graph differ by less than 1e-5, and
    every candidate the filter counts scores more than twice that from its
    positive, or exactly as much in both packages."""
    model = nbfnet.Ultra(runner.model_config_from_dict(MODEL))
    model.load_state_dict(ckpt.load_model_checkpoint(ckpt_path))
    filtered = runner.build_filtered_index(dataset, name, task_name)
    for split_name in ("valid", "test"):
        split = getattr(dataset, split_name)
        trips = runner.triples_of(split)
        graph = runner.prepare_graph(split, device="cpu")
        jgraph = jrunner.prepare_graph(jkg.KGSplit(*split), with_plans=False)
        t_mask, h_mask = tasks.strict_negative_mask(filtered[split_name], trips)
        h, t, r = (trips[:, i] for i in range(3))
        num_direct = graph.num_relations // 2
        for kw, target, mask in ((dict(h_index=h, r_index=r), t, t_mask),
                                 (dict(h_index=t, r_index=r + num_direct, query_r_index=r),
                                  h, h_mask)):
            with torch.no_grad():
                got = nbfnet.ultra_score_all(
                    model, graph, **{k: torch.as_tensor(v) for k, v in kw.items()}).numpy()
            want = np.asarray(jnbf.ultra_score_all(
                params, jcfg, jgraph, **{k: jnp.asarray(v) for k, v in kw.items()}))
            delta = np.abs(got - want).max()
            assert delta < 1e-5
            rows = np.arange(len(trips))[:, None]
            for scores in (got, want):
                gap = np.abs(scores - scores[rows, target[:, None]])
                assert np.all((gap[mask] > 2 * delta) | (gap[mask] == 0))


def assert_same_metrics(got, want):
    assert got.keys() == want.keys() == {"valid", "test"}
    for split in ("valid", "test"):
        assert list(got[split]) == list(want[split]) == METRICS
        np.testing.assert_allclose([got[split][m] for m in METRICS],
                                   [want[split][m] for m in METRICS], rtol=1e-12, atol=0)


@pytest.mark.parametrize("which", list(DATASETS))
def test_build_filtered_index_matches_jax(tmp_path, which):
    """Each branch's filters have the JAX package's edges and sizes: every
    split's targets on the training graph (transductive); the inference
    graph with the validation and test targets, one filter for both
    (FBIngram); the training graph with the validation targets at the
    validation split's size, and the test graph with its targets (HM)."""
    ds_cfg = write_dataset(str(tmp_path), which)
    name, keys, task_name = DATASETS[which]
    dataset = kg.build_dataset(name, str(tmp_path), **keys).load()
    got = runner.build_filtered_index(dataset, name, task_name)
    want = jrunner.build_filtered_index(jkg.KGDataset(dataset.name, *(
        jkg.KGSplit(*s) for s in dataset[1:])), name, task_name)
    for split in ("valid", "test"):
        a, b = got[split], want[split]
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_array_equal(a.edge_type, b.edge_type)
        assert (a.num_nodes, a.num_relations) == (b.num_nodes, b.num_relations)
    assert (got["valid"] is got["test"]) == (which != "inductive")
    if which == "inductive":
        assert got["valid"].num_nodes == dataset.valid.num_nodes > dataset.train.num_nodes
    assert ds_cfg["class"] == name


@pytest.mark.parametrize("name", ["WDsinger", "FB15k237_50", "FB15k237", "FBIngram", "HM"])
def test_default_metrics_match_jax(name):
    metrics = ("mr", "mrr", "hits@10")
    assert runner.default_metrics(name, metrics) == jrunner.default_metrics(name, metrics)
    assert runner.default_metrics(name, metrics)[0] == (
        "mr-tail" if name in kg.TAIL_ONLY_EVAL else "mr")


@pytest.mark.parametrize("which", list(DATASETS))
def test_run_link_prediction_zero_shot_matches_jax(tmp_path, checkpoint, which):
    """``epochs 0`` from one exported checkpoint: the valid and test metrics
    of the JAX package, on the transductive toy, the InGram-layout toy and
    HM's (whose validation graph has nodes that no edge touches)."""
    path, params, jcfg = checkpoint
    name, _, task_name = DATASETS[which]
    cfg = make_cfg(write_dataset(str(tmp_path / "data"), which), task_name)
    got = runner.run_link_prediction(cfg, str(tmp_path / "port"), seed=0, checkpoint=path,
                                     device="cpu")
    dataset = kg.build_dataset(name, **{k: v for k, v in cfg["dataset"].items()
                                        if k != "class"}).load()
    assert_no_near_ties(dataset, name, task_name, path, params, jcfg)
    want = jrunner.run_link_prediction(cfg, str(tmp_path / "jax"), seed=0, checkpoint=path,
                                       with_plans=False)
    assert_same_metrics(got, want)


def test_run_link_prediction_fine_tunes_and_checkpoints(tmp_path, checkpoint):
    """One epoch of 3 steps on the InGram-layout toy: the epoch's checkpoint
    is written, its weights moved from the start and are finite, and every
    metric is finite with MRR in (0, 1]."""
    path = checkpoint[0]
    cfg = make_cfg(write_dataset(str(tmp_path / "data"), "inference"), "InductiveInference",
                   epochs=1, batch_per_epoch=3)
    workdir = tmp_path / "work"
    results = runner.run_link_prediction(cfg, str(workdir), seed=0, checkpoint=path,
                                         device="cpu")
    trained = torch.load(workdir / "model_epoch_1.pth", weights_only=True)["model"]
    start = ckpt.load_model_checkpoint(path)
    assert all(torch.isfinite(v).all() for v in trained.values())
    assert any(not torch.equal(trained[k], start[k]) for k in start)
    for split in ("valid", "test"):
        assert all(np.isfinite(v) for v in results[split].values())
        assert 0 < results[split]["mrr"] <= 1


@pytest.mark.parametrize("case", ["oom", "oom_with_remat", "other_error"])
def test_out_of_memory_retries_with_remat(tmp_path, checkpoint, monkeypatch, caplog, case):
    """Fine-tuning that runs out of device memory after a step has moved the
    weights starts again once, with both models remat, from the weights the
    run started with. Out of memory with remat already on, or any other
    error, is raised as it is."""
    path = checkpoint[0]
    model_cfg = MODEL
    if case == "oom_with_remat":
        model_cfg = {k: dict(v, remat=True) if isinstance(v, dict) else v
                     for k, v in MODEL.items()}
    cfg = dict(make_cfg(write_dataset(str(tmp_path / "data"), "transductive"),
                        "TransductiveInference", epochs=1, batch_per_epoch=2),
               model=model_cfg)
    calls = []

    def fake_train_and_validate(cfg, model, graphs, dataset, filtered, workdir, seed=1024):
        calls.append(((model.cfg.relation_model.remat, model.cfg.entity_model.remat),
                      {k: v.clone() for k, v in model.state_dict().items()}))
        if len(calls) == 1:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.5)  # a step has updated the weights in place
            if case == "other_error":
                raise RuntimeError("not a memory error")
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return model

    monkeypatch.setattr(runner, "train_and_validate", fake_train_and_validate)
    if case != "oom":
        with pytest.raises(RuntimeError) as info:
            runner.run_link_prediction(cfg, str(tmp_path / "w"), checkpoint=path, device="cpu")
        assert isinstance(info.value, torch.cuda.OutOfMemoryError) == (case != "other_error")
        assert len(calls) == 1
        return
    results = runner.run_link_prediction(cfg, str(tmp_path / "w"), checkpoint=path,
                                         device="cpu")
    assert [c[0] for c in calls] == [(False, False), (True, True)]
    start = ckpt.load_model_checkpoint(path)
    for weights in (calls[0][1], calls[1][1]):
        assert weights.keys() == start.keys()
        assert all(torch.equal(weights[k], start[k]) for k in start)
    assert "retrying with remat: yes" in caplog.text
    assert 0 < results["test"]["mrr"] <= 1


def test_run_link_prediction_refuses_a_missing_card_and_process_groups(
        tmp_path, monkeypatch):
    """``device="cuda"`` without a card raises before any work, as does a
    process group of more than one process (the multi-host branch, ROADMAP
    A12)."""
    cfg = make_cfg({"class": "FB15k237", "root": str(tmp_path / "absent")},
                   "TransductiveInference")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.run_link_prediction(cfg, str(tmp_path / "w"), device="cuda")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        runner.run_link_prediction(cfg, str(tmp_path / "w"), device="cpu")


CLI_CFG = """output_dir: {out}
dataset:
  class: {{{{ dataset }}}}
  version: {{{{ version }}}}
  root: {root}
model:
  relation_model: {{input_dim: 16, hidden_dims: [16, 16]}}
  entity_model: {{input_dim: 16, hidden_dims: [16, 16]}}
task:
  name: InductiveInference
  metric: [mr, mrr, hits@1, hits@3, hits@10]
optimizer: {{lr: 1.0e-3}}
train:
  batch_size: 4
  num_epoch: {{{{ epochs }}}}
  batch_per_epoch: {{{{ bpe }}}}
checkpoint: {{{{ ckpt }}}}
"""


def test_cli_twins_match_jax(tmp_path, checkpoint):
    """``scripts/torch_run.py --device cpu`` and ``scripts/torch_run_many.py
    --device cpu``, each in its own process, against the JAX package's
    ``scripts/run.py`` and ``scripts/run_many.py`` (both in one process, on
    JAX's CPU backend, through a script that sets ``sys.argv`` and runs
    each, as ``tests/test_cli.py`` does),
    zero-shot on the InGram-layout toy from one checkpoint: the printed
    metrics are equal, and so are the CSV rows but for their time."""
    path, params, jcfg = checkpoint
    root = str(tmp_path / "data")
    write_dataset(root, "inference")
    dataset = kg.build_dataset("FBIngram", root, version="toy").load()  # one cache for all
    assert_no_near_ties(dataset, "FBIngram", "InductiveInference", path, params, jcfg)
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(CLI_CFG.format(out=tmp_path / "out", root=root))
    argv = {"run.py": ["-c", str(cfg_file), "--dataset", "FBIngram", "--version", "toy",
                       "--epochs", "0", "--bpe", "null", "--ckpt", path]}
    procs = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        argv["run_many.py"] = ["-c", str(cfg_file), "-d", "FBIngram:toy", "--ckpt", path,
                               "--root", root, "--output", str(tmp_path / side / "rows.csv")]
        if side == "jax":
            launcher = tmp_path / "launch_jax.py"
            launcher.write_text(
                f"import sys\nsys.path.insert(0, {REPO!r})\nimport tests.conftest\n" + "".join(
                    f"sys.argv = {[script, *args]!r}\n"
                    f"exec(open({os.path.join(REPO, 'scripts', script)!r}).read())\n"
                    for script, args in argv.items()))
            cmds = {"jax": [sys.executable, str(launcher)]}
        else:
            cmds = {f"port {script}": [sys.executable,
                                       os.path.join(REPO, "scripts", f"torch_{script}"),
                                       *args, "--device", "cpu"]
                    for script, args in argv.items()}
        for name, cmd in cmds.items():
            procs[name] = subprocess.Popen(cmd, cwd=tmp_path / side, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)
    printed = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, err[-3000:])
        printed[name] = [line for line in out.splitlines() if line.startswith("{'valid'")]
    assert len(printed["jax"]) == len(printed["port run.py"]) == 1
    assert_same_metrics(ast.literal_eval(printed["port run.py"][0]),
                        ast.literal_eval(printed["jax"][0]))
    rows = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "rows.csv") as f:
            rows[side] = [{k: v for k, v in row.items() if k != "time_s"}
                          for row in csv.DictReader(f)]
        assert os.path.isdir(tmp_path / side / "output" / "FBIngram-toy-1024")
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]) == 1 and rows["port"][0]["dataset"] == "FBIngram:toy"
    assert rows["port"][0]["mrr"] == str(round(ast.literal_eval(
        printed["port run.py"][0])["test"]["mrr"], 4))

"""``scripts/torch_run_query.py``, the port's zero-shot complex-query command
line, run as its own process on the CPU with the repo's UltraQuery config
(``config/ultraquery/transductive_synth.yaml``, ultra_3g's widths) on the
BetaE pickle fixture of ``tests/test_query_datasets.py``: its valid and
test metrics against the JAX package's ``evaluate_queries`` on the same
weights (a seeded JAX parameter tree, carried across with
``params_from_jax`` and saved as the checkpoint the script loads), within
1e-6; a training run's against the JAX ``train_queries``; and its refusal
of a malformed ``ULTRA_DIST``.
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_query_datasets import write_transductive_fixture
from ultra_tpu.query import datasets as jds
from ultra_tpu.query.executor import QueryConfig as JQueryConfig
from ultra_tpu.query.trainer import evaluate_queries, prepare_query_graph
from ultra_tpu.train import runner as jrunner
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "ultraquery", "transductive_synth.yaml")
METRICS = ["mrr", "hits@1", "hits@3", "hits@10", "mape"]  # the config's task.metric


def command(root, ckpt, epochs=0):
    return [sys.executable, os.path.join(REPO, "scripts", "torch_run_query.py"), "-c", CONFIG,
            "--dataset", "FB15k237LogicalQuery", "--root", root, "--epochs", str(epochs),
            "--bs", "2", "--bpe", "null", "--threshold", "0.8", "--ultra_ckpt", "null",
            "--qe_ckpt", ckpt, "--device", "cpu"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(dataset root, checkpoint path, JAX params) with the fixture's files
    under the name FB15k237LogicalQuery reads."""
    base = tmp_path_factory.mktemp("run_query")
    root = str(base / "qdata")
    write_transductive_fixture(root, name="FB15k-237-betae")
    layer = {"input_dim": 64, "hidden_dims": [64] * 6, "message_func": "distmult",
             "aggregate_func": "sum", "short_cut": True, "layer_norm": True}
    jcfg = jrunner.model_config_from_dict({"relation_model": layer, "entity_model": layer})
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(7)))
    ckpt = str(base / "ultraquery.pth")
    # UltraQuery's layout: Ultra's state dict nested under model.model.*
    torch.save({"model": {f"model.model.{k}": v for k, v in params_from_jax(params).items()}},
               ckpt)
    return root, ckpt, params, jcfg, base


def test_run_query_cli_matches_jax_evaluate_queries(fixture):
    root, ckpt, params, jcfg, base = fixture
    env = dict(os.environ, ULTRA_WORKDIR=str(base / "work"))
    env.pop("ULTRA_DIST", None)
    proc = subprocess.run(command(root, ckpt), capture_output=True, text=True, timeout=600,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert "valid metrics:" in proc.stderr and "test metrics:" in proc.stderr
    assert os.path.isdir(base / "work")

    ds = jds.build_query_dataset("FB15k237LogicalQuery", root).load()
    qcfg = JQueryConfig(threshold=0.8)
    for split, (lo, hi) in zip(("valid", "test"), ds.split_ranges()[1:]):
        qg = ds.graphs[("train", "valid", "test").index(split)]
        want = evaluate_queries(params, jcfg, qcfg, prepare_query_graph(qg), ds,
                                np.arange(lo, hi), batch_size=2, metric_names=METRICS,
                                restrict_nodes=qg.restrict_nodes)
        assert list(got[split]) == list(want)
        np.testing.assert_allclose(np.array(list(got[split].values())),
                                   np.array(list(want.values())), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["training", "ULTRA_DIST"])
def test_run_query_cli_refusals(fixture, case):
    """A malformed ``ULTRA_DIST`` is refused (the launch wants
    ``coordinator:port,num_processes,proc_id``). Training is ported: with
    ``--epochs 1`` the command line trains (traversal dropout, one step a
    batch of 2 of the fixture's 2 training queries) and then evaluates; its
    valid and test metrics equal the JAX package's ``train_queries`` and
    ``evaluate_queries`` from the same weights and seed, within 1e-6, and
    it leaves its checkpoints in the working directory."""
    root, ckpt, params, jcfg, base = fixture
    workdir = base / ("trained" if case == "training" else "refused")
    env = dict(os.environ, ULTRA_WORKDIR=str(workdir))
    env.pop("ULTRA_RESUME_FROM", None)
    if case == "ULTRA_DIST":
        env["ULTRA_DIST"] = "localhost:1234,2"
        proc = subprocess.run(command(root, ckpt), capture_output=True, text=True,
                              timeout=300, cwd=REPO, env=env)
        assert proc.returncode != 0
        assert "ULTRA_DIST='localhost:1234,2': want coordinator:port" in proc.stderr
        return

    proc = subprocess.run(command(root, ckpt, epochs=1), capture_output=True, text=True,
                          timeout=600, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert "epoch 0: avg bce" in proc.stderr
    assert {"model_latest.pth", "model_epoch_1.pth"} <= set(os.listdir(workdir))

    from ultra_tpu.query.trainer import train_queries
    from ultra_tpu.utils import config as jconfig

    cfg = jconfig.load_config(CONFIG, context={
        "dataset": "FB15k237LogicalQuery", "root": root, "epochs": 1, "bs": 2, "bpe": "null",
        "threshold": 0.8, "ultra_ckpt": "null", "qe_ckpt": ckpt})
    ds = jds.build_query_dataset("FB15k237LogicalQuery", root).load()
    qcfg = JQueryConfig(threshold=0.8)
    trained = train_queries(cfg, jcfg, qcfg, params, ds, str(base / "jax-trained"), seed=1024)
    for split, (lo, hi) in zip(("valid", "test"), ds.split_ranges()[1:]):
        qg = ds.graphs[("train", "valid", "test").index(split)]
        want = evaluate_queries(trained, jcfg, qcfg, prepare_query_graph(qg), ds,
                                np.arange(lo, hi), batch_size=2, metric_names=METRICS,
                                restrict_nodes=qg.restrict_nodes)
        assert list(got[split]) == list(want)
        np.testing.assert_allclose(np.array(list(got[split].values())),
                                   np.array(list(want.values())), rtol=0, atol=1e-6)


def test_run_query_many_cli_matches_jax(fixture):
    """``scripts/torch_run_query_many.py --device cpu`` against
    ``scripts/run_query_many.py``, each in its own process from one
    checkpoint: the same CSV columns and metrics (both round to 4
    decimals)."""
    import csv

    root, ckpt, _, _, base = fixture
    rows = {}
    for script, extra in (("run_query_many.py", []), ("torch_run_query_many.py",
                                                      ["--device", "cpu"])):
        out = str(base / f"{script}.csv")
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", script), "-c",
             os.path.join(REPO, "config", "ultraquery", "transductive.yaml"), "-d",
             "FB15k237LogicalQuery", "--qe_ckpt", ckpt, "--threshold", "0.8", "--bs", "2",
             "--root", root, "--output", out, *extra],
            capture_output=True, text=True, timeout=600, cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out) as f:
            (rows[script],) = list(csv.DictReader(f))
    got, want = rows["torch_run_query_many.py"], rows["run_query_many.py"]
    assert list(got) == list(want) and got["dataset"] == want["dataset"]
    for k in want:
        if k not in ("dataset", "time_s"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-4 + 1e-9, k


def test_run_query_cli_pretrains_a_mixture_as_jax(fixture):
    """A ``JointQueryDataset`` config (``config/ultraquery/pretrain_mixture.yaml``:
    grouped projections, grad_accum 2) on three BetaE fixtures: the port's
    command line pretrains on the members and logs each member's test
    metrics as ``scripts/run_query.py`` does, from one checkpoint, within
    1e-4 (the logs print 4 decimals)."""
    import re

    _, ckpt, _, _, base = fixture
    root = str(base / "mixture")
    for name in ("FB15k-237-betae", "NELL-betae", "FB15k-betae"):
        write_transductive_fixture(root, name=name)
    logs = {}
    for script, extra in (("run_query.py", []), ("torch_run_query.py", ["--device", "cpu"])):
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", script), "-c",
             os.path.join(REPO, "config", "ultraquery", "pretrain_mixture.yaml"), "--root", root,
             "--epochs", "1", "--bs", "2", "--bpe", "3", "--fast_test", "2", "--ultra_ckpt",
             "null", "--qe_ckpt", ckpt, *extra],
            capture_output=True, text=True, timeout=600, cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", ULTRA_WORKDIR=str(base / script)))
        assert proc.returncode == 0, proc.stderr[-3000:]
        logs[script] = proc.stderr
    member = r"test metrics \[([\w-]+)\]:((?:\n.*  [\w@\[\] ]+: [0-9.]+)+)"
    got, want = (re.findall(member, logs[s]) for s in ("torch_run_query.py", "run_query.py"))
    assert [m for m, _ in got] == [m for m, _ in want] == [
        "FB15k-237-betae", "NELL-betae", "FB15k-betae"]
    for (_, a), (_, b) in zip(got, want):
        a, b = re.findall(r"  ([\w@\[\] ]+): ([0-9.]+)", a), re.findall(r"  ([\w@\[\] ]+): ([0-9.]+)", b)
        assert [k for k, _ in a] == [k for k, _ in b] and len(a) > 5
        np.testing.assert_allclose([float(v) for _, v in a], [float(v) for _, v in b], rtol=0,
                                   atol=1e-4 + 1e-9)

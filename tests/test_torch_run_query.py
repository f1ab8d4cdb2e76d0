"""``scripts/torch_run_query.py``, the port's zero-shot complex-query command
line, run as its own process on the CPU with the repo's UltraQuery config
(``config/ultraquery/transductive_synth.yaml``, ultra_3g's widths) on the
BetaE pickle fixture of ``tests/test_query_datasets.py``: its valid and
test metrics against the JAX package's ``evaluate_queries`` on the same
weights (a seeded JAX parameter tree, carried across with
``params_from_jax`` and saved as the checkpoint the script loads), within
1e-6; and its refusals (training, ``ULTRA_DIST``).
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
    root, ckpt, _, _, base = fixture
    env = dict(os.environ, ULTRA_WORKDIR=str(base / "refused"))
    if case == "ULTRA_DIST":
        env["ULTRA_DIST"] = "localhost:1234,2,0"
    proc = subprocess.run(command(root, ckpt, epochs=1 if case == "training" else 0),
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode != 0
    assert ("A10" if case == "training" else "A12") in proc.stderr

"""The port's path interpretation (``ultra_tpu_torch/models/visualize.py``)
against the JAX package's, with the same weights (``init_ultra_params``
through ``params_from_jax``) on the same padded graph
(``train/runner.py::prepare_graph`` on both sides): the per-layer edge
gradients for every aggregator and message, the host beam search and
backtracking, the paths of ``visualize``, and the two command lines.

Tolerance of the edge gradients: per layer, over the edges live when the
graph was built, |port - JAX| <= 1e-4 * that layer's largest |JAX gradient|
+ 1e-7, in f32; both sides sum in other orders through the stacked layers,
and an entry near 0 has no relative precision of its own. The padding is
left out: for sum and mean its gradient is 0 in the port (the kernel's)
and the derivative in XLA, and ``visualize`` masks it on both sides. The
beam search is compared exactly.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ultra_tpu.data import kg as jkg
from ultra_tpu.models import visualize as jvis
from ultra_tpu.train import runner as jrunner
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu.utils.torch_ckpt import export_ultra_checkpoint
from ultra_tpu_torch.data import kg
from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.models import visualize as vis
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.ops import rspmm_cuda
from ultra_tpu_torch.train import runner
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, R_DIRECT, T, D = 20, 3, 60, 16
REL_TO_MAX, ATOL = 1e-4, 1e-7


def _splits(seed=9):
    """The same synthetic split as the JAX package's and the port's record."""
    trip = random_kg_triples(V, R_DIRECT, T, seed)
    ei, et = with_inverses(trip, R_DIRECT)
    args = (ei, et, V, 2 * R_DIRECT, trip[:, :2].T.copy(), trip[:, 2].copy())
    return jkg.KGSplit(*args), kg.KGSplit(*args), trip


def _model_cfg(aggregate="sum", message="distmult"):
    nbf = {"input_dim": D, "hidden_dims": [D, D], "message_func": message,
           "aggregate_func": aggregate}
    return {"relation_model": dict(nbf, **{"class": "RelNBFNet"}),
            "entity_model": dict(nbf, **{"class": "EntityNBFNet"})}


def setup(aggregate="sum", message="distmult", seed=9):
    jsplit, psplit, trip = _splits(seed)
    model_cfg = _model_cfg(aggregate, message)
    jcfg = jrunner.model_config_from_dict(model_cfg)
    params = jax_init_ultra_params(jcfg, jax.random.key(0))
    model = Ultra(runner.model_config_from_dict(model_cfg))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    jgraph = jrunner.prepare_graph(jsplit, with_plans=False)
    graph = runner.prepare_graph(psplit, device="cpu")
    assert graph.num_edges_padded == jgraph.num_edges_padded > psplit.edge_index.shape[1]
    h, t, r = (int(a) for a in trip[0])
    return jgraph, jcfg, params, graph, model, (h, t, r)


@pytest.mark.parametrize("message", ["distmult", "transe", "rotate"])
@pytest.mark.parametrize("aggregate", ["sum", "mean", "max", "pna"])
def test_edge_gradients_match_jax(aggregate, message):
    jgraph, jcfg, params, graph, model, (h, t, r) = setup(aggregate, message)
    want = jvis.edge_gradients(params, jcfg, jgraph, h, t, r)
    got = vis.edge_gradients(model, graph, h, t, r)
    live = graph.edge_weight.numpy() != 0
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (graph.num_edges_padded,)
        if aggregate in ("sum", "mean"):  # the kernel's: padding is 0
            assert np.all(g[~live] == 0)
        err = np.abs(g[live] - w[live]).max()
        assert err <= REL_TO_MAX * np.abs(w[live]).max() + ATOL, (err, np.abs(w).max())
    assert any(np.abs(g).sum() > 0 for g in got)
    assert all(p.requires_grad for p in model.parameters())  # restored


def test_edge_gradients_launch_what_attribution_needs(monkeypatch):
    """Frozen parameters: no relation gradient at all, no input gradient at
    the first layer; the edge-weight gradient at every layer (sum)."""
    jgraph, jcfg, params, graph, model, (h, t, r) = setup()
    calls = []
    for name in ("rspmm_dw", "rspmm_sum_dx", "rspmm_sum_drel"):
        real = getattr(rspmm_cuda, name)
        monkeypatch.setattr(f"ultra_tpu_torch.ops.rspmm.{name}",
                            lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    vis.edge_gradients(model, graph, h, t, r)
    assert sorted(calls) == ["rspmm_dw"] * 2 + ["rspmm_sum_dx"]


def _jax_beam(ei, et, grads, h, t, beam):
    dist, back = jvis.beam_search_distance(ei, et, grads, V, h, t, beam)
    return dist, back, jvis.topk_average_length(dist, back, t, beam)


@pytest.mark.parametrize("kind", ["ties", "model"])
@pytest.mark.parametrize("beam", [1, 3, 10])
def test_beam_search_equals_jax(kind, beam):
    """Vectorised beam search and backtracking against the JAX package's
    loops on the same arrays: the padded graph (repeated (0, 0, 0) padding
    edges), gradients from the model or small integers (ties everywhere)."""
    jgraph, jcfg, params, graph, model, (h, t, r) = setup()
    ei, et = graph.edge_index.numpy(), graph.edge_type.numpy()
    if kind == "model":
        live = graph.edge_weight.numpy() != 0
        grads = [g * live for g in vis.edge_gradients(model, graph, h, t, r)]
    else:
        rng = np.random.default_rng(beam)
        grads = [rng.integers(-2, 3, ei.shape[1]).astype(np.float32) for _ in range(3)]
    dist, back = vis.beam_search_distance(ei, et, grads, V, h, t, beam)
    want_dist, want_back, want_paths = _jax_beam(ei, et, grads, h, t, beam)
    for a, b in zip(dist, want_dist):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(back, want_back):
        np.testing.assert_array_equal(a, b)
    assert vis.topk_average_length(dist, back, t, beam) == want_paths
    assert want_paths[0]


@pytest.mark.parametrize("beam", [3, 10])
def test_beam_search_timing_script_times_the_jax_loop(beam):
    """``scripts/torch_beam_search_time.py`` times a copy of the JAX
    package's loop (it imports nothing of that package): the copy gives the
    loop's output on tie-heavy gradients over the padded graph."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_beam_search_time", os.path.join(REPO, "scripts", "torch_beam_search_time.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jgraph, jcfg, params, graph, model, (h, t, r) = setup()
    ei, et = graph.edge_index.numpy(), graph.edge_type.numpy()
    rng = np.random.default_rng(beam)
    grads = [rng.integers(-2, 3, ei.shape[1]).astype(np.float32) for _ in range(3)]
    got = script.beam_search_loop(ei, et, grads, V, h, t, beam)
    want = jvis.beam_search_distance(ei, et, grads, V, h, t, beam)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("aggregate, message", [("sum", "distmult"), ("pna", "transe")])
def test_visualize_paths_match_jax(aggregate, message):
    jgraph, jcfg, params, graph, model, (h, t, r) = setup(aggregate, message)
    want_paths, want_weights = jvis.visualize(params, jcfg, jgraph, h, t, r, num_beam=5,
                                              path_topk=5)
    got = vis.visualize(model, graph, h, t, r, num_beam=5, path_topk=5)
    assert got.paths == want_paths and want_paths
    np.testing.assert_allclose(got.weights, want_weights, rtol=1e-4, atol=1e-7)
    edges = set(zip(*graph.edge_index.numpy()[:, :T * 2], graph.edge_type.numpy()[:T * 2]))
    for path in got.paths:
        assert path[0][0] == h and path[-1][1] == t
        assert all(e in edges for e in path)
        assert all(a[1] == b[0] for a, b in zip(path[:-1], path[1:]))


def _write_toy_dataset(root):
    raw = root / "clitoy" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = sorted({f"n{rng.integers(12)} r{rng.integers(3)} n{rng.integers(12)}"
                    for _ in range(70)})
    (raw / "train.txt").write_text("\n".join(lines[:40]) + "\n")
    (raw / "valid.txt").write_text("\n".join(lines[40:50]) + "\n")
    (raw / "test.txt").write_text("\n".join(lines[50:60]) + "\n")


def _run(script, tmp_path):
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_torch_visualize_cli_prints_the_paths_of_the_jax_cli(tmp_path):
    """scripts/visualize.py and scripts/torch_visualize.py --device cpu on a
    toy dataset, with a .pth written by export_ultra_checkpoint: the same
    heading and the same path lines."""
    root = tmp_path / "kg-datasets"
    _write_toy_dataset(root)
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(
        f"dataset:\n  class: {{{{ dataset }}}}\n  root: {root}\n"
        f"model:\n  relation_model: {{input_dim: {D}, hidden_dims: [{D}, {D}]}}\n"
        f"  entity_model: {{input_dim: {D}, hidden_dims: [{D}, {D}]}}\n"
        "train:\n  num_epoch: {{ epochs }}\ncheckpoint: {{ ckpt }}\n")
    ckpt = tmp_path / "model.pth"
    jcfg = jrunner.model_config_from_dict(
        {"relation_model": {"input_dim": D, "hidden_dims": [D, D]},
         "entity_model": {"input_dim": D, "hidden_dims": [D, D]}})
    export_ultra_checkpoint(jax.tree.map(np.asarray, jax_init_ultra_params(
        jcfg, jax.random.key(1))), str(ckpt))

    class_def = "class CLIToy({0}.TransductiveDataset):\n    name = 'clitoy'\n    urls = ()\n"
    outputs = []
    for package, script, extra in (
        ("ultra_tpu", "visualize.py", "import tests.conftest\n"),
        ("ultra_tpu_torch", "torch_visualize.py", ""),
    ):
        argv = ["x", "-c", str(cfg_file), "--dataset", "CLIToy", "--ckpt", str(ckpt),
                "--head", "{h}", "--relation", "{r}", "--tail", "{t}", "--topk", "4"]
        if package == "ultra_tpu_torch":
            argv += ["--device", "cpu"]
        wrapper = tmp_path / f"run_{script}"
        wrapper.write_text(
            f"import sys\nsys.path.insert(0, {REPO!r})\n{extra}"
            f"from {package}.data import kg\n" + class_def.format("kg") +
            "kg.DATASETS['CLIToy'] = CLIToy\n"
            f"ds = kg.build_dataset('CLIToy', {str(root)!r}).load()\n"
            "h, t = (int(a) for a in ds.test.target_edge_index[:, 0])\n"
            "r = int(ds.test.target_edge_type[0])\n"
            f"sys.argv = [a.format(h=h, r=r, t=t) for a in {argv!r}]\n"
            f"exec(open({os.path.join(REPO, 'scripts', script)!r}).read())\n")
        outputs.append(_run(wrapper, tmp_path).strip().splitlines())
    jax_lines, torch_lines = outputs
    assert torch_lines == jax_lines
    paths = [l for l in torch_lines if "importance" in l]
    assert paths and torch_lines[0].startswith(f"top {len(paths)} paths for ")


def test_visualize_entry_points_default_to_cuda(monkeypatch):
    """Without a card, the command line's graph and its whole run raise
    unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, psplit, _ = _splits()
    for call in (lambda: runner.prepare_graph(psplit),
                 lambda: vis.visualize_from_config({}, 0, 0, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

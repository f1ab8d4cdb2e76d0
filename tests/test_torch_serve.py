"""The port's serving path (``ultra_tpu_torch.serve.UltraPredictor``) and
its host-side pieces against the JAX package, plus the port's import and
device rules.

Tolerance for scores: f32, rtol 1e-4 and atol 1e-5, as for the models.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu import tasks as jtasks
from ultra_tpu.data import synthetic as jsynthetic
from ultra_tpu.models.nbfnet import NBFNetConfig as JNBFNetConfig
from ultra_tpu.models.nbfnet import UltraConfig as JUltraConfig
from ultra_tpu.serve import UltraPredictor as JUltraPredictor
from ultra_tpu.train.eval import precompute_relation_representations as jax_precompute
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu.utils.torch_ckpt import convert_ultra_checkpoint, export_ultra_checkpoint
from ultra_tpu_torch import tasks
from ultra_tpu_torch.data import synthetic
from ultra_tpu_torch.data.kg import KGSplit, split_to_graph
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models.nbfnet import NBFNetConfig, Ultra, UltraConfig
from ultra_tpu_torch.serve import UltraPredictor
from ultra_tpu_torch.train.eval import precompute_relation_representations
from ultra_tpu_torch.train.loop import init_ultra_params
from ultra_tpu_torch.utils.torch_ckpt import load_ultra_checkpoint, params_from_jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-5)
V, R_DIRECT, T, D = 30, 4, 120, 16


def _configs(message="distmult", aggregate="sum", dim=D):
    def nb(mod, **kw):
        return mod(input_dim=dim, hidden_dims=(dim, dim), message_func=message,
                   aggregate_func=aggregate, **kw)

    return (
        JUltraConfig(relation_model=nb(JNBFNetConfig, num_relation=4),
                     entity_model=nb(JNBFNetConfig, num_relation=1, project_relations=True)),
        UltraConfig(relation_model=nb(NBFNetConfig, num_relation=4),
                    entity_model=nb(NBFNetConfig, num_relation=1, project_relations=True)),
    )


@pytest.fixture(scope="module")
def served():
    """(JAX predictor, port predictor, JAX params, port graph)."""
    jcfg, pcfg = _configs()
    jgraph, ei, et = jsynthetic.synthetic_graph(V, R_DIRECT, T, seed=1)
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0)))
    model = Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    split = KGSplit(ei, et, V, 2 * R_DIRECT, ei[:, :0], et[:0])
    graph = split_to_graph(split, device="cpu")
    return (
        JUltraPredictor(params, jcfg, jgraph, batch_size=4),
        UltraPredictor(model, graph, batch_size=4, device="cpu"),
        params,
        graph,
    )


H = np.array([0, 5, 9, 5, 12, 29])  # two batches of 4, the second one short
R = np.array([1, 3, 0, 2, 3, 1])


def test_score_all_matches_jax(served):
    jpred, pred, *_ = served
    np.testing.assert_allclose(pred.score_all(H, R), jpred.score_all(H, R), **TOL)


@pytest.mark.parametrize("direction", ["tails", "heads"])
def test_topk_matches_jax(served, direction):
    jpred, pred, *_ = served
    want_s, want_i = getattr(jpred, f"predict_{direction}")(H, R, k=5)
    got_s, got_i = getattr(pred, f"predict_{direction}")(H, R, k=5)
    np.testing.assert_allclose(got_s, want_s, **TOL)
    # ids agree wherever no other candidate scores within 1e-4 of the hit
    r = R + (2 * R_DIRECT) // 2 if direction == "heads" else R
    full = jpred.score_all(H, r)  # (N, V)
    near = np.abs(full[:, None, :] - want_s[:, :, None]) <= 1e-4
    distinct = near.sum(axis=-1) == 1
    np.testing.assert_array_equal(got_i[distinct], want_i[distinct])
    assert distinct.mean() > 0.5


def test_precompute_wraps_last_chunk_like_jax(served):
    jpred, pred, params, graph = served
    jcfg, _ = _configs()
    want = jax_precompute(params, jcfg, jpred.graph, chunk=3)  # 8 relations: 3+3+2
    with torch.no_grad():
        got = precompute_relation_representations(pred.model, graph, chunk=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("live", [False, True])
def test_relation_graph_edge_set_matches_jax(live):
    trip = synthetic.random_kg_triples(50, 6, 200, seed=2, rel_dist="zipf", categories=4)
    ei, et = synthetic.with_inverses(trip, 6)
    mask = np.random.default_rng(0).random(ei.shape[1]) < 0.7 if live else None
    got = tasks.build_relation_graph_arrays(ei, et, 50, 12, live=mask)
    want = jtasks.build_relation_graph_arrays(ei, et, 50, 12, live=mask)
    as_set = lambda a: set(zip(a[0][0].tolist(), a[0][1].tolist(), a[1].tolist()))
    assert as_set(got) == as_set(want)
    assert got[0].shape[1] == len(as_set(got))  # no duplicate edges


def test_synthetic_generator_matches_jax():
    kw = dict(rel_dist="zipf", categories=5)
    np.testing.assert_array_equal(
        synthetic.random_kg_triples(60, 7, 300, seed=4, **kw),
        jsynthetic.random_kg_triples(60, 7, 300, seed=4, **kw),
    )


def test_compute_ranking_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 5, (6, 20)).astype(np.float32)  # many ties
    target = rng.integers(0, 20, 6)
    mask = rng.random((6, 20)) < 0.8
    for m in (None, mask):
        got = tasks.compute_ranking(torch.from_numpy(pred), torch.from_numpy(target),
                                    None if m is None else torch.from_numpy(m))
        want = jtasks.compute_ranking(jnp.asarray(pred), jnp.asarray(target),
                                      None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nest_levels", [0, 2])
def test_checkpoint_round_trip(served, tmp_path, nest_levels):
    """params_from_jax saved in the reference layout reads back through the
    JAX converter, and a reference-layout file loads into the port."""
    _, pred, params, _ = served
    path = tmp_path / "ultra.pth"
    sd = params_from_jax(params)
    torch.save({"model": {"model." * nest_levels + k: v for k, v in sd.items()}}, path)
    back = convert_ultra_checkpoint(str(path))
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))

    path2 = tmp_path / "exported.pth"
    export_ultra_checkpoint(params, str(path2), nest_levels=nest_levels)
    model = Ultra(_configs()[1])
    model.load_state_dict(load_ultra_checkpoint(str(path2)))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, pred.model.state_dict()[k], rtol=0, atol=0)


def test_from_checkpoint_serves_like_the_predictor(served, tmp_path):
    jpred, pred, params, _ = served
    path = tmp_path / "ultra.pth"
    export_ultra_checkpoint(params, str(path))
    _, ei, et = jsynthetic.synthetic_graph(V, R_DIRECT, T, seed=1)
    split = KGSplit(ei, et, V, 2 * R_DIRECT, ei[:, :0], et[:0])
    loaded = UltraPredictor.from_checkpoint(
        str(path), split, cfg=_configs()[1], batch_size=4, device="cpu")
    np.testing.assert_array_equal(loaded.score_all(H, R), pred.score_all(H, R))


@pytest.mark.parametrize("message, aggregate", [
    ("distmult", "max"), ("distmult", "pna"), ("transe", "pna"), ("rotate", "sum"),
    ("rotate", "mean"), ("rotate", "max"), ("rotate", "pna")])
def test_minmax_and_rotate_predictors_match_jax(message, aggregate):
    """A max, PNA or rotate model served by both packages from the same
    weights: every score, and the top-k of both directions."""
    jcfg, pcfg = _configs(message, aggregate)
    jgraph, ei, et = jsynthetic.synthetic_graph(V, R_DIRECT, T, seed=1)
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(2)))
    model = Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    split = KGSplit(ei, et, V, 2 * R_DIRECT, ei[:, :0], et[:0])
    jpred = JUltraPredictor(params, jcfg, jgraph, batch_size=4)
    pred = UltraPredictor(model, split_to_graph(split, device="cpu"), batch_size=4,
                          device="cpu")
    np.testing.assert_allclose(pred.score_all(H, R), jpred.score_all(H, R), **TOL)
    for direction, r in (("tails", R), ("heads", R + R_DIRECT)):
        want_s, want_i = getattr(jpred, f"predict_{direction}")(H, R, k=5)
        got_s, got_i = getattr(pred, f"predict_{direction}")(H, R, k=5)
        np.testing.assert_allclose(got_s, want_s, **TOL)
        full = jpred.score_all(H, r)
        distinct = (np.abs(full[:, None, :] - want_s[:, :, None]) <= 1e-4).sum(-1) == 1
        np.testing.assert_array_equal(got_i[distinct], want_i[distinct])


def test_pna_checkpoint_round_trip(tmp_path):
    """A PNA model at width 64 in the reference .pth layout: each entity
    layer's linear is (64, 13 * 64) in torch's (out, in) layout; the JAX
    exporter's file loads into the port and the port's file reads back
    through the JAX converter."""
    jcfg, pcfg = _configs("distmult", "pna", dim=64)
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0)))
    path = tmp_path / "pna.pth"
    export_ultra_checkpoint(params, str(path))
    model = Ultra(pcfg)
    model.load_state_dict(load_ultra_checkpoint(str(path)))
    assert tuple(model.state_dict()["entity_model.layers.0.linear.weight"].shape) == (64, 832)
    for k, v in params_from_jax(params).items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    init = init_ultra_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: v.shape for k, v in init.state_dict().items()} == \
        {k: v.shape for k, v in model.state_dict().items()}
    torch.save({"model": model.state_dict()}, tmp_path / "port.pth")
    back = convert_ultra_checkpoint(str(tmp_path / "port.pth"))
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "ultra_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", *sorted((ROOT / "scripts").glob("torch_*.py"))]
    assert len(files) > 10
    banned = {"jax", "jaxlib", "flax", "optax", "ultra_tpu"}
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, f"{f.relative_to(ROOT)} imports {mod}"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, an entry point called without device= raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ei = np.array([[0, 1], [1, 0]])
    et = np.array([0, 1])
    _, pcfg = _configs()
    calls = [
        lambda: make_graph(ei, et, 2, 2),
        lambda: synthetic.synthetic_graph(10, 2, 20),
        lambda: split_to_graph(KGSplit(ei, et, 2, 2, ei, et)),
        lambda: init_ultra_params(pcfg, torch.Generator().manual_seed(0)),
        lambda: UltraPredictor(Ultra(pcfg), make_graph(ei, et, 2, 2, device="cpu")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_init_ultra_params_shapes_match_jax():
    jcfg, pcfg = _configs()
    want = params_from_jax(jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0))))
    a = init_ultra_params(pcfg, torch.Generator().manual_seed(0), device="cpu").state_dict()
    b = init_ultra_params(pcfg, torch.Generator().manual_seed(0), device="cpu").state_dict()
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in want.items()}
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)  # one seed, one model
        if k.endswith("linear.weight"):
            assert a[k].abs().max() <= 1 / np.sqrt(a[k].shape[1])

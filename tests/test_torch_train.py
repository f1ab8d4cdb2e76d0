"""The port's training path (``ultra_tpu_torch``) against the JAX package:
host sampling and masks, the loss, one train step's loss and gradients (on
a JAX graph without plans, the XLA backend, and with Pallas plans in
interpret mode), AdamW against optax on identical gradients, gradient
accumulation, checkpoints and resume, and a tiny ``train_and_validate``.

Tolerances: sampled arrays and masks are identical (the same numpy
arithmetic on the same generator). Losses and gradients are f32 with sums
in other orders through the stacked layers: rtol 1e-4 and atol 1e-5, as the
model tests use. AdamW against optax on the same gradients: the same
arithmetic in another order, rtol 1e-6 and atol 1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ultra_tpu import tasks as jtasks
from ultra_tpu.graph import make_graph as jax_make_graph
from ultra_tpu.models import nbfnet as jnbf
from ultra_tpu.ops.rspmm_pallas import attach_plans
from ultra_tpu.tasks import build_relation_graph
from ultra_tpu.train import loop as jloop
from ultra_tpu_torch import tasks
from ultra_tpu_torch.data.kg import KGDataset, KGSplit, split_to_graph
from ultra_tpu_torch.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.models import nbfnet
from ultra_tpu_torch.ops import rspmm
from ultra_tpu_torch.tasks import build_relation_graph_arrays
from ultra_tpu_torch.train import loop
from ultra_tpu_torch.train.runner import train_and_validate, triples_of
from ultra_tpu_torch.utils import ckpt
from ultra_tpu_torch.utils.torch_ckpt import load_ultra_checkpoint, params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
V, R_DIRECT, T, D, E_PAD = 40, 4, 150, 16, 384
NEG, BATCH = 6, 4


# (message, aggregate) of the relation model and of the entity model
VARIANTS = {"sum": (("distmult", "sum"),) * 2,
            "max": (("distmult", "max"),) * 2,
            "pna": (("distmult", "pna"),) * 2,
            "pna-entity": (("distmult", "sum"), ("distmult", "pna")),
            **{f"rotate-{a}": (("rotate", a),) * 2 for a in ("sum", "mean", "max", "pna")}}


def _cfgs(remat=False, variant="sum"):
    (rel_msg, rel_agg), (ent_msg, ent_agg) = VARIANTS[variant]

    def nb(mod, **kw):
        return mod.NBFNetConfig(input_dim=D, hidden_dims=(D, D), **kw)

    return (
        jnbf.UltraConfig(
            relation_model=nb(jnbf, num_relation=4, message_func=rel_msg,
                              aggregate_func=rel_agg),
            entity_model=nb(jnbf, num_relation=1, project_relations=True,
                            message_func=ent_msg, aggregate_func=ent_agg)),
        nbfnet.UltraConfig(
            relation_model=nb(nbfnet, num_relation=4, remat=remat, message_func=rel_msg,
                              aggregate_func=rel_agg),
            entity_model=nb(nbfnet, num_relation=1, project_relations=True, remat=remat,
                            message_func=ent_msg, aggregate_func=ent_agg)),
    )


@pytest.fixture(scope="module")
def kg():
    """(edge_index, edge_type, direct triples, port graph, {plans: JAX graph},
    port index, JAX index)."""
    trip = random_kg_triples(V, R_DIRECT, T, seed=3)
    ei, et = with_inverses(trip, R_DIRECT)
    nrel = 2 * R_DIRECT
    rei, ret = build_relation_graph_arrays(ei, et, V, nrel)
    port = make_graph(ei, et, V, nrel, pad_to=E_PAD, device="cpu",
                      relation_graph=make_graph(rei, ret, nrel, 4, device="cpu"))
    jrel = build_relation_graph(ei, et, V, nrel)
    jgraphs = {False: jax_make_graph(ei, et, V, nrel, pad_to=E_PAD, relation_graph=jrel)}
    jgraphs[True] = attach_plans(
        jgraphs[False].replace(relation_graph=attach_plans(jrel, rb=32, chunk=64)),
        rb=32, chunk=64)
    return (ei, et, trip, port, jgraphs, tasks.GraphIndex.build(ei, et, V, nrel),
            jtasks.GraphIndex.build(ei, et, V, nrel))


def _model(pcfg, params):
    model = nbfnet.Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    return model


def _batch(kg, seed=0, rows=BATCH):
    ei, et, trip, port, _, index, _ = kg
    rng = np.random.default_rng(seed)
    pos = trip[rng.choice(len(trip), rows, replace=False)]
    batch = tasks.negative_sampling(index, pos, NEG, rng=rng)
    return batch, tasks.easy_edge_weights(index, batch, port.num_edges_padded)


@pytest.mark.parametrize("strict", [True, False])
def test_negative_sampling_matches_jax(kg, strict):
    *_, index, jindex = kg
    trip = kg[2][[0, 5, 9, 17, 33]]  # odd batch: 2 tail rows, 3 head rows
    got = tasks.negative_sampling(index, trip, 16, strict=strict,
                                  rng=np.random.default_rng(11))
    want = jtasks.negative_sampling(jindex, trip, 16, strict=strict,
                                    rng=np.random.default_rng(11))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5, 17, 3)


def test_strict_negative_mask_matches_jax(kg):
    *_, index, jindex = kg
    trip = kg[2][:12]
    for g, w in zip(tasks.strict_negative_mask(index, trip),
                    jtasks.strict_negative_mask(jindex, trip)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("remove_one_hop", [False, True])
def test_easy_edge_weights_match_jax(kg, remove_one_hop):
    *_, index, jindex = kg
    batch = tasks.negative_sampling(index, kg[2][:6], 4, rng=np.random.default_rng(2))
    got = tasks.easy_edge_weights(index, batch, E_PAD, remove_one_hop=remove_one_hop)
    want = jtasks.easy_edge_weights(jindex, batch, E_PAD, remove_one_hop=remove_one_hop)
    np.testing.assert_array_equal(got, want)
    assert got[kg[0].shape[1]:].sum() == 0 and got.sum() < kg[0].shape[1]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_self_adversarial_bce_matches_jax(temperature):
    pred = np.random.default_rng(0).normal(size=(4, 7)).astype(np.float32) * 3
    got = loop.self_adversarial_bce(torch.from_numpy(pred), temperature, 6)
    want = jloop.self_adversarial_bce(jnp.asarray(pred), temperature, 6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_loss_and_grads(jcfg, params, jgraph, batch, ew):
    def loss_fn(p):
        pred = jnbf.ultra_apply(p, jcfg, jgraph.replace(edge_weight=jnp.asarray(ew)),
                                jnp.asarray(batch))
        return jloop.self_adversarial_bce(pred, 1.0, NEG)

    loss, grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    return float(loss), params_from_jax(jax.device_get(grads))


@pytest.mark.parametrize("plans", [False, True])
def test_train_step_loss_and_gradients_match_jax(kg, plans):
    """One port step from ``params_from_jax`` weights: its loss and the
    gradients it leaves in ``.grad`` against jax.value_and_grad of the JAX
    loss on the same batch and easy-edge mask."""
    port, jgraphs = kg[3], kg[4]
    jcfg, pcfg = _cfgs()
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(0)))
    batch, ew = _batch(kg)
    state = loop.init_train_state(_model(pcfg, params))
    step = loop.make_train_step(adversarial_temperature=1.0, num_negative=NEG)
    loss = step(state, port, torch.from_numpy(batch), torch.from_numpy(ew))
    assert state.step == 1

    want_loss, want_grads = _jax_loss_and_grads(jcfg, params, jgraphs[plans], batch, ew)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("plans", [False, True])
@pytest.mark.parametrize("variant", ["max", "pna", "pna-entity", "rotate-sum", "rotate-mean",
                                     "rotate-max", "rotate-pna"])
def test_minmax_and_rotate_train_steps_match_jax(kg, plans, variant):
    """One port step of a max, PNA or rotate model against
    jax.value_and_grad of the JAX loss on the same batch and easy-edge mask
    (every gradient), and the AdamW update it applied against optax's on
    the same gradients (Adam's first step, g / (|g| + eps), is too steep at
    g near 0 to take the two packages' gradients). The first layer's input
    is mostly 0 rows, so the min/max gradients run through many ties."""
    port, jgraphs = kg[3], kg[4]
    jcfg, pcfg = _cfgs(variant=variant)
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(0)))
    batch, ew = _batch(kg)
    state = loop.init_train_state(_model(pcfg, params), lr=1e-3)
    loss = loop.make_train_step(adversarial_temperature=1.0, num_negative=NEG)(
        state, port, torch.from_numpy(batch), torch.from_numpy(ew))

    want_loss, want_grads = _jax_loss_and_grads(jcfg, params, jgraphs[plans], batch, ew)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), err_msg=k, **TOL)

    opt = jloop.make_optimizer(lr=1e-3)
    p0 = params_from_jax(params)
    jp0 = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
    updates, _ = opt.update({k: jnp.asarray(g.numpy()) for k, g in grads.items()},
                            opt.init(jp0), jp0)
    want_params = optax.apply_updates(jp0, updates)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_params[k]),
                                   err_msg=k, rtol=1e-6, atol=1e-7)


def test_pna_train_step_asks_each_rspmm_gradient_once_per_call(kg, monkeypatch):
    """What autograd asks of the rspmm in one step of the PNA configuration
    (a sum relation model and a PNA entity model, L layers each): per
    relation layer a sum forward, a relation gradient and, but for the
    first layer (whose input is a constant boundary), an input gradient;
    per entity layer two sum forwards (the sum and the sum of squares), a
    max and a min forward, and the input and relation gradients of all
    four. The chip run asserts the same counts as kernel launches."""
    port = kg[3]
    jcfg, pcfg = _cfgs(variant="pna-entity")
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(0)))
    names = ("rspmm_sum_fwd", "rspmm_sum_dx", "rspmm_sum_drel", "rspmm_minmax_fwd",
             "rspmm_minmax_dx", "rspmm_minmax_drel")
    calls = {}
    for name in names:
        real = getattr(rspmm, name)
        monkeypatch.setattr(rspmm, name, lambda *a, _n=name, _f=real: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a))[1])
    batch, ew = _batch(kg)
    loop.make_train_step(num_negative=NEG)(
        loop.init_train_state(_model(pcfg, params)), port,
        torch.from_numpy(batch), torch.from_numpy(ew))
    layers = len(pcfg.entity_model.hidden_dims)
    assert calls == {"rspmm_sum_fwd": 3 * layers, "rspmm_sum_dx": 3 * layers - 1,
                     "rspmm_sum_drel": 3 * layers, "rspmm_minmax_fwd": 2 * layers,
                     "rspmm_minmax_dx": 2 * layers, "rspmm_minmax_drel": 2 * layers}


def test_adamw_matches_optax_on_identical_gradients():
    """Three AdamW steps on the same gradients: the port's optimizer against
    the JAX package's optax.adamw, parameter by parameter."""
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 3), "b": (3,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = loop.make_optimizer(params.values(), lr=5e-3)
    jopt = jloop.make_optimizer(lr=5e-3)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jparams)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7)


def test_grad_accum_equals_the_full_batch(kg):
    """grad_accum=2 (two micro-batches of 2) gives the full batch's loss,
    gradients and updated parameters."""
    port = kg[3]
    jcfg, pcfg = _cfgs()
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(1)))
    batch, ew = _batch(kg, seed=1)
    out = []
    for accum in (1, 2, 3):  # 3 does not divide 4: gcd makes it the full batch
        state = loop.init_train_state(_model(pcfg, params), lr=1e-3)
        loss = loop.make_train_step(num_negative=NEG, grad_accum=accum)(
            state, port, torch.from_numpy(batch), torch.from_numpy(ew))
        out.append((float(loss), {k: (p.detach().clone(), p.grad.clone())
                                  for k, p in state.model.named_parameters()}))
    (l1, p1), (l2, p2), (l3, p3) = out
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    assert l3 == l1
    for k in p1:
        torch.testing.assert_close(p2[k][1], p1[k][1], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(p2[k][0], p1[k][0], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(p3[k][1], p1[k][1], rtol=0, atol=0)


def test_remat_gives_the_same_loss_and_gradients(kg, monkeypatch):
    """remat recomputes each conv's forward in the backward (twice the
    rspmm forwards) and gives the same loss and gradients."""
    port = kg[3]
    jcfg, pcfg = _cfgs()
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(2)))
    batch, ew = _batch(kg, seed=2)
    calls = []
    real = rspmm.rspmm_sum_fwd
    monkeypatch.setattr(rspmm, "rspmm_sum_fwd", lambda *a: calls.append(1) or real(*a))
    out = []
    for cfg in (pcfg, _cfgs(remat=True)[1]):
        calls.clear()
        state = loop.init_train_state(_model(cfg, params))
        loss = loop.make_train_step(num_negative=NEG)(
            state, port, torch.from_numpy(batch), torch.from_numpy(ew))
        out.append((float(loss), {k: p.grad for k, p in state.model.named_parameters()},
                    len(calls)))
    layers = len(pcfg.entity_model.hidden_dims)
    assert (out[0][2], out[1][2]) == (2 * layers, 4 * layers)
    assert out[0][0] == out[1][0]
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], g, rtol=1e-6, atol=1e-8)


def test_train_step_asks_each_rspmm_gradient_once_per_layer(kg, monkeypatch):
    """What autograd asks of the rspmm in one step of an L-layer model:
    2L forwards, 2L relation gradients, and 2L-1 input gradients (the
    relation model's first layer takes a constant boundary). The chip run
    asserts the same counts as kernel launches."""
    port = kg[3]
    jcfg, pcfg = _cfgs()
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(0)))
    calls = {}
    for name in ("rspmm_sum_fwd", "rspmm_sum_dx", "rspmm_sum_drel"):
        real = getattr(rspmm, name)
        monkeypatch.setattr(rspmm, name, lambda *a, _n=name, _f=real: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a))[1])
    batch, ew = _batch(kg)
    loop.make_train_step(num_negative=NEG)(
        loop.init_train_state(_model(pcfg, params)), port,
        torch.from_numpy(batch), torch.from_numpy(ew))
    layers = len(pcfg.entity_model.hidden_dims)
    assert calls == {"rspmm_sum_fwd": 2 * layers, "rspmm_sum_dx": 2 * layers - 1,
                     "rspmm_sum_drel": 2 * layers}


def test_save_resume_and_step_equals_an_unbroken_run(kg, tmp_path):
    """Two steps, a checkpoint, one more step: loading the checkpoint into a
    fresh state and taking that step gives the same parameters bit for bit.
    The file is the reference layout: its weights load as a model."""
    port = kg[3]
    jcfg, pcfg = _cfgs()
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(3)))
    step = loop.make_train_step(num_negative=NEG)
    batches = [_batch(kg, seed=s) for s in range(3)]
    run = lambda state, b: step(state, port, *(torch.from_numpy(a) for a in b))

    state = loop.init_train_state(_model(pcfg, params), lr=1e-2)
    for b in batches[:2]:
        run(state, b)
    path = ckpt.save_train_state(str(tmp_path / "model_latest.pth"), state)
    run(state, batches[2])

    resumed = ckpt.load_train_state(path, loop.init_train_state(_model(pcfg, params), lr=1e-2))
    assert resumed.step == 2
    run(resumed, batches[2])
    assert resumed.step == state.step == 3
    for (k, a), b in zip(state.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    assert set(load_ultra_checkpoint(path)) == set(state.model.state_dict())


def _dataset():
    trip = random_kg_triples(30, 3, 110, seed=5)
    ei, et = with_inverses(trip[:80], 3)

    def split(rows):
        return KGSplit(ei, et, 30, 6, np.ascontiguousarray(rows[:, :2].T), rows[:, 2].copy())

    return KGDataset("tiny", split(trip[:80]), split(trip[80:95]), split(trip[95:]))


def test_train_and_validate_runs_checkpoints_and_resumes(tmp_path, monkeypatch):
    """A tiny run: 4 epochs of 2 steps, validation after every epoch, one
    checkpoint each; the returned weights are the best checkpoint's. A
    crash checkpoint named by ULTRA_RESUME_FROM is resumed only if it
    exists."""
    _, pcfg = _cfgs()
    dataset = _dataset()
    graph = split_to_graph(dataset.train, device="cpu")
    filtered = {"valid": tasks.GraphIndex.build(
        np.concatenate([dataset.train.target_edge_index, dataset.valid.target_edge_index], 1),
        np.concatenate([dataset.train.target_edge_type, dataset.valid.target_edge_type]), 30, 6)}
    cfg = {"train": {"num_epoch": 4, "batch_size": 4, "batch_per_epoch": 2,
                     "checkpoint_interval_steps": 2},
           "task": {"num_negative": NEG}, "optimizer": {"lr": 5e-3}}
    model = loop.init_ultra_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setenv("ULTRA_RESUME_FROM", str(tmp_path / "missing.pth"))
    best = train_and_validate(cfg, model, {"train": graph, "valid": graph}, dataset,
                              filtered, str(tmp_path / "run"))
    names = sorted(os.listdir(tmp_path / "run"))
    assert names == ["model_epoch_1.pth", "model_epoch_2.pth", "model_epoch_3.pth",
                     "model_epoch_4.pth", "model_latest.pth"]
    assert triples_of(dataset.valid).shape == (15, 3)
    saved = [torch.load(tmp_path / "run" / n, weights_only=True) for n in names[:4]]
    assert [s["step"] for s in saved] == [2, 4, 6, 8]
    assert any(all(torch.equal(v, s["model"][k]) for k, v in best.state_dict().items())
               for s in saved)
    for p in best.parameters():
        assert torch.isfinite(p).all()

    # resume from the crash checkpoint: the run restarts from step 8
    monkeypatch.setenv("ULTRA_RESUME_FROM", str(tmp_path / "run" / "model_latest.pth"))
    cfg["train"]["num_epoch"] = 1
    model = loop.init_ultra_params(pcfg, torch.Generator().manual_seed(1), device="cpu")
    train_and_validate(cfg, model, {"train": graph, "valid": graph}, dataset, filtered,
                       str(tmp_path / "again"))
    again = torch.load(tmp_path / "again" / "model_epoch_1.pth", weights_only=True)
    assert again["step"] == 10

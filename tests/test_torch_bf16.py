"""``compute_dtype: bfloat16`` in the port against the JAX package's Pallas
path (path (a): graphs with ``attach_plans``, the kernels in interpret mode
on the CPU), which takes bf16 rspmm operands, keeps the edge weights in
f32, accumulates in f32 and writes f32, and returns ``d_rel`` and ``d_x``
rounded to bf16 and ``d_w`` in f32.

Tolerances:
- one rspmm and one conv: the f32 tolerances of ``test_torch_rspmm.py``
  (rtol 1e-5, atol 1e-5) and ``test_torch_models.py`` (rtol 1e-4, atol
  1e-5). Both sides round the same operands to bf16 and compute in f32, so
  only the order of the f32 sums differs. A bf16 gradient (``d_rel``,
  ``d_x``) is those sums rounded to bf16, and a sum that differs in its
  last f32 bit may round to the neighbouring bf16 value: within one bf16
  unit in the last place, 2^-7 of the value, plus 1e-5.
- the whole model (2 layers a model): the f32 noise of one layer can flip
  the next layer's bf16 rounding of an operand by one unit in the last
  place (2^-8 of its scale, relative), and the backward rounds ``d_x`` to
  bf16 at every layer of both models. So the scores are held to
  ``SCORE_ULPS`` of the largest |score| and each gradient tensor to
  ``GRAD_ULPS`` of its largest entry, and the loss to the f32 rtol of
  ``test_torch_train.py``. The same f32 model (no cast) lies outside both
  bounds: the test fails if the cast is skipped.
- the shape contract on the card: every bf16 instance (B1-B6) walks 8
  features a thread (F % 8 == 0, bf16 rows 16-byte aligned) and raises
  ``ValueError`` before any launch on anything else; every f32 instance
  walks 4 (F % 4 == 0, rows 16-byte aligned). Held on meta tensors (a
  device that is not the CPU), as
  ``test_torch_rspmm.py`` holds the f32 instances' contract; the sizes of
  the 8-feature walk that ``scripts/torch_row_piece_sweep.py --walk8``
  rewrites are held to the sources as text.
- the divergence from the JAX package's XLA path (path (b), where it runs
  without plans: bf16 weights and bf16 accumulation) is pinned against an
  f64 reference on the same bf16 operands: the port within 1e-6 of the
  largest |output|, the XLA path beyond 1e-3. Attribution's divergence
  (the JAX package leaves its entity layers in f32) is pinned at
  ``test_torch_visualize.py``'s f32 tolerance.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import _conv_case, graphs  # noqa: F401 - a fixture
from tests.test_torch_rspmm import (
    E, E_PAD, R, V, _no_launches, make_inputs, make_tie_inputs, port_graph,
)
from tests.test_torch_train import NEG, _batch, _cfgs, _model, kg  # noqa: F401
from tests.test_torch_visualize import ATOL, REL_TO_MAX, _model_cfg, _splits
from ultra_tpu.graph import make_graph as jax_make_graph
from ultra_tpu.models import layers as jlayers
from ultra_tpu.models import nbfnet as jnbf
from ultra_tpu.models import visualize as jvis
from ultra_tpu.ops.rspmm import generalized_rspmm as jax_generalized_rspmm
from ultra_tpu.ops.rspmm import rspmm_from_graph as jax_rspmm_from_graph
from ultra_tpu.ops.rspmm_pallas import attach_plans
from ultra_tpu.train import loop as jloop
from ultra_tpu.train import runner as jrunner
from ultra_tpu_torch.models import layers, nbfnet
from ultra_tpu_torch.models import visualize as vis
from ultra_tpu_torch.ops import build, pieces, rspmm_cuda, rspmm_minmax_cuda
from ultra_tpu_torch.ops.rspmm import rspmm_from_graph
from ultra_tpu_torch.train import loop, runner
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

RSPMM_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_GRAD_TOL = dict(rtol=2.0**-7, atol=1e-5)
SCORE_ULPS, GRAD_ULPS = 2.0**-8, 2.0**-6
LOSS_RTOL = 1e-4


def _bf16(a):
    """numpy f32 -> (the port's bf16 tensor, JAX's bf16 array), one rounding."""
    t = torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.detach().float().numpy()


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("sum_op", ["add", "min", "max"])
def test_rspmm_bf16_matches_pallas(sum_op, mul):
    """Each aggregator on bf16 rows: the f32 output against the Pallas
    custom VJP's primal, and the gradients (bf16 ``d_rel`` and ``d_x``, f32
    ``d_w`` over the edges live when the graph was built) against its
    backward, on the same output gradient."""
    make = make_inputs if sum_op == "add" else make_tie_inputs
    ei, et, ew, rel, x, mask = make(seed=5)
    (rel_t, rel_j), (x_t, x_j) = _bf16(rel), _bf16(x)
    w = torch.from_numpy(mask).requires_grad_()
    rel_t.requires_grad_()
    x_t.requires_grad_()
    out = rspmm_from_graph(port_graph(ei, et, ew).replace_weights(w), rel_t, x_t, sum=sum_op,
                           mul=mul)
    assert out.dtype == torch.float32
    g = np.random.default_rng(9).normal(size=out.shape).astype(np.float32)
    g[~np.isfinite(out.detach().numpy())] = 0.0  # a row with no live edge
    d_rel, d_x, d_w = torch.autograd.grad(out, (rel_t, x_t, w), torch.from_numpy(g))
    assert d_rel.dtype == d_x.dtype == torch.bfloat16 and d_w.dtype == torch.float32

    jgraph = attach_plans(jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD),
                          rb=32, chunk=64)
    fn = lambda r, xx, ww: jax_rspmm_from_graph(jgraph.replace_weights(ww), r, xx,
                                                sum=sum_op, mul=mul)

    @jax.jit
    def primal_and_vjp(r, xx, ww, gg):
        out, vjp = jax.vjp(fn, r, xx, ww)
        return out, vjp(gg)

    want, (want_rel, want_x, want_w) = primal_and_vjp(rel_j, x_j, jnp.asarray(mask),
                                                      jnp.asarray(g))
    assert want.dtype == jnp.float32
    assert want_rel.dtype == want_x.dtype == jnp.bfloat16 and want_w.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **RSPMM_TOL)
    np.testing.assert_allclose(_np(d_rel), _np(want_rel), **BF16_GRAD_TOL)
    np.testing.assert_allclose(_np(d_x), _np(want_x), **BF16_GRAD_TOL)
    built = np.concatenate([ew != 0, np.zeros(E_PAD - E, bool)])
    np.testing.assert_allclose(d_w.numpy()[built], np.asarray(want_w)[built], **RSPMM_TOL)
    assert np.abs(d_w.numpy()[built]).sum() > 0


def test_plain_versions_widen_bf16_before_the_arithmetic():
    """The wrappers' plain versions on bf16 rows compute in f32: equal to
    the same call on the rows widened to f32 by hand, for every wrapper
    (the forwards, both input gradients, both relation gradients, B6)."""
    ei, et, ew, rel, x, _ = make_tie_inputs(seed=6)
    graph = port_graph(ei, et, ew)
    rel16, x16 = (torch.from_numpy(a.reshape(a.shape[0], -1)).bfloat16() for a in (rel, x))
    rel32, x32 = rel16.float(), x16.float()
    g = torch.from_numpy(np.random.default_rng(4).normal(size=x32.shape).astype(np.float32))
    w, k, mk = graph.edge_weight, rspmm_cuda, rspmm_minmax_cuda
    for mul in ("mul", "add"):
        out = mk.rspmm_minmax_fwd(graph.csr, w, rel16, x16, mul)
        pairs = [
            (k.rspmm_sum_fwd(graph.csr, w, rel16, x16, mul),
             k.rspmm_sum_fwd(graph.csr, w, rel32, x32, mul)),
            (k.rspmm_sum_dx(graph.csr_src, w, rel16, g, mul),
             k.rspmm_sum_dx(graph.csr_src, w, rel32, g, mul)),
            (k.rspmm_sum_drel(graph.segments, w, x16, g, mul),
             k.rspmm_sum_drel(graph.segments, w, x32, g, mul)),
            (out, mk.rspmm_minmax_fwd(graph.csr, w, rel32, x32, mul)),
            (mk.rspmm_minmax_dx(graph.csr_src, w, rel16, x16, g, out, mul),
             mk.rspmm_minmax_dx(graph.csr_src, w, rel32, x32, g, out, mul)),
            (mk.rspmm_minmax_drel(graph.segments, w, rel16, x16, g, out, mul),
             mk.rspmm_minmax_drel(graph.segments, w, rel32, x32, g, out, mul)),
            (k.rspmm_dw(graph.csr, w, rel16, x16, g, mul),
             k.rspmm_dw(graph.csr, w, rel32, x32, g, mul)),
            (k.rspmm_dw(graph.csr, w, rel16, x16, g, mul, out),
             k.rspmm_dw(graph.csr, w, rel32, x32, g, mul, out)),
        ]
        for i, (got, want) in enumerate(pairs):
            assert got.dtype == torch.float32, i
            assert torch.equal(got, want), (mul, i)


def _bf16_conv(conv, jcfg):
    """The same conv with compute_dtype bfloat16, in both packages."""
    bf = layers.GeneralizedRelationalConv(
        dataclasses.replace(conv.cfg, compute_dtype="bfloat16"))
    bf.load_state_dict(conv.state_dict())
    return bf, dataclasses.replace(jcfg, compute_dtype="bfloat16")


@pytest.mark.parametrize("message, aggregate", [
    ("distmult", "sum"), ("distmult", "mean"), ("distmult", "max"), ("distmult", "pna"),
    ("rotate", "sum"), ("rotate", "max")])
def test_conv_bf16_matches_pallas(graphs, message, aggregate):  # noqa: F811
    """One conv with ``compute_dtype="bfloat16"`` against ``conv_apply`` on
    the graph with plans; rotate with max runs per edge in f32 in both."""
    port, jax_graphs = graphs
    rng = np.random.default_rng(7)
    jcfg, params, conv, query, relation_input = _conv_case("project_relations", aggregate,
                                                           rng, message)
    conv16, jcfg = _bf16_conv(conv, jcfg)
    x = rng.normal(size=(port.num_nodes, query.shape[0], conv.cfg.input_dim)).astype(np.float32)
    boundary = rng.normal(size=x.shape).astype(np.float32)
    conv_apply = jax.jit(lambda p, *a: jlayers.conv_apply(p, jcfg, jax_graphs[True], *a))
    want = np.asarray(conv_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                 jnp.asarray(boundary), jnp.asarray(query),
                                 jnp.asarray(relation_input)))
    inputs = [torch.from_numpy(a) for a in (x, boundary, query, relation_input)]
    with torch.no_grad():
        got, f32 = (c(port, *inputs).numpy() for c in (conv16, conv))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **CONV_TOL)
    # the cast is there: the f32 conv is outside the bound, but for rotate
    # with max, which stays in f32
    rotate_max = message == "rotate" and aggregate == "max"
    assert np.allclose(f32, want, **CONV_TOL) == rotate_max


def _bf16_cfgs(variant):
    jcfg, pcfg = _cfgs(variant=variant)
    both = lambda cfg: dataclasses.replace(
        cfg, relation_model=dataclasses.replace(cfg.relation_model, compute_dtype="bfloat16"),
        entity_model=dataclasses.replace(cfg.entity_model, compute_dtype="bfloat16"))
    return jcfg, pcfg, both(jcfg), both(pcfg)


def _within_ulps(got, want, ulps):
    """max|got - want| within ``ulps`` of max|want|."""
    return float(np.abs(got - want).max()) <= ulps * float(np.abs(want).max())


def test_ultra_bf16_forward_and_train_step_match_pallas(kg):  # noqa: F811
    """A bf16 Ultra (distmult, sum) against the JAX package's with plans:
    the forward's scores of a training batch (under its easy-edge mask),
    and one train step's loss and gradients on it, within the bounds above;
    the f32 model lies outside them."""
    port, jgraphs = kg[3], kg[4]
    jcfg, pcfg, jcfg16, pcfg16 = _bf16_cfgs("sum")
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(0)))
    batch, ew = _batch(kg)
    jgraph = jgraphs[True].replace(edge_weight=jnp.asarray(ew))

    def loss_fn(p):
        pred = jnbf.ultra_apply(p, jcfg16, jgraph, jnp.asarray(batch))
        return jloop.self_adversarial_bce(pred, 1.0, NEG), pred

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    want_loss, want = float(want_loss), np.asarray(want)
    want_grads = params_from_jax(jax.device_get(want_grads))

    results = {}
    for name, cfg in (("bf16", pcfg16), ("f32", pcfg)):
        with torch.no_grad():
            scores = nbfnet.ultra_apply(_model(cfg, params),
                                        port.replace_weights(torch.from_numpy(ew)),
                                        torch.from_numpy(batch)).numpy()
        state = loop.init_train_state(_model(cfg, params))
        loss = loop.make_train_step(adversarial_temperature=1.0, num_negative=NEG)(
            state, port, torch.from_numpy(batch), torch.from_numpy(ew))
        grads = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
        results[name] = (scores, float(loss), grads)

    scores, loss, grads = results["bf16"]
    assert _within_ulps(scores, want, SCORE_ULPS)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        assert g.dtype == np.float32
        assert _within_ulps(g, want_grads[k].numpy(), GRAD_ULPS), k
    scores, _, grads = results["f32"]
    assert not _within_ulps(scores, want, SCORE_ULPS)
    assert not all(_within_ulps(g, want_grads[k].numpy(), GRAD_ULPS) for k, g in grads.items())


def test_query_projection_bf16_matches_jax(kg):  # noqa: F811
    """One ``query_nbfnet_apply`` of a bf16 entity model against the JAX
    package's with plans: answer probabilities within 1e-5, as the f32
    projection's test holds them."""
    port, jgraphs = kg[3], kg[4]
    jcfg, _, jcfg16, pcfg16 = _bf16_cfgs("sum")
    params = jax.device_get(jloop.init_ultra_params(jcfg, jax.random.key(1)))
    model = _model(pcfg16, params)
    rng = np.random.default_rng(2)
    b, v, r, d = 3, port.num_nodes, port.num_relations, jcfg.entity_model.input_dim
    boundary = rng.random((v, b, d)).astype(np.float32)
    rel_reprs = rng.normal(size=(b, r, d)).astype(np.float32)
    query = rng.normal(size=(b, d)).astype(np.float32)
    apply = jax.jit(lambda p, *a: jnbf.query_nbfnet_apply(p, jcfg16.entity_model,
                                                          jgraphs[True], *a))
    want = apply(params["entity_model"], jnp.asarray(boundary), jnp.asarray(rel_reprs),
                 jnp.asarray(query))
    with torch.no_grad():
        got = nbfnet.query_nbfnet_apply(model.entity_model, port, torch.from_numpy(boundary),
                                        torch.from_numpy(rel_reprs), torch.from_numpy(query))
    sigmoid = lambda a: 1 / (1 + np.exp(-np.asarray(a, np.float64)))
    np.testing.assert_allclose(sigmoid(got.numpy()), sigmoid(want), rtol=0, atol=1e-5)


def test_xla_path_accumulates_in_bf16_and_the_port_in_f32():
    """The kept divergence: where the JAX package runs without plans, its
    rspmm casts the weights to bf16 and accumulates in bf16 (path (b)); the
    port accumulates in f32 everywhere. Against an f64 sum of the same
    bf16 operands and f32 weights, the port's error is at f32's level and
    the XLA path's at bf16's."""
    ei, et, ew, rel, x, mask = make_inputs(seed=7)
    (rel_t, rel_j), (x_t, x_j) = _bf16(rel), _bf16(x)
    graph = port_graph(ei, et, ew).replace_weights(torch.from_numpy(mask))
    with torch.no_grad():
        got = rspmm_from_graph(graph, rel_t, x_t).numpy()
        want = rspmm_cuda.rspmm_sum_fwd_plain(
            graph.csr, graph.edge_weight.double(), rel_t.reshape(R, -1).double(),
            x_t.reshape(V, -1).double()).numpy().reshape(got.shape)
    xla = jax_generalized_rspmm(jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask[:E]), rel_j,
                                x_j, backend="xla")
    assert xla.dtype == jnp.bfloat16
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    assert np.abs(_np(xla) - want).max() > 1e-3 * scale


def test_attribution_rounds_the_entity_layers_where_jax_does_not():
    """The kept divergence of attribution: the JAX package's
    ``edge_gradients`` runs its entity layers unfused in f32 whatever
    ``compute_dtype`` (``ultra_tpu/models/visualize.py::_conv_unfused``);
    the port's conv rounds their operands to bf16 as on every other path.
    With bf16 in the relation model alone the port equals the JAX package
    (its relation model on plans) at the f32 tolerance of
    ``test_torch_visualize.py``; with bf16 in both models it does not."""
    jsplit, psplit, trip = _splits()
    both = _model_cfg()
    for section in both.values():
        section["compute_dtype"] = "bfloat16"
    relation_only = _model_cfg()
    relation_only["relation_model"]["compute_dtype"] = "bfloat16"
    jcfg = jrunner.model_config_from_dict(both)
    params = jloop.init_ultra_params(jcfg, jax.random.key(0))
    graph = runner.prepare_graph(psplit, device="cpu")
    h, t, r = (int(a) for a in trip[0])
    want = jvis.edge_gradients(params, jcfg, jrunner.prepare_graph(jsplit, with_plans=True),
                               h, t, r)
    live = graph.edge_weight.numpy() != 0
    within = {}
    for name, model_cfg in (("relation_only", relation_only), ("both", both)):
        model = nbfnet.Ultra(runner.model_config_from_dict(model_cfg))
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
        got = vis.edge_gradients(model, graph, h, t, r)
        within[name] = all(np.abs(g[live] - w[live]).max()
                           <= REL_TO_MAX * np.abs(w[live]).max() + ATOL
                           for g, w in zip(got, want))
    assert within == {"relation_only": True, "both": False}


def _meta_calls(feat, offset=0, dtype=torch.bfloat16):
    """Each instance of B1-B6 for ``dtype`` rows on meta tensors (a device
    that is not the CPU) of width ``feat``, the relation and x rows
    starting ``offset`` elements into their storage; the output gradient
    and the saved output f32 and aligned: B1's forward and input gradient,
    B2, B3, B4, B5, B6's sum and B6's min/max."""
    ei, et, ew, *_ = make_inputs()
    graph = port_graph(ei, et, ew)
    csr, csr_src, seg = (l.to("meta") for l in (graph.csr, graph.csr_src, graph.segments))

    def rows(n, dtype=dtype, at=offset):
        return torch.empty(n * feat + at, dtype=dtype, device="meta")[at:].view(n, feat)

    w, rel, x, g = torch.empty(E_PAD, device="meta"), rows(R), rows(V), rows(V, torch.float32, 0)
    k, mk = rspmm_cuda, rspmm_minmax_cuda
    return (lambda: k.rspmm_sum_fwd(csr, w, rel, x),
            lambda: k.rspmm_sum_dx(csr_src, w, rel, g),
            lambda: k.rspmm_sum_drel(seg, w, x, g),
            lambda: mk.rspmm_minmax_fwd(csr, w, rel, x),
            lambda: mk.rspmm_minmax_dx(csr_src, w, rel, x, g, g),
            lambda: mk.rspmm_minmax_drel(seg, w, rel, x, g, g),
            lambda: k.rspmm_dw(csr, w, rel, x, g),
            lambda: k.rspmm_dw(csr, w, rel, x, g, "mul", g))


@pytest.mark.parametrize("feat, offset", [(36, 0), (32, 4)])
def test_bf16_rows_off_the_8_feature_layout_are_refused_by_every_bf16_instance(monkeypatch, feat,
                                                                               offset):
    """Every bf16 instance (B1's two, B2's, B3's, B4's, B5's and B6's) loads
    8 features a thread, a bf16 row in one 16-byte load: a width that is a
    multiple of 4 but not of 8, or a bf16 row that starts 8-byte aligned
    but not 16-byte, raises before any launch; nothing falls back to the
    4-feature walk."""
    monkeypatch.setattr(build, "bind", lambda name: lambda *_: pytest.fail("launched"))
    for call in _meta_calls(feat, offset):
        with pytest.raises(ValueError, match="F % 8|16-byte"):
            call()
    assert _no_launches()


@pytest.mark.parametrize("feat, offset", [(36, 0), (32, 4), (36, 4)])
def test_f32_rows_keep_the_4_feature_layout_in_every_f32_instance(monkeypatch, feat, offset):
    """The f32 instances of B1-B6 keep the 4-feature walk and its contract:
    a width that is a multiple of 4 but not of 8, and f32 rows that start
    16 bytes into their storage, pass the width and alignment checks that
    the bf16 instances fail and meet the next one, the device (meta is not
    a CUDA device)."""
    monkeypatch.setattr(build, "bind", lambda name: lambda *_: pytest.fail("launched"))
    for call in _meta_calls(feat, offset, torch.float32):
        with pytest.raises(ValueError, match="want the CUDA device"):
            call()
    assert _no_launches()


def test_bf16_entry_points_and_launch_keys_are_unchanged(monkeypatch):
    """Each bf16 call of B1-B6 launches the entry point it launched on the
    4-feature walk, counted under the same key, after the 8-feature walk's
    checks (F % 8); those seven entry points, every bf16 instance, are the
    ones on the 8-feature walk."""
    names, walks = [], []

    def check(op, device, rows, index, edge_weight, features):
        walks.append(features)

    monkeypatch.setattr(pieces, "check_operands", check)
    monkeypatch.setattr(build, "bind", lambda name: names.append(name) or name)
    monkeypatch.setattr(build, "launch", lambda *_: None)
    wrappers = (rspmm_cuda.rspmm_sum_fwd, rspmm_cuda.rspmm_sum_dx, rspmm_cuda.rspmm_sum_drel,
                rspmm_minmax_cuda.rspmm_minmax_fwd, rspmm_minmax_cuda.rspmm_minmax_dx,
                rspmm_minmax_cuda.rspmm_minmax_drel, rspmm_cuda.rspmm_dw)
    for wrapper in wrappers:
        monkeypatch.setattr(wrapper, "launches", collections.Counter())
    for call in _meta_calls(32):
        call()
    entries = ["rspmm_sum_fwd_bf16_bf16", "rspmm_sum_fwd_bf16_f32", "rspmm_sum_drel_bf16",
               "rspmm_minmax_fwd_bf16_bf16", "rspmm_minmax_dx_bf16_bf16",
               "rspmm_minmax_drel_bf16_bf16", "rspmm_dw_bf16_bf16"]
    assert names == entries + ["rspmm_dw_bf16_bf16"]
    assert walks == [8] * 8
    assert {e for e in build.ENTRY_POINTS if pieces.features(e) == 8} == set(entries)
    assert rspmm_cuda.rspmm_sum_fwd.launches == {(V, 32, "bf16_bf16"): 1}
    assert rspmm_cuda.rspmm_sum_dx.launches == {(V, 32, "bf16_f32"): 1}
    assert rspmm_cuda.rspmm_sum_drel.launches == {(V, R, 32, "bf16"): 1}
    assert rspmm_minmax_cuda.rspmm_minmax_fwd.launches == {(V, 32, "bf16_bf16"): 1}
    assert rspmm_minmax_cuda.rspmm_minmax_dx.launches == {(V, 32, "bf16_bf16"): 1}
    assert rspmm_minmax_cuda.rspmm_minmax_drel.launches == {(R, 32, "bf16_bf16"): 1}
    assert rspmm_cuda.rspmm_dw.launches == {(V, 32, "bf16_bf16"): 2}


def test_walk8_sweep_finds_each_sources_size_pairs():
    """``scripts/torch_row_piece_sweep.py --walk8`` rewrites the sizes of
    the 8-feature walk by a pattern over the sources' text: in each file it
    names it finds exactly the size pairs that file defines, so that a
    renamed constant fails here and not by timing the wrong kernel. Every
    source of the walk's entry points is one of those files, and each pair
    is read by a walk in its file."""
    import importlib.util
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "torch_row_piece_sweep", root / "scripts" / "torch_row_piece_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    csrc = root / "ultra_tpu_torch" / "csrc"
    assert {f"{src}.cu" for src in sweep.WALK8_SOURCES} <= set(sweep.WALK8_SIZES)
    assert {re.sub(r"(_(?:bf16|f32))+$", "", e) for e in sweep.WALK8_ENTRIES} == set(
        sweep.WALK8_SOURCES)
    assert set(sweep.WALK8_ENTRIES) == {e for e in build.ENTRY_POINTS
                                        if pieces.features(e) == 8}
    for name, pairs in sweep.WALK8_SIZES.items():
        text = (csrc / name).read_text()
        assert sweep.WALK8_PATTERN.findall(text) == list(pairs), name
        for pair in pairs:  # and a walk in the same file takes its sizes from it
            assert re.search(rf"\b{pair}Unroll\b(?! =)", text), pair
        rewritten, n = sweep.WALK8_PATTERN.subn(r"\1Unroll = 99, \1MinBlocks = 98", text)
        assert n == len(pairs)
        assert all(f"{pair}Unroll = 99, {pair}MinBlocks = 98" in rewritten for pair in pairs)

"""The port's edge layouts and rspmm (``ultra_tpu_torch``) with its
gradients against the JAX package: the XLA backend (``jax.vjp``) and the
Pallas kernels in interpret mode on the CPU. Sum: both forwards (v1, v2),
the input gradient on the source plan, and the three relation-gradient
kernels (``_rel_grad_kernel``, ``_drel_kernel``, ``_drel_add_kernel``).
Min/max: both forwards (``_minmax_kernel``, ``_minmax_kernel_v2``), both
input-gradient and both relation-gradient kernels, and the custom VJPs of
both generations. The edge-weight gradient (B6) of every aggregator against
the XLA VJP and the Pallas VJPs (``_dw_kernel``), compared over the edges
live when the graph was built: XLA gives the padding its derivative where
the port and Pallas give 0. Inputs hold weight-0 edges, a runtime weight
mask and rows with no edges; the min/max inputs are tie-heavy as well.

Tolerance: f32, rtol 1e-5 and atol 1e-5, because the two packages sum each
row's (or each type's) terms in different orders. Min/max forwards are
compared exactly: a min or a max is exact, and the tie-heavy inputs (small
integers, weights of 0.5, 1 and 2) make every message exact too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu.graph import make_graph as jax_make_graph
from ultra_tpu.graph import pad_bucket as jax_pad_bucket
from ultra_tpu.ops.rspmm import degree as jax_degree
from ultra_tpu.ops.rspmm import generalized_rspmm as jax_generalized_rspmm
from ultra_tpu.ops.rspmm import rspmm_from_graph as jax_rspmm_from_graph
from ultra_tpu.ops.rspmm_pallas import (
    _drel_call, _minmax_bwd_call, _minmax_drel_kernel, _minmax_dx_kernel, _prec,
    attach_plans, rspmm_pallas_fwd, rspmm_pallas_minmax_fwd, rspmm_pallas_rel_grad,
)
from ultra_tpu.ops.rspmm_pallas_v2 import (
    rspmm_v2_drel, rspmm_v2_drel_add, rspmm_v2_fwd, rspmm_v2_minmax, rspmm_v2_minmax_drel,
    rspmm_v2_minmax_dx,
)
from ultra_tpu_torch.graph import make_graph, pad_bucket
from ultra_tpu_torch.ops import build, rspmm, rspmm_cuda, rspmm_minmax_cuda
from ultra_tpu_torch.ops.rspmm import degree, generalized_rspmm, rspmm_from_graph
from ultra_tpu_torch.ops.rspmm_cuda import rspmm_dw, rspmm_sum_drel, rspmm_sum_dx, rspmm_sum_fwd
from ultra_tpu_torch.ops.rspmm_minmax_cuda import (
    rspmm_minmax_drel, rspmm_minmax_dx, rspmm_minmax_fwd,
)

TOL = dict(rtol=1e-5, atol=1e-5)
V, R, E, B, D, E_PAD = 70, 11, 300, 2, 16, 384


def make_inputs(seed=0):
    """Edges whose destinations skip every 7th node (rows with no edges),
    10% of weights 0 at build time, and a runtime mask over 5% more."""
    rng = np.random.default_rng(seed)
    dst_pool = np.array([v for v in range(V) if v % 7])
    ei = np.stack([rng.choice(dst_pool, E), rng.integers(0, V, E)]).astype(np.int64)
    et = rng.integers(0, R, E).astype(np.int64)
    ew = rng.uniform(0.5, 1.5, E).astype(np.float32)
    ew[rng.random(E) < 0.1] = 0.0
    rel = rng.normal(size=(R, B, D)).astype(np.float32)
    x = rng.normal(size=(V, B, D)).astype(np.float32)
    mask = np.concatenate([ew, np.zeros(E_PAD - E, np.float32)])
    mask[rng.choice(E, E // 20, replace=False)] = 0.0
    return ei, et, ew, rel, x, mask


def port_graph(ei, et, ew):
    return make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD, device="cpu")


def test_csr_holds_live_edge_multiset():
    ei, et, ew, *_ = make_inputs()
    csr = port_graph(ei, et, ew).csr
    rowptr = csr.rowptr.numpy()
    assert rowptr[0] == 0 and np.all(np.diff(rowptr) >= 0)
    dst = np.repeat(np.arange(V), np.diff(rowptr))
    got = sorted(zip(dst, csr.col.tolist(), csr.etype.tolist(), csr.eid.tolist()))
    live = np.nonzero(ew)[0]
    want = sorted(zip(ei[0, live], ei[1, live], et[live], live))
    assert got == want
    assert csr.col.dtype == csr.etype.dtype == csr.eid.dtype == torch.int32


@pytest.mark.parametrize("n, multiple, growth",
                         [(1, 2048, 1.0), (2048, 2048, 1.0), (544230, 8192, 1.0),
                          (31416, 2048, 1.3)])
def test_pad_bucket_matches_jax(n, multiple, growth):
    assert pad_bucket(n, multiple, growth) == jax_pad_bucket(n, multiple, growth)


@pytest.mark.parametrize("mul", ["mul", "add"])
def test_rspmm_matches_xla_and_pallas(mul):
    ei, et, ew, rel, x, mask = make_inputs()
    graph = port_graph(ei, et, ew).replace_weights(torch.from_numpy(mask))
    with torch.no_grad():
        out = rspmm_from_graph(
            graph, torch.from_numpy(rel), torch.from_numpy(x), mul=mul
        ).numpy()
    assert out.shape == (V, B, D)
    assert np.all(out[::7] == 0.0)  # rows with no edges

    want = jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask[:E]), jnp.asarray(rel),
        jnp.asarray(x), sum="add", mul=mul, backend="xla",
    )
    np.testing.assert_allclose(out, np.asarray(want), **TOL)

    jgraph = attach_plans(
        jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD), rb=32, chunk=64
    )
    w_ext = jnp.concatenate([jnp.asarray(mask), jnp.zeros((1,), jnp.float32)])
    rel_f, x_f = jnp.asarray(rel.reshape(R, -1)), jnp.asarray(x.reshape(V, -1))
    v1 = rspmm_pallas_fwd(jgraph.plans.dst, rel_f, x_f, w_ext, mul=mul, out_rows=V)
    v2 = rspmm_v2_fwd(jgraph.plans.v2, rel_f, x_f, w_ext, mul=mul, out_rows=V)
    for pallas in (v1, v2):
        np.testing.assert_allclose(
            out.reshape(V, -1), np.asarray(pallas)[:V], **TOL
        )


def test_generalized_rspmm_on_raw_edges_matches_xla():
    ei, et, ew, rel, x, _ = make_inputs(seed=1)
    with torch.no_grad():
        out = generalized_rspmm(
            torch.from_numpy(ei), torch.from_numpy(et), torch.from_numpy(ew),
            torch.from_numpy(rel[:, :1]), torch.from_numpy(x),  # relation broadcasts over B
        )
    want = jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), jnp.asarray(ew),
        jnp.asarray(np.broadcast_to(rel[:, :1], rel.shape)), jnp.asarray(x),
        backend="xla",
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_degree_matches_jax():
    ei, et, ew, *_ = make_inputs()
    want = jax_degree(jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD))
    np.testing.assert_array_equal(degree(port_graph(ei, et, ew)).numpy(), np.asarray(want))


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    ei, et, ew, rel, x, _ = make_inputs()
    graph = port_graph(ei, et, ew)
    rel_f = torch.from_numpy(rel.reshape(R, -1))
    x_f = torch.from_numpy(x.reshape(V, -1))
    before = dict(rspmm_sum_fwd.launches)
    out = rspmm_sum_fwd(graph.csr, graph.edge_weight, rel_f, x_f, "mul")
    plain = rspmm_cuda.rspmm_sum_fwd_plain(graph.csr, graph.edge_weight, rel_f, x_f, "mul")
    assert torch.equal(out, plain)
    assert rspmm_sum_fwd.launches == before == {}

    w, k = graph.edge_weight, rspmm_minmax_cuda
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(V, B * D)).astype(np.float32))
    out = rspmm_minmax_fwd(graph.csr, w, rel_f, x_f, "add", True)
    assert torch.equal(out, k.rspmm_minmax_fwd_plain(graph.csr, w, rel_f, x_f, "add", True))
    assert torch.equal(rspmm_minmax_dx(graph.csr_src, w, rel_f, x_f, g, out, "add"),
                       k.rspmm_minmax_dx_plain(graph.csr_src, w, rel_f, x_f, g, out, "add"))
    assert torch.equal(rspmm_minmax_drel(graph.segments, w, rel_f, x_f, g, out, "add"),
                       k.rspmm_minmax_drel_plain(graph.segments, w, rel_f, x_f, g, out, "add"))
    assert rspmm_minmax_fwd.launches == rspmm_minmax_dx.launches == {}
    assert rspmm_minmax_drel.launches == {}
    for minmax_out in (None, out):
        assert torch.equal(rspmm_dw(graph.csr, w, rel_f, x_f, g, "add", minmax_out),
                           rspmm_cuda.rspmm_dw_plain(graph.csr, w, rel_f, x_f, g, "add",
                                                     minmax_out))
    assert rspmm_dw.launches == {}


def _meta_calls(graph, feat, offset=0):
    """Each kernel wrapper on meta tensors (a device other than the CPU) of
    width ``feat`` whose rows start ``offset`` floats into their storage."""
    csr, csr_src, seg = (l.to("meta") for l in (graph.csr, graph.csr_src, graph.segments))
    x = torch.empty(V * feat + offset, device="meta")[offset:].view(V, feat)
    w, rel_rows = torch.empty(E_PAD, device="meta"), torch.empty(R, feat, device="meta")
    return (lambda: rspmm_sum_fwd(csr, w, rel_rows, x),
            lambda: rspmm_sum_dx(csr_src, w, rel_rows, x),
            lambda: rspmm_sum_drel(seg, w, x, x),
            lambda: rspmm_minmax_fwd(csr, w, rel_rows, x, "mul", False),
            lambda: rspmm_minmax_dx(csr_src, w, rel_rows, x, x, x),
            lambda: rspmm_minmax_drel(seg, w, rel_rows, x, x, x),
            lambda: rspmm_dw(csr, w, rel_rows, x, x),
            lambda: rspmm_dw(csr, w, rel_rows, x, x, "mul", x))


def _no_launches():
    return all(not f.launches for f in (rspmm_sum_fwd, rspmm_sum_dx, rspmm_sum_drel,
                                         rspmm_minmax_fwd, rspmm_minmax_dx, rspmm_minmax_drel,
                                         rspmm_dw))


def test_device_tensor_without_kernel_library_raises(monkeypatch, tmp_path):
    """A tensor off the CPU never takes the plain version: with no built
    library and no nvcc to build one, the wrapper raises."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "_BUILD", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(rspmm_cuda, "_KERNELS", {})
    ei, et, ew, *_ = make_inputs()
    for call in _meta_calls(port_graph(ei, et, ew), B * D):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert _no_launches()


@pytest.mark.parametrize("feat, offset", [(30, 0), (32, 1)])
def test_device_tensor_off_the_float4_layout_is_refused(monkeypatch, feat, offset):
    """The kernel loads float4 only: a width that is not a multiple of 4, or
    a row start that is not 16-byte aligned, raises before any launch."""
    monkeypatch.setattr(rspmm_cuda, "_kernel", lambda name: lambda *_: pytest.fail("launched"))
    ei, et, ew, *_ = make_inputs()
    for call in _meta_calls(port_graph(ei, et, ew), feat, offset):
        with pytest.raises(ValueError, match="F % 4|16-byte"):
            call()
    assert _no_launches()


def test_bf16_operands_and_gradients_are_refused():
    """The operand types of ``compute_dtype: bfloat16``: bf16 relation and x
    rows are taken (an f32 output, bf16 ``d_rel``/``d_x``); a bf16 output
    gradient or saved output, bf16 edge weights, float16 or f64 rows and a
    pair of row types no kernel instance takes raise at every wrapper; an
    f32 gradient for the edge weights is given (B6), for every
    aggregator."""
    ei, et, ew, rel, x, _ = make_inputs()
    graph = port_graph(ei, et, ew)
    rel16 = torch.from_numpy(rel).bfloat16().requires_grad_()
    x16 = torch.from_numpy(x).bfloat16().requires_grad_()
    for sum_op in ("add", "max", "min"):
        out = rspmm_from_graph(graph, rel16, x16, sum=sum_op)
        assert out.dtype == torch.float32
        d_rel, d_x = torch.autograd.grad(out[out.isfinite()].sum(), (rel16, x16))
        assert d_rel.dtype == d_x.dtype == torch.bfloat16
    rel_f, x_f = torch.from_numpy(rel.reshape(R, -1)), torch.from_numpy(x.reshape(V, -1))
    w, g16 = graph.edge_weight, x_f.bfloat16()
    for call in (lambda: rspmm_sum_dx(graph.csr_src, w, rel_f, g16),
                 lambda: rspmm_sum_drel(graph.segments, w, x_f, g16),
                 lambda: rspmm_dw(graph.csr, w, rel_f, x_f, g16),
                 lambda: rspmm_dw(graph.csr, w, rel_f, x_f, x_f, "mul", g16),
                 lambda: rspmm_minmax_dx(graph.csr_src, w, rel_f, x_f, g16, x_f),
                 lambda: rspmm_minmax_drel(graph.segments, w, rel_f, x_f, x_f, g16),
                 lambda: rspmm_sum_fwd(graph.csr, w.bfloat16(), rel_f, x_f),
                 lambda: rspmm_minmax_fwd(graph.csr, w.bfloat16(), rel_f, x_f)):
        with pytest.raises(TypeError, match="takes float32 (g|out|edge_weight)"):
            call()
    with pytest.raises(TypeError, match="no instance"):  # built for the paths' pairs only
        rspmm_sum_fwd(graph.csr, w, rel_f, x_f.bfloat16())
    for dtype in (torch.float16, torch.float64):
        for call in (lambda: rspmm_sum_fwd(graph.csr, w, rel_f.to(dtype), x_f),
                     lambda: rspmm_sum_fwd(graph.csr, w, rel_f, x_f.to(dtype)),
                     lambda: rspmm_sum_drel(graph.segments, w, x_f.to(dtype), x_f),
                     lambda: rspmm_minmax_fwd(graph.csr, w, rel_f, x_f.to(dtype)),
                     lambda: rspmm_dw(graph.csr, w, rel_f.to(dtype), x_f, x_f)):
            with pytest.raises(TypeError, match="float32 or bfloat16"):
                call()
    assert _no_launches()
    weighted = graph.replace_weights(graph.edge_weight.clone().requires_grad_())
    for sum_op in ("add", "max", "min"):
        out = rspmm_from_graph(weighted, torch.from_numpy(rel), torch.from_numpy(x), sum=sum_op)
        (d_w,) = torch.autograd.grad(out[out.isfinite()].sum(), weighted.edge_weight)
        assert d_w.dtype == torch.float32 and d_w.shape == (E_PAD,) and d_w.abs().sum() > 0
        with torch.no_grad():  # no gradient asked for: the weights may require one
            rspmm_from_graph(weighted, torch.from_numpy(rel), torch.from_numpy(x), sum=sum_op)


def test_transposed_csr_and_type_segments_hold_live_edge_multiset():
    ei, et, ew, *_ = make_inputs()
    graph = port_graph(ei, et, ew)
    live = np.nonzero(ew)[0]
    want = sorted(zip(ei[0, live], ei[1, live], et[live], live))

    csr_src = graph.csr_src
    src = np.repeat(np.arange(V), np.diff(csr_src.rowptr.numpy()))
    got = sorted(zip(csr_src.col.tolist(), src, csr_src.etype.tolist(), csr_src.eid.tolist()))
    assert got == want

    seg = graph.segments
    got = sorted(zip(seg.dst.tolist(), seg.src.tolist(), seg.etype.tolist(), seg.eid.tolist()))
    assert got == want
    assert np.all(np.diff(seg.etype.numpy()) >= 0)  # type-sorted


def _jax_grads(fn, rel, x, g):
    _, vjp = jax.vjp(fn, jnp.asarray(rel), jnp.asarray(x))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("reference", ["xla", "pallas_v1", "pallas_v2"])
@pytest.mark.parametrize("mul", ["mul", "add"])
def test_rspmm_gradients_match_jax(mul, reference):
    """d_rel and d_x of the port's Function against jax.vjp: of the XLA
    backend, and of the Pallas custom VJP without (``_rel_grad_kernel``,
    the v1 forward on the source plan) and with (``_drel_kernel`` /
    ``_drel_add_kernel``, the v2 forward on the source plan) v2 plans."""
    ei, et, ew, rel, x, mask = make_inputs(seed=2)
    g = np.random.default_rng(5).normal(size=(V, B, D)).astype(np.float32)
    graph = port_graph(ei, et, ew).replace_weights(torch.from_numpy(mask))
    rel_t = torch.from_numpy(rel).requires_grad_()
    x_t = torch.from_numpy(x).requires_grad_()
    rspmm_from_graph(graph, rel_t, x_t, mul=mul).backward(torch.from_numpy(g))

    if reference == "xla":
        fn = lambda r, xx: jax_generalized_rspmm(
            jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask[:E]), r, xx,
            sum="add", mul=mul, backend="xla")
    else:
        jgraph = attach_plans(jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD),
                              rb=32, chunk=64, v2=reference == "pallas_v2")
        jgraph = jgraph.replace_weights(jnp.asarray(mask))
        fn = lambda r, xx: jax_rspmm_from_graph(jgraph, r, xx, mul=mul)
    want_rel, want_x = _jax_grads(fn, rel, x, g)
    np.testing.assert_allclose(rel_t.grad.numpy(), want_rel, **TOL)
    np.testing.assert_allclose(x_t.grad.numpy(), want_x, **TOL)
    assert np.all(rel_t.grad.numpy()[np.bincount(et[mask[:E] != 0], minlength=R) == 0] == 0)


def test_broadcast_relation_gradient_sums_over_the_batch():
    """A (R, 1, D) relation is materialised to (R, B*D) rows before the
    Function, so its gradient is the batch sum, as jax.vjp of the
    broadcast gives."""
    ei, et, ew, rel, x, _ = make_inputs(seed=4)
    g = np.random.default_rng(6).normal(size=(V, B, D)).astype(np.float32)
    rel1 = rel[:, :1]
    rel_t = torch.from_numpy(rel1.copy()).requires_grad_()
    x_t = torch.from_numpy(x).requires_grad_()
    generalized_rspmm(torch.from_numpy(ei), torch.from_numpy(et), torch.from_numpy(ew),
                      rel_t, x_t).backward(torch.from_numpy(g))
    fn = lambda r, xx: jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), jnp.asarray(ew), jnp.broadcast_to(r, (R, B, D)),
        xx, backend="xla")
    want_rel, want_x = _jax_grads(fn, rel1, x, g)
    np.testing.assert_allclose(rel_t.grad.numpy(), want_rel, **TOL)
    np.testing.assert_allclose(x_t.grad.numpy(), want_x, **TOL)


@pytest.mark.parametrize("mul", ["mul", "add"])
def test_gradient_wrappers_match_the_pallas_kernels(mul):
    """The two backward wrappers called directly, against the TPU kernels
    they replace: B1 on the source-major CSR against the v1 forward on the
    source plan, B2 against ``rspmm_pallas_rel_grad`` and
    ``rspmm_v2_drel`` / ``rspmm_v2_drel_add``."""
    ei, et, ew, rel, x, mask = make_inputs(seed=3)
    g = np.random.default_rng(7).normal(size=(V, B * D)).astype(np.float32)
    graph = port_graph(ei, et, ew)
    w = torch.from_numpy(mask)
    rel_f, x_f, g_t = (torch.from_numpy(a) for a in (rel.reshape(R, -1), x.reshape(V, -1), g))
    d_x = rspmm_sum_dx(graph.csr_src, w, rel_f, g_t, mul).numpy()
    d_rel = rspmm_sum_drel(graph.segments, w, x_f, g_t, mul).numpy()

    plans = attach_plans(jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD),
                         rb=32, chunk=64).plans
    w_ext = jnp.concatenate([jnp.asarray(mask), jnp.zeros((1,), jnp.float32)])
    rel_j = jnp.asarray(rel_f.numpy()) if mul == "mul" else jnp.ones((R, B * D), jnp.float32)
    want_x = rspmm_pallas_fwd(plans.src, rel_j, jnp.asarray(g), w_ext, mul="mul", out_rows=V)
    np.testing.assert_allclose(d_x, np.asarray(want_x)[:V], **TOL)
    x_j, g_j = jnp.asarray(x_f.numpy()), jnp.asarray(g)
    v2 = (rspmm_v2_drel(plans.v2, x_j, g_j, w_ext, R) if mul == "mul"
          else rspmm_v2_drel_add(plans.v2, g_j, w_ext, R))
    for want in (rspmm_pallas_rel_grad(plans.dst, x_j, g_j, w_ext, R, mul=mul), v2):
        np.testing.assert_allclose(d_rel, np.asarray(want)[:R], **TOL)


def test_backward_computes_only_the_gradients_asked_for(monkeypatch):
    """x without a gradient skips the input-gradient wrapper; a relation
    without one skips the relation-gradient wrapper (sum and max)."""
    ei, et, ew, rel, x, _ = make_inputs()
    graph = port_graph(ei, et, ew)
    calls = []
    for name in ("rspmm_sum_dx", "rspmm_sum_drel", "rspmm_minmax_dx", "rspmm_minmax_drel"):
        real = getattr(rspmm, name)
        monkeypatch.setattr(rspmm, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    for sum_op in ("add", "max"):
        for needs in ("relation", "x"):
            rel_t = torch.from_numpy(rel).requires_grad_(needs == "relation")
            x_t = torch.from_numpy(x).requires_grad_(needs == "x")
            out = rspmm_from_graph(graph, rel_t, x_t, sum=sum_op)
            out[out.isfinite()].sum().backward()
    assert calls == ["rspmm_sum_drel", "rspmm_sum_dx", "rspmm_minmax_drel", "rspmm_minmax_dx"]
    assert _no_launches()  # CPU: plain versions


# ---------------------------------------------------------------------------
# min/max


MASKED_ROW = 1  # every edge into this row is masked at run time


def make_tie_inputs(seed=0):
    """Tie-heavy inputs: relation and x drawn from {-2..2}, a quarter of x's
    rows 0 (every message from them is 0 for mul, rel for add), weights from
    {0.5, 1, 2} with 10% 0 at build time, a runtime mask over 5% more and
    over every edge into MASKED_ROW, and rows with no edges (every 7th)."""
    ei, et, _, _, _, _ = make_inputs(seed)
    rng = np.random.default_rng(seed + 100)
    ew = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), E)
    ew[rng.random(E) < 0.1] = 0.0
    rel = rng.integers(-2, 3, size=(R, B, D)).astype(np.float32)
    x = rng.integers(-2, 3, size=(V, B, D)).astype(np.float32)
    x[rng.random(V) < 0.25] = 0.0
    mask = np.concatenate([ew, np.zeros(E_PAD - E, np.float32)])
    mask[rng.choice(E, E // 20, replace=False)] = 0.0
    mask[:E][ei[0] == MASKED_ROW] = 0.0
    assert (ew[ei[0] == MASKED_ROW] != 0).any()  # masked at run time, not at build
    return ei, et, ew, rel, x, mask


def _w_ext(mask):
    return jnp.concatenate([jnp.asarray(mask), jnp.zeros((1,), jnp.float32)])


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("sum_op", ["max", "min"])
def test_min_max_forward_matches_xla_and_pallas(sum_op, mul):
    """B3's plain version against the XLA backend and both Pallas forwards
    (``_minmax_kernel``, ``_minmax_kernel_v2``), value for value, the +-inf
    rows of rows with no live edge included."""
    ei, et, ew, rel, x, mask = make_tie_inputs()
    graph = port_graph(ei, et, ew).replace_weights(torch.from_numpy(mask))
    with torch.no_grad():
        out = rspmm_from_graph(graph, torch.from_numpy(rel), torch.from_numpy(x),
                               sum=sum_op, mul=mul).numpy()
    fill = np.inf if sum_op == "min" else -np.inf
    assert np.all(out[::7] == fill) and np.all(out[MASKED_ROW] == fill)
    assert np.isfinite(out).mean() > 0.7

    want = jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask[:E]), jnp.asarray(rel),
        jnp.asarray(x), sum=sum_op, mul=mul, backend="xla",
    )
    np.testing.assert_array_equal(out, np.asarray(want))
    plans = attach_plans(jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD),
                         rb=32, chunk=64).plans
    rel_f, x_f = jnp.asarray(rel.reshape(R, -1)), jnp.asarray(x.reshape(V, -1))
    kw = dict(mul=mul, is_min=sum_op == "min", out_rows=V)
    for pallas in (rspmm_pallas_minmax_fwd(plans.dst, rel_f, x_f, _w_ext(mask), **kw),
                   rspmm_v2_minmax(plans.v2, rel_f, x_f, _w_ext(mask), **kw)):
        np.testing.assert_array_equal(out.reshape(V, -1), np.asarray(pallas)[:V])


@pytest.mark.parametrize("reference", ["xla", "pallas_v1", "pallas_v2"])
@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("sum_op", ["max", "min"])
def test_min_max_gradients_match_jax(sum_op, mul, reference):
    """d_rel and d_x of the port's min/max Function on tie-heavy inputs
    against jax.vjp: of the XLA backend, and of the Pallas custom VJP with
    v1 plans (``_minmax_dx_kernel``, ``_minmax_drel_kernel``) and with v2
    plans (``_minmax_dx_kernel_v2``, ``_minmax_drel_kernel_v2``). Each
    routes the gradient to every tying edge."""
    ei, et, ew, rel, x, mask = make_tie_inputs(seed=1)
    g = np.random.default_rng(5).normal(size=(V, B, D)).astype(np.float32)
    graph = port_graph(ei, et, ew).replace_weights(torch.from_numpy(mask))
    rel_t = torch.from_numpy(rel).requires_grad_()
    x_t = torch.from_numpy(x).requires_grad_()
    rspmm_from_graph(graph, rel_t, x_t, sum=sum_op, mul=mul).backward(torch.from_numpy(g))

    if reference == "xla":
        fn = lambda r, xx: jax_generalized_rspmm(
            jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask[:E]), r, xx,
            sum=sum_op, mul=mul, backend="xla")
    else:
        jgraph = attach_plans(jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD),
                              rb=32, chunk=64, v2=reference == "pallas_v2")
        jgraph = jgraph.replace_weights(jnp.asarray(mask))
        fn = lambda r, xx: jax_rspmm_from_graph(jgraph, r, xx, sum=sum_op, mul=mul)
    want_rel, want_x = _jax_grads(fn, rel, x, g)
    np.testing.assert_allclose(rel_t.grad.numpy(), want_rel, **TOL)
    np.testing.assert_allclose(x_t.grad.numpy(), want_x, **TOL)


def test_every_tying_edge_gets_the_whole_gradient():
    """Two edges into one row with the same message: each gets all of g,
    where scatter_reduce's own gradient would give each half."""
    ei = np.array([[0, 0, 1], [1, 2, 2]])  # row 0 from nodes 1 and 2, row 1 from 2
    graph = make_graph(ei, np.zeros(3, np.int64), 3, 1, device="cpu")
    rel = torch.ones(1, 1, 4, requires_grad=True)
    x = torch.tensor([[[0.0, 0, 0, 0]], [[3.0, 1, 2, 5]], [[3.0, 2, 2, 5]]],
                     requires_grad=True)
    out = rspmm_from_graph(graph, rel, x, sum="max")
    out.backward(torch.tensor([[[1.0, 1, 1, 1]], [[10.0, 10, 10, 10]], [[7.0, 7, 7, 7]]]))
    assert out[2].isinf().all()
    torch.testing.assert_close(x.grad[1], torch.tensor([[1.0, 0, 1, 1]]), rtol=0, atol=0)
    torch.testing.assert_close(x.grad[2], torch.tensor([[11.0, 11, 11, 11]]), rtol=0, atol=0)
    torch.testing.assert_close(rel.grad, torch.tensor([[[36.0, 22, 24, 60]]]), rtol=0, atol=0)


def _pallas_minmax_backward(ei, et, ew, rel_f, x_f, g, out, mask, mul, is_min):
    """d_x and d_rel from the four TPU min/max backward kernels, called as
    ``_minmax_vjp_bwd`` calls them: (v1 d_x, v1 d_rel, v2 d_x, v2 d_rel)."""
    plans = attach_plans(jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD),
                         rb=32, chunk=64).plans
    f = rel_f.shape[1]
    f_blk, prec, w_ext = min(512, f), _prec(None), _w_ext(mask)
    out2 = jnp.where(jnp.isinf(out), (-1.0 if not is_min else 1.0) * 1e38, out)
    rel_j, x_j, g_j = jnp.asarray(rel_f), jnp.asarray(x_f), jnp.asarray(g)

    def pad(a, rows):
        return jnp.pad(a, ((0, rows - a.shape[0]), (0, 0)))

    p = plans.src
    kern = functools.partial(_minmax_dx_kernel, mul, p.chunk, p.rb_reduce, p.rb_gather,
                             jnp.float32, prec)
    d_x = _minmax_bwd_call(kern, p, pad(x_j, p.n_reduce_pad), pad(g_j, p.n_gather_pad),
                           pad(out2, p.n_gather_pad), pad(rel_j, p.r_pad),
                           jnp.take(w_ext, p.perm, axis=0), p.n_reduce_pad, V, f, f_blk)
    d_x = jnp.where(jnp.repeat(p.covered, p.rb_reduce)[:, None] > 0, d_x, 0.0)[:V]
    p = plans.dst
    kern = functools.partial(_minmax_drel_kernel, mul, p.chunk, p.rb_reduce, p.rb_gather,
                             jnp.float32, prec)
    d_rel = _drel_call(kern, p, pad(x_j, p.n_gather_pad), pad(g_j, p.n_reduce_pad),
                       pad(out2, p.n_reduce_pad), pad(rel_j, p.r_pad),
                       jnp.take(w_ext, p.perm, axis=0), f, f_blk)[:R]
    v2_dx = rspmm_v2_minmax_dx(plans.v2src, rel_j, g_j, out2, x_j, w_ext, mul=mul,
                               out_rows=V)
    v2_drel = rspmm_v2_minmax_drel(plans.v2, x_j, g_j, out2, w_ext, R, rel_j, mul=mul)
    return [np.asarray(a)[:n] for a, n in ((d_x, V), (d_rel, R), (v2_dx, V), (v2_drel, R))]


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("sum_op", ["max", "min"])
def test_min_max_gradient_wrappers_match_the_pallas_kernels(sum_op, mul):
    """The B4 and B5 wrappers called directly, with the forward's saved
    output, against the TPU kernels they replace: ``_minmax_dx_kernel``
    through ``_minmax_bwd_call``, ``_minmax_drel_kernel`` through
    ``_drel_call``, ``rspmm_v2_minmax_dx`` and ``rspmm_v2_minmax_drel``."""
    ei, et, ew, rel, x, mask = make_tie_inputs(seed=2)
    g = np.random.default_rng(7).normal(size=(V, B * D)).astype(np.float32)
    graph = port_graph(ei, et, ew)
    w = torch.from_numpy(mask)
    rel_f, x_f, g_t = (torch.from_numpy(a) for a in (rel.reshape(R, -1), x.reshape(V, -1), g))
    out = rspmm_minmax_fwd(graph.csr, w, rel_f, x_f, mul, sum_op == "min")
    d_x = rspmm_minmax_dx(graph.csr_src, w, rel_f, x_f, g_t, out, mul).numpy()
    d_rel = rspmm_minmax_drel(graph.segments, w, rel_f, x_f, g_t, out, mul).numpy()
    assert np.abs(d_x).sum() > 0 and np.abs(d_rel).sum() > 0

    v1_dx, v1_drel, v2_dx, v2_drel = _pallas_minmax_backward(
        ei, et, ew, rel_f.numpy(), x_f.numpy(), g, jnp.asarray(out.numpy()), mask, mul,
        sum_op == "min")
    for want in (v1_dx, v2_dx):
        np.testing.assert_allclose(d_x, want, **TOL)
    for want in (v1_drel, v2_drel):
        np.testing.assert_allclose(d_rel, want, **TOL)


# ---------------------------------------------------------------------------
# edge-weight gradient (B6)


@pytest.mark.parametrize("reference", ["xla", "pallas_v1", "pallas_v2"])
@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("sum_op", ["add", "max", "min"])
def test_edge_weight_gradient_matches_jax(sum_op, mul, reference):
    """d_w of the port's Function (B6's plain version) against jax.vjp with
    respect to the weights: of the XLA backend, and of the Pallas custom
    VJPs with precision "highest" (``rspmm_pallas_sum`` and
    ``rspmm_pallas_minmax``, both reaching ``_dw_kernel``) with v1 and with
    v2 plans. Over the edges live when the graph was built: there all three
    give a runtime-masked edge its derivative for sum and 0 for min/max; on
    the padding the port and Pallas give 0 where XLA gives the derivative.
    Min/max inputs are tie-heavy: every tying edge gets its whole term."""
    make = make_inputs if sum_op == "add" else make_tie_inputs
    ei, et, ew, rel, x, mask = make(seed=3)
    g = np.random.default_rng(8).normal(size=(V, B, D)).astype(np.float32)
    w = torch.from_numpy(mask).requires_grad_()
    graph = port_graph(ei, et, ew).replace_weights(w)
    out = rspmm_from_graph(graph, torch.from_numpy(rel), torch.from_numpy(x), sum=sum_op,
                           mul=mul)
    (d_w,) = torch.autograd.grad(out, w, torch.from_numpy(g))
    d_w = d_w.numpy()
    built = np.concatenate([ew != 0, np.zeros(E_PAD - E, bool)])
    assert np.all(d_w[~built] == 0)
    if sum_op != "add":
        assert np.all(d_w[built & (mask == 0)] == 0)  # the route asks for a live edge

    rel_j, x_j = jnp.asarray(rel), jnp.asarray(x)
    if reference == "xla":
        fn = lambda ww: jax_generalized_rspmm(
            jnp.asarray(ei), jnp.asarray(et), ww, rel_j, x_j, sum=sum_op, mul=mul,
            backend="xla")
        w_j = jnp.asarray(mask[:E])
    else:
        jgraph = attach_plans(jax_make_graph(ei, et, V, R, edge_weight=ew, pad_to=E_PAD),
                              rb=32, chunk=64, v2=reference == "pallas_v2")
        fn = lambda ww: jax_rspmm_from_graph(jgraph.replace_weights(ww), rel_j, x_j,
                                             sum=sum_op, mul=mul, precision="highest")
        w_j = jnp.asarray(mask)
    _, vjp = jax.vjp(fn, w_j)
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    live = built[:len(want)]
    np.testing.assert_allclose(d_w[:len(want)][live], want[live], **TOL)
    assert np.abs(want[live]).sum() > 0
    if reference != "xla":  # Pallas: plan-dead slots are 0, as the port's
        np.testing.assert_array_equal(want[~live], 0)


@pytest.mark.parametrize("mul", ["mul", "add"])
def test_edge_weight_gradient_gives_each_tying_edge_its_whole_term(mul):
    """Three edges into one row, two of them with equal messages that tie
    for the max at every feature: each tying edge gets its whole term
    m * g, the third none of it; a runtime-masked tying edge gets 0."""
    ei = np.array([[0, 0, 0], [1, 2, 3]])
    graph = make_graph(ei, np.zeros(3, np.int64), 4, 1, device="cpu")
    rel = torch.ones(1, 1, 4)
    x = torch.tensor([[[0.0] * 4], [[2.0, 1, 3, 4]], [[2.0, 1, 3, 4]], [[1.0, 0, 2, 3]]])
    g = torch.tensor([[[1.0, 2, 3, 4]], [[0.0] * 4], [[0.0] * 4], [[0.0] * 4]])
    m = (x + 1) if mul == "add" else x
    term = float((m[1] * g[0]).sum())
    for weights, want in (([1.0, 1.0, 1.0], [term, term, 0.0]),
                          ([1.0, 0.0, 1.0], [term, 0.0, 0.0])):
        w = torch.tensor(weights, requires_grad=True)
        out = rspmm_from_graph(graph.replace_weights(w), rel, x, sum="max", mul=mul)
        (d_w,) = torch.autograd.grad(out[:1], w, g[:1])
        assert d_w.tolist() == want


def test_weight_gradient_only_when_asked(monkeypatch):
    """The edge-weight gradient runs only for weights that need one, and
    then alone when nothing else does."""
    ei, et, ew, rel, x, _ = make_inputs()
    graph = port_graph(ei, et, ew)
    calls = []
    for name in ("rspmm_dw", "rspmm_sum_dx", "rspmm_sum_drel", "rspmm_minmax_dx",
                 "rspmm_minmax_drel"):
        real = getattr(rspmm, name)
        monkeypatch.setattr(rspmm, name,
                            lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    for sum_op in ("add", "max"):
        x_t = torch.from_numpy(x).requires_grad_()
        out = rspmm_from_graph(graph, torch.from_numpy(rel), x_t, sum=sum_op)
        out[out.isfinite()].sum().backward()
        w = graph.edge_weight.clone().requires_grad_()
        out = rspmm_from_graph(graph.replace_weights(w), torch.from_numpy(rel),
                               torch.from_numpy(x), sum=sum_op)
        out[out.isfinite()].sum().backward()
    assert calls == ["rspmm_sum_dx", "rspmm_dw", "rspmm_minmax_dx", "rspmm_dw"]

"""The port's edge layouts and sum rspmm (``ultra_tpu_torch``) with its
gradients against the JAX package: the XLA backend (``jax.vjp``) and the
Pallas kernels in interpret mode on the CPU: both forwards (v1, v2), the
input gradient on the source plan, and the three relation-gradient kernels
(``_rel_grad_kernel``, ``_drel_kernel``, ``_drel_add_kernel``). Inputs hold
weight-0 edges, a runtime weight mask and rows with no edges.

Tolerance: f32, rtol 1e-5 and atol 1e-5, because the two packages sum each
row's (or each type's) terms in different orders.
"""

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
from ultra_tpu.ops.rspmm_pallas import attach_plans, rspmm_pallas_fwd, rspmm_pallas_rel_grad
from ultra_tpu.ops.rspmm_pallas_v2 import rspmm_v2_drel, rspmm_v2_drel_add, rspmm_v2_fwd
from ultra_tpu_torch.graph import SEGMENT_CHUNK, make_graph, pad_bucket
from ultra_tpu_torch.ops import build, rspmm, rspmm_cuda
from ultra_tpu_torch.ops.rspmm import degree, generalized_rspmm, rspmm_from_graph
from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_drel, rspmm_sum_dx, rspmm_sum_fwd

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


def test_device_tensor_without_kernel_library_raises(monkeypatch, tmp_path):
    """A tensor off the CPU never takes the plain version: with no built
    library and no nvcc to build one, the wrapper raises."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "_BUILD", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(rspmm_cuda, "_KERNELS", {})
    ei, et, ew, rel, x, _ = make_inputs()
    graph = port_graph(ei, et, ew)
    csr, csr_src, seg = (l.to("meta") for l in (graph.csr, graph.csr_src, graph.segments))
    w, rows = torch.empty(E_PAD, device="meta"), torch.empty(V, B * D, device="meta")
    rel_rows = torch.empty(R, B * D, device="meta")
    for call in (lambda: rspmm_sum_fwd(csr, w, rel_rows, rows),
                 lambda: rspmm_sum_dx(csr_src, w, rel_rows, rows),
                 lambda: rspmm_sum_drel(seg, w, rows, rows)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert rspmm_sum_fwd.launches == rspmm_sum_dx.launches == rspmm_sum_drel.launches == {}


@pytest.mark.parametrize("feat, offset", [(30, 0), (32, 1)])
def test_device_tensor_off_the_float4_layout_is_refused(monkeypatch, feat, offset):
    """The kernel loads float4 only: a width that is not a multiple of 4, or
    a row start that is not 16-byte aligned, raises before any launch."""
    monkeypatch.setattr(rspmm_cuda, "_kernel", lambda name: lambda *_: pytest.fail("launched"))
    ei, et, ew, *_ = make_inputs()
    graph = port_graph(ei, et, ew)
    csr, csr_src, seg = (l.to("meta") for l in (graph.csr, graph.csr_src, graph.segments))
    x = torch.empty(V * feat + offset, device="meta")[offset:].view(V, feat)
    w, rel_rows = torch.empty(E_PAD, device="meta"), torch.empty(R, feat, device="meta")
    for call in (lambda: rspmm_sum_fwd(csr, w, rel_rows, x),
                 lambda: rspmm_sum_dx(csr_src, w, rel_rows, x),
                 lambda: rspmm_sum_drel(seg, w, x, x)):
        with pytest.raises(ValueError, match="F % 4|16-byte"):
            call()
    assert rspmm_sum_fwd.launches == rspmm_sum_dx.launches == rspmm_sum_drel.launches == {}


@pytest.mark.parametrize("sum_op", ["min", "max"])
def test_min_max_are_not_ported(sum_op):
    ei, et, ew, rel, x, _ = make_inputs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rspmm_from_graph(port_graph(ei, et, ew), torch.from_numpy(rel),
                         torch.from_numpy(x), sum=sum_op)


def test_bf16_operands_and_gradients_are_refused():
    """bf16 operands raise (ROADMAP B1), and so does a gradient for the edge
    weights (ROADMAP B6); gradients for the relation and x are ported."""
    ei, et, ew, rel, x, _ = make_inputs()
    graph = port_graph(ei, et, ew)
    with pytest.raises(TypeError, match="bf16"):
        rspmm_from_graph(graph, torch.from_numpy(rel).bfloat16(),
                         torch.from_numpy(x).bfloat16())
    weighted = graph.replace_weights(graph.edge_weight.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="B6"):
        rspmm_from_graph(weighted, torch.from_numpy(rel), torch.from_numpy(x))
    with torch.no_grad():  # no gradient asked for: the weights may require one
        rspmm_from_graph(weighted, torch.from_numpy(rel), torch.from_numpy(x))


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
    chunkptr, type_chunkptr = seg.chunkptr.numpy(), seg.type_chunkptr.numpy()
    sizes = np.diff(chunkptr)
    assert chunkptr[0] == 0 and chunkptr[-1] == len(live)
    assert np.all((sizes > 0) & (sizes <= SEGMENT_CHUNK))
    counts = np.bincount(et[live], minlength=R)
    for t in range(R):  # the chunks of type t tile exactly its run
        first, last = type_chunkptr[t], type_chunkptr[t + 1]
        assert last - first == -(-counts[t] // SEGMENT_CHUNK)
        assert np.all(seg.etype.numpy()[chunkptr[first]:chunkptr[last]] == t)
        assert chunkptr[last] - chunkptr[first] == counts[t]


def test_segments_chunk_long_type_runs():
    """A type with more edges than a chunk holds spans several chunks."""
    rng = np.random.default_rng(3)
    n = 3 * SEGMENT_CHUNK + 12
    ei = rng.integers(0, V, (2, n))
    et = np.where(np.arange(n) < n - 7, 1, 2)  # type 0 empty, 1 long, 2 short
    seg = make_graph(ei, et, V, 3, device="cpu").segments
    assert seg.type_chunkptr.tolist() == [0, 0, 4, 5]
    assert np.diff(seg.chunkptr.numpy()).tolist() == [SEGMENT_CHUNK] * 3 + [n - 7 - 3 * SEGMENT_CHUNK, 7]


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
    without one skips the relation-gradient wrapper."""
    ei, et, ew, rel, x, _ = make_inputs()
    graph = port_graph(ei, et, ew)
    calls = []
    for name in ("rspmm_sum_dx", "rspmm_sum_drel"):
        real = getattr(rspmm, name)
        monkeypatch.setattr(rspmm, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    for needs in ("relation", "x"):
        rel_t = torch.from_numpy(rel).requires_grad_(needs == "relation")
        x_t = torch.from_numpy(x).requires_grad_(needs == "x")
        rspmm_from_graph(graph, rel_t, x_t).sum().backward()
    assert calls == ["rspmm_sum_drel", "rspmm_sum_dx"]
    assert rspmm_sum_dx.launches == rspmm_sum_drel.launches == {}  # CPU: plain versions

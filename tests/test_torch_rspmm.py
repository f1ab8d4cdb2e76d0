"""The port's CSR and sum rspmm (``ultra_tpu_torch``) against the JAX
package: the XLA backend and both Pallas forward kernels (v1 and v2, in
interpret mode on the CPU). Inputs hold weight-0 edges, a runtime weight
mask and rows with no edges.

Tolerance: f32, rtol 1e-5 and atol 1e-5, because the two packages sum each
row's messages in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu.graph import make_graph as jax_make_graph
from ultra_tpu.graph import pad_bucket as jax_pad_bucket
from ultra_tpu.ops.rspmm import degree as jax_degree
from ultra_tpu.ops.rspmm import generalized_rspmm as jax_generalized_rspmm
from ultra_tpu.ops.rspmm_pallas import attach_plans, rspmm_pallas_fwd
from ultra_tpu.ops.rspmm_pallas_v2 import rspmm_v2_fwd
from ultra_tpu_torch.graph import make_graph, pad_bucket
from ultra_tpu_torch.ops import build, rspmm_cuda
from ultra_tpu_torch.ops.rspmm import degree, generalized_rspmm, rspmm_from_graph
from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd

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
    before = rspmm_sum_fwd.launches
    out = rspmm_sum_fwd(graph.csr, graph.edge_weight, rel_f, x_f, "mul")
    plain = rspmm_cuda.rspmm_sum_fwd_plain(graph.csr, graph.edge_weight, rel_f, x_f, "mul")
    assert torch.equal(out, plain)
    assert rspmm_sum_fwd.launches == before == 0


def test_device_tensor_without_kernel_library_raises(monkeypatch, tmp_path):
    """A tensor off the CPU never takes the plain version: with no built
    library and no nvcc to build one, the wrapper raises."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "_BUILD", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(rspmm_cuda, "_KERNEL", None)
    ei, et, ew, rel, x, _ = make_inputs()
    csr = port_graph(ei, et, ew).csr.to("meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rspmm_sum_fwd(
            csr, torch.empty(E_PAD, device="meta"),
            torch.empty(R, B * D, device="meta"), torch.empty(V, B * D, device="meta"),
        )
    assert rspmm_sum_fwd.launches == 0


@pytest.mark.parametrize("feat, offset", [(30, 0), (32, 1)])
def test_device_tensor_off_the_float4_layout_is_refused(monkeypatch, feat, offset):
    """The kernel loads float4 only: a width that is not a multiple of 4, or
    a row start that is not 16-byte aligned, raises before any launch."""
    monkeypatch.setattr(rspmm_cuda, "_kernel", lambda: lambda *_: pytest.fail("launched"))
    ei, et, ew, *_ = make_inputs()
    csr = port_graph(ei, et, ew).csr.to("meta")
    x = torch.empty(V * feat + offset, device="meta")[offset:].view(V, feat)
    with pytest.raises(ValueError, match="F % 4|16-byte"):
        rspmm_sum_fwd(csr, torch.empty(E_PAD, device="meta"),
                      torch.empty(R, feat, device="meta"), x)
    assert rspmm_sum_fwd.launches == 0


@pytest.mark.parametrize("sum_op", ["min", "max"])
def test_min_max_are_not_ported(sum_op):
    ei, et, ew, rel, x, _ = make_inputs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rspmm_from_graph(port_graph(ei, et, ew), torch.from_numpy(rel),
                         torch.from_numpy(x), sum=sum_op)


def test_bf16_operands_and_gradients_are_refused():
    ei, et, ew, rel, x, _ = make_inputs()
    graph = port_graph(ei, et, ew)
    with pytest.raises(TypeError, match="bf16"):
        rspmm_from_graph(graph, torch.from_numpy(rel).bfloat16(),
                         torch.from_numpy(x).bfloat16())
    with pytest.raises(NotImplementedError, match="backward"):
        rspmm_from_graph(graph, torch.from_numpy(rel).requires_grad_(),
                         torch.from_numpy(x))

"""The CSR's piece table (``ultra_tpu_torch/graph.py``), which B1 and B3
walk on the card, on a power-law graph with weight-0 edges, a runtime mask
that empties one long row, and rows with no edges, with ``ROW_PIECE`` cut
to 4 so that many rows split. The kernels cannot run here, so a plain-torch
emulation of their two passes over the table (a partial per piece, written
to the row or to its slot; then each long row's partials combined in slot
order) is held against the wrappers' plain versions and against the JAX
package's XLA backend.

Tolerance: the sum's emulation in f64 against the plain version in f64
within rtol 1e-12 (only the order of the additions differs); in f32 against
XLA, rtol 1e-5 and atol 1e-5 as in ``test_torch_rspmm.py``. Min/max
exactly: a min or a max is exact whatever the order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu.ops.rspmm import generalized_rspmm as jax_generalized_rspmm
from ultra_tpu_torch import graph as graph_module
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.ops import rspmm_cuda, rspmm_minmax_cuda
from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd_plain
from ultra_tpu_torch.ops.rspmm_minmax_cuda import rspmm_minmax_fwd_plain

PIECE = 4
V, R, E_BASE, F = 60, 6, 400, 8
EMPTY = 10  # the last EMPTY nodes have no edge at all


@pytest.fixture
def small_pieces(monkeypatch):
    monkeypatch.setattr(graph_module, "ROW_PIECE", PIECE)


def power_law_inputs(seed=0):
    """E_BASE edges with Zipf-drawn destinations and uniform sources, and
    their inverses (type + R), so both CSRs have hub rows; 10% of the weights
    0 at build time; a runtime mask over 5% more and over every edge into
    the longest row. Weights from {0.5, 1, 2} and operands from {-2..2}, so
    that min/max messages tie and every message is exact in f32."""
    rng = np.random.default_rng(seed)
    nodes = V - EMPTY
    p = 1.0 / np.arange(1, nodes + 1) ** 1.2
    dst = rng.choice(nodes, E_BASE, p=p / p.sum())
    src = rng.integers(0, nodes, E_BASE)
    ei = np.concatenate([np.stack([dst, src]), np.stack([src, dst])], 1).astype(np.int64)
    et = rng.integers(0, R, E_BASE)
    et = np.concatenate([et, et + R]).astype(np.int64)
    num_edges = ei.shape[1]
    ew = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), num_edges)
    ew[rng.random(num_edges) < 0.1] = 0.0
    mask = ew.copy()
    mask[rng.random(num_edges) < 0.05] = 0.0
    hub = np.bincount(ei[0, ew != 0], minlength=V).argmax()
    mask[ei[0] == hub] = 0.0
    rel = rng.integers(-2, 3, size=(2 * R, F)).astype(np.float32)
    x = rng.integers(-2, 3, size=(V, F)).astype(np.float32)
    return ei, et, ew, mask, rel, x, hub


def port_graph(ei, et, ew):
    return make_graph(ei, et, V, 2 * R, edge_weight=ew, device="cpu")


def layout(graph, name):
    return graph.csr if name == "csr" else graph.csr_src


def emulate(csr, weight, rel, x, mul, agg):
    """The kernels' two passes over ``csr``'s piece table in plain torch,
    in the operands' type: pass 1 reduces each piece's edges into its row
    of the output (a one-piece row) or its slot of the partial rows; pass 2
    combines each long row's slots in order."""
    fill = {"sum": 0.0, "max": float("-inf"), "min": float("inf")}[agg]
    out = torch.full((csr.rowptr.numel() - 1, x.shape[1]), fill, dtype=x.dtype)
    partial = torch.full((csr.num_slots, x.shape[1]), float("nan"), dtype=x.dtype)
    for p in csr.piece_order.tolist():  # the kernels' order; the result does not depend on it
        lo, hi = int(csr.piece_ptr[p]), int(csr.piece_ptr[p + 1])
        r, s = rel[csr.etype[lo:hi].long()], x[csr.col[lo:hi].long()]
        w = weight[csr.eid[lo:hi].long()].unsqueeze(1)
        msg = (r * s if mul == "mul" else r + s) * w
        if agg == "sum":
            acc = msg.sum(0)
        else:
            live = torch.cat([torch.full((1, x.shape[1]), fill, dtype=x.dtype),
                              msg[w[:, 0] != 0]])
            acc = live.amax(0) if agg == "max" else live.amin(0)
        slot = int(csr.piece_slot[p])
        (out[int(csr.piece_row[p])] if slot < 0 else partial[slot]).copy_(acc)
    for i in range(csr.long_rows.numel()):
        parts = partial[int(csr.long_slot_ptr[i]):int(csr.long_slot_ptr[i + 1])]
        combined = {"sum": parts.sum, "max": parts.amax, "min": parts.amin}[agg](0)
        out[int(csr.long_rows[i])] = combined
    assert not partial.isnan().any()  # every slot was written
    return out


@pytest.mark.parametrize("name", ["csr", "csr_src"])
def test_pieces_cover_every_edge_once_in_csr_order(small_pieces, name):
    ei, et, ew, *_ = power_law_inputs()
    csr = layout(port_graph(ei, et, ew), name)
    rowptr, piece_ptr = csr.rowptr.numpy(), csr.piece_ptr.numpy()
    piece_row = csr.piece_row.numpy()
    num_edges = csr.col.numel()
    assert num_edges == int((ew != 0).sum())
    # consecutive pieces tile [0, E): every live edge is in exactly one
    assert piece_ptr[0] == 0 and piece_ptr[-1] == num_edges
    sizes = np.diff(piece_ptr)
    assert np.all(sizes >= 0) and np.all(sizes <= PIECE)
    # rows in order, every row has a piece, and each piece lies in its row
    assert np.all(np.diff(piece_row) >= 0)
    assert np.array_equal(np.unique(piece_row), np.arange(V))
    assert np.all(rowptr[piece_row] <= piece_ptr[:-1])
    assert np.all(piece_ptr[1:] <= rowptr[piece_row + 1])
    assert np.all(sizes[np.diff(rowptr)[piece_row] > 0] > 0)  # only an empty row's is empty
    # the launch order: every piece once, longest first, CSR order among equals
    order = csr.piece_order.numpy()
    assert np.array_equal(np.sort(order), np.arange(len(piece_row)))
    assert np.all(np.diff(sizes[order]) <= 0)
    assert all(np.all(np.diff(order[sizes[order] == n]) > 0) for n in np.unique(sizes))
    assert csr.piece_ptr.dtype == torch.int64 and csr.piece_row.dtype == torch.int32


@pytest.mark.parametrize("name", ["csr", "csr_src"])
def test_long_rows_take_consecutive_unique_slots(small_pieces, name):
    ei, et, ew, *_ = power_law_inputs()
    csr = layout(port_graph(ei, et, ew), name)
    degree = np.diff(csr.rowptr.numpy())
    piece_row, piece_slot = csr.piece_row.numpy(), csr.piece_slot.numpy()
    long_rows = csr.long_rows.numpy()
    assert np.array_equal(long_rows, np.nonzero(degree > PIECE)[0])
    assert len(long_rows) >= 5 and degree.max() > 10 * PIECE and (degree == 0).sum() >= EMPTY
    for row in range(V):
        slots = piece_slot[piece_row == row]
        if degree[row] <= PIECE:
            assert slots.tolist() == [-1]
        else:
            assert len(slots) == -(-degree[row] // PIECE)
            assert np.array_equal(np.diff(slots), np.ones(len(slots) - 1))
    used = piece_slot[piece_slot >= 0]
    assert np.array_equal(np.sort(used), np.arange(csr.num_slots))  # unique, none unused
    long_slot_ptr = csr.long_slot_ptr.numpy()
    assert long_slot_ptr[0] == 0 and long_slot_ptr[-1] == csr.num_slots
    for i, row in enumerate(long_rows):
        assert piece_slot[piece_row == row].tolist() == list(
            range(long_slot_ptr[i], long_slot_ptr[i + 1]))
    assert csr.long_rows.dtype == csr.piece_slot.dtype == torch.int32


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("agg", ["sum", "max", "min"])
@pytest.mark.parametrize("name", ["csr", "csr_src"])
def test_two_passes_equal_the_plain_versions(small_pieces, name, agg, mul):
    ei, et, ew, mask, rel, x, hub = power_law_inputs(seed=1)
    csr = layout(port_graph(ei, et, ew), name)
    w, rel_t, x_t = (torch.from_numpy(a) for a in (mask, rel, x))
    if agg == "sum":
        rng = np.random.default_rng(2)  # values that round, in f64
        rel64, x64 = (torch.from_numpy(rng.normal(size=a.shape)) for a in (rel, x))
        got = emulate(csr, w.double(), rel64, x64, mul, agg)
        want = rspmm_sum_fwd_plain(csr, w.double(), rel64, x64, mul)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    else:
        got = emulate(csr, w, rel_t, x_t, mul, agg)
        want = rspmm_minmax_fwd_plain(csr, w, rel_t, x_t, mul, agg == "min")
        assert torch.equal(got, want)
        if name == "csr":  # the long row whose edges are all masked
            assert got[hub].isinf().all() and hub in csr.long_rows.tolist()
    fill = {"sum": 0.0, "max": float("-inf"), "min": float("inf")}[agg]
    assert (got[V - EMPTY:] == fill).all()  # the rows with no edge


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("agg", ["sum", "max", "min"])
def test_two_passes_match_jax(small_pieces, agg, mul):
    """The emulation on the destination-major CSR in f32 against
    ``generalized_rspmm(backend="xla")`` of the JAX package on the same
    edges and runtime weights."""
    ei, et, ew, mask, rel, x, _ = power_law_inputs(seed=3)
    csr = port_graph(ei, et, ew).csr
    got = emulate(csr, torch.from_numpy(mask), torch.from_numpy(rel), torch.from_numpy(x),
                  mul, agg).numpy()
    want = np.asarray(jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask), jnp.asarray(rel[:, None]),
        jnp.asarray(x[:, None]), sum="add" if agg == "sum" else agg, mul=mul,
        backend="xla"))[:, 0]
    if agg == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field, module, call", [
    ("piece_slot", rspmm_cuda, "rspmm_sum_fwd"),
    ("long_slot_ptr", rspmm_minmax_cuda, "rspmm_minmax_fwd"),
])
def test_a_piece_table_of_the_wrong_length_is_refused(monkeypatch, small_pieces, field,
                                                      module, call):
    """A piece table of the wrong length never reaches a launch: the CSR
    refuses it when it is made, which is why the wrappers need not check it
    again at each launch."""
    monkeypatch.setattr(rspmm_cuda, "_kernel", lambda name: lambda *_: pytest.fail("launched"))
    ei, et, ew, *_ = power_law_inputs()
    csr = port_graph(ei, et, ew).csr.to("meta")
    x, w = torch.empty(V, F, device="meta"), torch.empty(len(ew), device="meta")
    with pytest.raises(ValueError, match=field):
        csr = dataclasses.replace(csr, **{field: getattr(csr, field)[1:]})
        getattr(module, call)(csr, w, torch.empty(2 * R, F, device="meta"), x, "mul")
    assert not getattr(module, call).launches

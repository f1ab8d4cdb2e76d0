"""The piece tables of ``ultra_tpu_torch/graph.py``, which B1, B3, B4 and
B6 walk on the card over a CSR and B2 and B5 over the type segments, on a
power-law graph with weight-0 edges, runtime masks that empty long rows,
and rows (and types) with no edges, with ``ROW_PIECE`` cut to 4 and the
segments' piece length to 8 so that many rows split. The kernels cannot run
here, so a plain-torch emulation of their two passes over the table (a
partial per piece, written to the row or to its slot; then each long row's
partials combined in slot order, or, for B2 and B5, by several groups in a
fixed order) is held against the wrappers' plain versions and against the
JAX package's XLA backend (its values, and its gradients through
``jax.vjp``); B6's one pass (each piece's edges, each summed over the
features and written at its ``eid``) likewise. The order in which B6's f32
instance and its bf16 instance's 8-feature pass add an edge's terms over
the features (lanes, shuffles, passes) is emulated in f32 for both, which
must agree bit for bit. The rule that chooses the segments' piece length
is held on FB15k-237's shape.

Tolerance: sums' emulations in f64 against the plain versions in f64
within rtol 1e-12 (only the order of the additions differs); in f32 against
XLA, rtol 1e-5 and atol 1e-5 as in ``test_torch_rspmm.py``. Min/max
exactly: a min or a max is exact whatever the order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu.ops.rspmm import generalized_rspmm as jax_generalized_rspmm
from ultra_tpu_torch import graph as graph_module
from ultra_tpu_torch.graph import make_graph
from ultra_tpu_torch.ops import build, rspmm_cuda, rspmm_minmax_cuda
from ultra_tpu_torch.ops.pieces import csr_rows
from ultra_tpu_torch.ops.rspmm_cuda import (
    rspmm_dw_plain, rspmm_sum_drel_plain, rspmm_sum_fwd_plain,
)
from ultra_tpu_torch.ops.rspmm_minmax_cuda import (
    rspmm_minmax_drel_plain, rspmm_minmax_dx_plain, rspmm_minmax_fwd_plain,
)
from ultra_tpu_torch.tasks import build_relation_graph_arrays
from ultra_tpu_torch.utils.benchlib import fb15k237_split

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


def two_passes(table, num_rows, like, fill, fold, merge, split=1):
    """The kernels' two passes over a piece table (a CSR's or the type
    segments') in plain torch, in ``like``'s type: pass 1 folds each piece's
    edges (``fold(lo, hi, row)``, a row) into its row of the output (a
    one-piece row) or its slot of the partial rows; pass 2 combines each long
    row's slots as ``long_row_kernel`` does: ``split`` groups each merge every
    split-th slot from their own first on, in order (``merge(a, b)``), and the
    first merges the others' results in group order."""
    out = torch.full((num_rows, like.shape[1]), fill, dtype=like.dtype)
    partial = torch.full((table.num_slots, like.shape[1]), float("nan"), dtype=like.dtype)
    for p in table.piece_order.tolist():  # the kernels' order; the result does not depend on it
        lo, hi = int(table.piece_ptr[p]), int(table.piece_ptr[p + 1])
        row, slot = int(table.piece_row[p]), int(table.piece_slot[p])
        (out[row] if slot < 0 else partial[slot]).copy_(fold(lo, hi, row))
    for i in range(table.long_rows.numel()):
        first, end = int(table.long_slot_ptr[i]), int(table.long_slot_ptr[i + 1])
        sums = []
        for part in range(split):
            acc = partial[first + part].clone() if first + part < end else torch.full_like(
                out[0], fill)
            for s in range(first + part + split, end, split):
                acc = merge(acc, partial[s])
            sums.append(acc)
        acc = sums[0]
        for other in sums[1:]:
            acc = merge(acc, other)
        out[int(table.long_rows[i])] = acc
    assert not partial.isnan().any()  # every slot was written
    return out


def emulate(csr, weight, rel, x, mul, agg):
    """B1 and B3 (the forward) over ``csr``'s piece table: :func:`two_passes`
    with each piece's messages summed, or reduced to their extreme."""
    fill = {"sum": 0.0, "max": float("-inf"), "min": float("inf")}[agg]

    def fold(lo, hi, row):
        r, s = rel[csr.etype[lo:hi].long()], x[csr.col[lo:hi].long()]
        w = weight[csr.eid[lo:hi].long()].unsqueeze(1)
        msg = (r * s if mul == "mul" else r + s) * w
        if agg == "sum":
            return msg.sum(0)
        live = torch.cat([torch.full((1, x.shape[1]), fill, dtype=x.dtype), msg[w[:, 0] != 0]])
        return live.amax(0) if agg == "max" else live.amin(0)

    merge = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[agg]
    return two_passes(csr, csr.rowptr.numel() - 1, x, fill, fold, merge)


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


# an H100's L2 as the card reports it (L2_cache_size)
H100_L2 = 50 * 2**20


@pytest.mark.parametrize("rows, feat, elem_bytes, features, want", [
    (123_182, 1_024, 4, 4, 32),  # the ranking cell's pass: 504 MB of x, 8 slabs of 63 MB
    (14_505, 2_048, 4, 4, 32),  # the eval cell's: 119 MB, 16 slabs of 7.4 MB
    (14_541, 512, 4, 4, 32),  # FB15k-237 at a batch of 8: 29.8 MB, 4 tiles, not 1
    (14_541, 64, 4, 4, 16),  # FB15k-237 at F = 64 (attribution): fits, one tile
    (474, 4_096, 4, 4, 256),  # its relation graph at F = 4,096: fits, today's 4 tiles
    (14_541, 512, 2, 8, 64),  # bf16 x at F = 512: 14.9 MB, fits where f32 does not
    (123_182, 1_024, 2, 8, 32),  # bf16 x of the ranking pass: 256-feature slabs
    (14_541, 512, 4, 8, 32),  # the bf16 input gradient's f32 g (8 features a unit)
    (14_505, 1_536, 4, 4, 32),  # a width of 384 units, not a power of two
    (14_505, 1_040, 4, 4, 256),  # 260 units, which 32 does not divide: whole rows
    (200_000, 64, 4, 4, 16),  # a row of 16 units: no tile narrower than its warp
])
def test_slab_tile_rule(rows, feat, elem_bytes, features, want):
    """B1's feature tile (``rspmm_cuda.slab_tile``) at the cells' and the
    paths' shapes, with half of an H100's L2 as the budget: where x fits,
    ``group_size`` of the row, as every other walk; where it does not, a
    warp's 32 units where they divide a wider row, else whole rows. A bf16
    x, half the bytes a feature, slabs only where the f32 x of twice its
    bytes would, and then in tiles of more features."""
    budget = rspmm_cuda.slab_budget(H100_L2)
    assert budget == H100_L2 // 2
    width = feat // features
    whole = rspmm_cuda.group_size(width)
    tile = rspmm_cuda.slab_tile(rows, feat, elem_bytes, features, budget)
    assert tile == want
    assert tile >= 8 and (tile in (8, 16) or (tile % 32 == 0 and tile <= 256))
    if rows * feat * elem_bytes <= budget:
        assert tile == whole
    elif tile != whole:
        assert tile == rspmm_cuda.SLAB_TILE and width % tile == 0 and tile < whole
    if elem_bytes == 2:
        f32 = rspmm_cuda.slab_tile(rows, feat, 4, 4, budget)
        assert tile * features >= f32 * 4


@pytest.mark.parametrize("width, group", [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32),
                                          (32, 32), (33, 64), (100, 128), (256, 256),
                                          (512, 256)])
def test_group_size_is_the_walks(width, group):
    """``rspmm_cuda.group_size`` is ``csrc/rspmm_pieces.cuh::group_size``:
    a power of two from 8 to 32 units, else the width rounded up to a
    multiple of 32, at most 256."""
    assert rspmm_cuda.group_size(width) == group


@pytest.mark.parametrize("field, module, call", [
    ("piece_slot", rspmm_cuda, "rspmm_sum_fwd"),
    ("long_slot_ptr", rspmm_minmax_cuda, "rspmm_minmax_fwd"),
])
def test_a_piece_table_of_the_wrong_length_is_refused(monkeypatch, small_pieces, field,
                                                      module, call):
    """A piece table of the wrong length never reaches a launch: the CSR
    refuses it when it is made, which is why the wrappers need not check it
    again at each launch."""
    monkeypatch.setattr(build, "bind", lambda name: lambda *_: pytest.fail("launched"))
    ei, et, ew, *_ = power_law_inputs()
    csr = port_graph(ei, et, ew).csr.to("meta")
    x, w = torch.empty(V, F, device="meta"), torch.empty(len(ew), device="meta")
    with pytest.raises(ValueError, match=field):
        csr = dataclasses.replace(csr, **{field: getattr(csr, field)[1:]})
        getattr(module, call)(csr, w, torch.empty(2 * R, F, device="meta"), x, "mul")
    assert not getattr(module, call).launches


@pytest.mark.parametrize("field", ["piece_order", "long_slot_ptr", "dst"])
def test_a_segment_table_of_the_wrong_length_is_refused(monkeypatch, small_segment_pieces,
                                                       field):
    """As a CSR's, the type segments' piece table and edge arrays are checked
    when the segments are made, so B2's wrapper, which checks only ``src``
    at each launch, never launches on a table of the wrong length."""
    monkeypatch.setattr(build, "bind", lambda name: lambda *_: pytest.fail("launched"))
    ei, et, ew, *_ = segment_inputs(seed=6)
    seg = port_graph(ei, et, ew).segments.to("meta")
    x = torch.empty(V, F, device="meta")
    with pytest.raises(ValueError, match=field):
        seg = dataclasses.replace(seg, **{field: getattr(seg, field)[1:]})
        rspmm_cuda.rspmm_sum_drel(seg, torch.empty(len(ew), device="meta"), x, x, "mul")
    assert not rspmm_cuda.rspmm_sum_drel.launches


def emulate_minmax_dx(csr_src, weight, rel, x, g, out, mul):
    """B4 over ``csr_src``'s piece table: :func:`two_passes` with each piece's
    routed terms summed in ``g``'s type. An edge is routed where it is live
    and its message, computed in the type of ``rel``, ``x`` and ``out`` (f32,
    as the forward computed it), equals ``out`` of its destination; a
    weight-0 or unrouted edge adds a selected 0, as the kernel folds it."""

    def fold(lo, hi, u):
        w = weight[csr_src.eid[lo:hi].long()].unsqueeze(1)
        dst, r = csr_src.col[lo:hi].long(), rel[csr_src.etype[lo:hi].long()]
        msg = (r * x[u] if mul == "mul" else r + x[u]) * w
        route = (w != 0) & (msg == out[dst])
        terms = w.to(g.dtype) * (r.to(g.dtype) if mul == "mul" else 1.0) * g[dst]
        return torch.where(route, terms, torch.zeros((), dtype=g.dtype)).sum(0)

    return two_passes(csr_src, csr_src.rowptr.numel() - 1, g, 0.0, fold, torch.add)


def emulate_drel(seg, weight, x, g, mul, split):
    """B2 over the segments' piece table: :func:`two_passes` with the type as
    the row, each piece's ``w * x[src] * g[dst]`` (mul) or ``w * g[dst]``
    (add) summed, and a long type's partials combined by ``split`` groups."""

    def fold(lo, hi, _type):
        terms = g[seg.dst[lo:hi].long()] * weight[seg.eid[lo:hi].long()].unsqueeze(1)
        if mul == "mul":
            terms = x[seg.src[lo:hi].long()] * terms
        return terms.sum(0)

    return two_passes(seg, seg.num_types, g, 0.0, fold, torch.add, split)


def minmax_dx_inputs(seed):
    """power_law_inputs with every edge out of the longest source row masked
    at run time too, the forward's output on them, and g: (ei, et, ew, mask,
    rel, x, g, out, that source)."""
    ei, et, ew, mask, rel, x, _ = power_law_inputs(seed)
    src_hub = np.bincount(ei[1, ew != 0], minlength=V).argmax()
    mask[ei[1] == src_hub] = 0.0
    g = np.random.default_rng(seed + 10).normal(size=(V, F)).astype(np.float32)
    return ei, et, ew, mask, rel, x, g, src_hub


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("is_min", [False, True])
def test_minmax_dx_two_passes_equal_the_plain_version(small_pieces, is_min, mul):
    """B4's two passes over the source-major CSR in f64 against
    ``rspmm_minmax_dx_plain`` in f64 (routing in f32 on both sides), on
    tie-heavy inputs: every tying edge gets the whole gradient. The long
    source row whose edges are all masked and the sources with no edge get
    0."""
    ei, et, ew, mask, rel, x, g, src_hub = minmax_dx_inputs(seed=4)
    graph = port_graph(ei, et, ew)
    w, rel_t, x_t = (torch.from_numpy(a) for a in (mask, rel, x))
    out = rspmm_minmax_fwd_plain(graph.csr, w, rel_t, x_t, mul, is_min)
    g64 = torch.from_numpy(g).double()
    got = emulate_minmax_dx(graph.csr_src, w, rel_t, x_t, g64, out, mul)
    want = rspmm_minmax_dx_plain(graph.csr_src, w, rel_t, x_t, g64, out, mul)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert src_hub in graph.csr_src.long_rows.tolist() and (got[src_hub] == 0).all()
    assert (got[V - EMPTY:] == 0).all()
    # the inputs tie: some output is the message of two or more live edges
    csr = graph.csr
    w_e = w[csr.eid.long()].unsqueeze(1)
    r, s = rel_t[csr.etype.long()], x_t[csr.col.long()]
    rows = csr_rows(csr)
    route = (w_e != 0) & (((r * s if mul == "mul" else r + s) * w_e) == out[rows])
    assert (torch.zeros(V, F).index_add_(0, rows, route.float()) >= 2).any()


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("is_min", [False, True])
def test_minmax_dx_two_passes_match_jax(small_pieces, is_min, mul):
    """B4's emulation in f32 against the input gradient of the JAX package's
    ``generalized_rspmm(backend="xla")`` (jax.vjp) on the same tie-heavy
    edges and runtime weights."""
    ei, et, ew, mask, rel, x, g, _ = minmax_dx_inputs(seed=5)
    graph = port_graph(ei, et, ew)
    w, rel_t, x_t = (torch.from_numpy(a) for a in (mask, rel, x))
    agg = "min" if is_min else "max"
    out = rspmm_minmax_fwd_plain(graph.csr, w, rel_t, x_t, mul, is_min)
    got = emulate_minmax_dx(graph.csr_src, w, rel_t, x_t, torch.from_numpy(g), out, mul)
    fn = lambda r, xx: jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask), r, xx, sum=agg, mul=mul,
        backend="xla")
    _, vjp = jax.vjp(fn, jnp.asarray(rel[:, None]), jnp.asarray(x[:, None]))
    want = np.asarray(vjp(jnp.asarray(g[:, None]))[1])[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


SEG_PIECE = 8


@pytest.fixture
def small_segment_pieces(monkeypatch):
    monkeypatch.setattr(graph_module, "segment_piece", lambda counts: SEG_PIECE)


def segment_inputs(seed):
    """power_law_inputs' edges, weights and operands with types set so that
    the segments hold a type of no edges (0), one of a single piece (1: 6
    edges, fewer live), one of exactly SEG_PIECE + 1 edges (2) and types of
    many pieces; x and g in f64 from a normal, so that the sums round."""
    ei, et, ew, mask, *_ = power_law_inputs(seed)
    ew[:SEG_PIECE + 7] = 1.0  # live at build time
    rng = np.random.default_rng(seed)
    et = rng.integers(3, 2 * R, ei.shape[1])
    et[:6], et[6:SEG_PIECE + 7] = 1, 2
    x, g = rng.normal(size=(V, F)), rng.normal(size=(V, F))
    return ei, et, ew, mask, x, g


def test_segment_pieces_cut_every_type(small_segment_pieces):
    """The segments' piece table is a CSR's with the type as the row: the
    pieces tile the type-sorted edges in order, at most SEG_PIECE each; an
    empty type is one empty piece; a long type's pieces take consecutive
    slots; the launch order is longest first."""
    ei, et, ew, *_ = segment_inputs(seed=6)
    seg = port_graph(ei, et, ew).segments
    assert seg.piece_len == SEG_PIECE
    counts = np.bincount(seg.etype.numpy(), minlength=2 * R)
    piece_ptr, piece_row = seg.piece_ptr.numpy(), seg.piece_row.numpy()
    sizes = np.diff(piece_ptr)
    assert piece_ptr[0] == 0 and piece_ptr[-1] == seg.src.numel()
    assert np.all((sizes >= 0) & (sizes <= SEG_PIECE))
    assert np.array_equal(np.unique(piece_row), np.arange(2 * R))
    assert seg.num_types == seg.to("meta").num_types == 2 * R
    type_ptr = np.concatenate([[0], np.cumsum(counts)])
    assert np.all(type_ptr[piece_row] <= piece_ptr[:-1])
    assert np.all(piece_ptr[1:] <= type_ptr[piece_row + 1])
    pieces = np.bincount(piece_row, minlength=2 * R)
    assert counts[0] == 0 and pieces[0] == 1 and sizes[piece_row == 0].tolist() == [0]
    assert 0 < counts[1] <= 6 and pieces[1] == 1
    assert counts[2] == SEG_PIECE + 1 and pieces[2] == 2
    assert pieces[3:].min() > 1 and pieces.max() >= 5
    assert np.array_equal(seg.long_rows.numpy(), np.nonzero(pieces > 1)[0])
    slots = seg.piece_slot.numpy()
    assert np.array_equal(np.sort(slots[slots >= 0]), np.arange(seg.num_slots))
    for i, t in enumerate(seg.long_rows.tolist()):
        assert slots[piece_row == t].tolist() == list(
            range(seg.long_slot_ptr[i], seg.long_slot_ptr[i + 1]))
    order = seg.piece_order.numpy()
    assert np.array_equal(np.sort(order), np.arange(len(piece_row)))
    assert np.all(np.diff(sizes[order]) <= 0)


@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("mul", ["mul", "add"])
def test_drel_two_passes_equal_the_plain_version(small_segment_pieces, mul, split):
    """B2's two passes over the segments' piece table in f64 against
    ``rspmm_sum_drel_plain`` in f64, within rtol 1e-12 (only the order of
    the additions differs), with a long type's partials combined by 1, 2 or
    8 groups. The type with no edges is 0."""
    ei, et, ew, mask, x, g = segment_inputs(seed=7)
    seg = port_graph(ei, et, ew).segments
    w = torch.from_numpy(mask).double()
    x_t, g_t = torch.from_numpy(x), torch.from_numpy(g)
    got = emulate_drel(seg, w, x_t, g_t, mul, split)
    want = rspmm_sum_drel_plain(seg, w, x_t, g_t, mul)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert (got[0] == 0).all() and (got[1:] != 0).all()


@pytest.mark.parametrize("mul", ["mul", "add"])
def test_drel_two_passes_match_jax(small_segment_pieces, mul):
    """B2's emulation in f32 (8 groups a long type in pass 2) against the
    relation gradient of the JAX package's ``generalized_rspmm(backend=
    "xla")`` (jax.vjp) on the same edges and runtime weights."""
    ei, et, ew, mask, x, g = segment_inputs(seed=8)
    x, g = x.astype(np.float32), g.astype(np.float32)
    rel = np.random.default_rng(9).normal(size=(2 * R, F)).astype(np.float32)
    seg = port_graph(ei, et, ew).segments
    got = emulate_drel(seg, torch.from_numpy(mask), torch.from_numpy(x), torch.from_numpy(g),
                       mul, split=8)
    fn = lambda r, xx: jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask), r, xx, sum="add", mul=mul,
        backend="xla")
    _, vjp = jax.vjp(fn, jnp.asarray(rel[:, None]), jnp.asarray(x[:, None]))
    want = np.asarray(vjp(jnp.asarray(g[:, None]))[0])[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_segment_piece_length_rule():
    """The longest of 256, 128, 64 and 32 that still cuts the segments into
    at least 4 pieces for each of an H100's 132 SMs: 256 for the entity
    graph of FB15k-237's shape (544,230 edges, 474 types), 32 for its
    relation graph (31,416 edges, 4 types), and 32 where even that gives too
    few."""
    split = fb15k237_split("realistic", seed=0)
    entity = torch.bincount(torch.from_numpy(split.edge_type), minlength=474)
    _, rel_type = build_relation_graph_arrays(split.edge_index, split.edge_type,
                                              split.num_nodes, split.num_relations)
    relation = torch.bincount(torch.from_numpy(rel_type), minlength=4)
    assert (int(entity.sum()), int(relation.sum())) == (544230, 31416)
    assert graph_module.segment_piece(entity) == 256
    assert graph_module.segment_piece(relation) == 32
    assert graph_module.segment_piece(torch.tensor([100, 0, 7])) == 32
    # at the boundary: 528 pieces of 64 edges take 64, 527 take 32
    assert graph_module.segment_piece(torch.full((4,), 132 * 64)) == 64
    assert graph_module.segment_piece(torch.tensor([132 * 64] * 3 + [131 * 64])) == 32


def emulate_minmax_drel(seg, weight, rel, x, g, out, mul, split):
    """B5 over the segments' piece table: :func:`two_passes` with the type as
    the row, each piece's routed ``w * x[src] * g[dst]`` (mul) or ``w *
    g[dst]`` (add) summed in ``g``'s type, and a long type's partials
    combined by ``split`` groups. An edge is routed where it is live and its
    message, computed in the type of ``rel``, ``x`` and ``out`` (f32, as the
    forward computed it), equals ``out`` of its destination; a weight-0 or
    unrouted edge adds a selected 0, as the kernel folds it."""

    def fold(lo, hi, t):
        w = weight[seg.eid[lo:hi].long()].unsqueeze(1)
        s, dst = x[seg.src[lo:hi].long()], seg.dst[lo:hi].long()
        msg = (rel[t] * s if mul == "mul" else rel[t] + s) * w
        route = (w != 0) & (msg == out[dst])
        terms = w.to(g.dtype) * (s.to(g.dtype) if mul == "mul" else 1.0) * g[dst]
        return torch.where(route, terms, torch.zeros((), dtype=g.dtype)).sum(0)

    return two_passes(seg, seg.num_types, g, 0.0, fold, torch.add, split)


def minmax_drel_inputs(seed):
    """segment_inputs' edges, types and weights (0.5, 1 or 2; 10% 0 at build
    time, more at run time) with tie-heavy operands from {-2..2} for every
    type, and g in f32: (ei, et, ew, mask, rel, x, g)."""
    ei, et, ew, mask, _, g = segment_inputs(seed)
    rng = np.random.default_rng(seed + 20)
    rel = rng.integers(-2, 3, size=(2 * R, F)).astype(np.float32)
    x = rng.integers(-2, 3, size=(V, F)).astype(np.float32)
    return ei, et, ew, mask, rel, x, g.astype(np.float32)


@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("is_min", [False, True])
def test_minmax_drel_two_passes_equal_the_plain_version(small_segment_pieces, is_min, mul,
                                                        split):
    """B5's two passes over the segments' piece table in f64 against
    ``rspmm_minmax_drel_plain`` in f64 (routing in f32 on both sides), on
    tie-heavy inputs, with a long type's partials combined by 1, 2 or 8
    groups: every tying edge gets its whole term. The type with no edges is
    0."""
    ei, et, ew, mask, rel, x, g = minmax_drel_inputs(seed=11)
    graph = port_graph(ei, et, ew)
    w, rel_t, x_t = (torch.from_numpy(a) for a in (mask, rel, x))
    out = rspmm_minmax_fwd_plain(graph.csr, w, rel_t, x_t, mul, is_min)
    g64 = torch.from_numpy(g).double()
    got = emulate_minmax_drel(graph.segments, w, rel_t, x_t, g64, out, mul, split)
    want = rspmm_minmax_drel_plain(graph.segments, w, rel_t, x_t, g64, out, mul)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert (got[0] == 0).all() and (got[3:] != 0).any(1).all()
    # the inputs tie: some output is the message of two or more live edges
    seg = graph.segments
    w_e = w[seg.eid.long()].unsqueeze(1)
    r, s = rel_t[seg.etype.long()], x_t[seg.src.long()]
    route = (w_e != 0) & (((r * s if mul == "mul" else r + s) * w_e) == out[seg.dst.long()])
    assert (torch.zeros(V, F).index_add_(0, seg.dst.long(), route.float()) >= 2).any()


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("is_min", [False, True])
def test_minmax_drel_two_passes_match_jax(small_segment_pieces, is_min, mul):
    """B5's emulation in f32 (8 groups a long type in pass 2) against the
    relation gradient of the JAX package's ``generalized_rspmm(backend=
    "xla")`` (jax.vjp) on the same tie-heavy edges and runtime weights."""
    ei, et, ew, mask, rel, x, g = minmax_drel_inputs(seed=12)
    graph = port_graph(ei, et, ew)
    w, rel_t, x_t = (torch.from_numpy(a) for a in (mask, rel, x))
    agg = "min" if is_min else "max"
    out = rspmm_minmax_fwd_plain(graph.csr, w, rel_t, x_t, mul, is_min)
    got = emulate_minmax_drel(graph.segments, w, rel_t, x_t, torch.from_numpy(g), out, mul,
                              split=8)
    fn = lambda r, xx: jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), jnp.asarray(mask), r, xx, sum=agg, mul=mul,
        backend="xla")
    _, vjp = jax.vjp(fn, jnp.asarray(rel[:, None]), jnp.asarray(x[:, None]))
    want = np.asarray(vjp(jnp.asarray(g[:, None]))[0])[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("field", ["piece_slot", "piece_ptr", "eid"])
def test_a_segment_table_of_the_wrong_length_never_reaches_b5(monkeypatch,
                                                             small_segment_pieces, field):
    """B5's wrapper, which checks only ``src`` of the segments at each
    launch, never launches on a table or an edge array of the wrong length:
    the segments refuse it when they are made."""
    monkeypatch.setattr(build, "bind", lambda name: lambda *_: pytest.fail("launched"))
    ei, et, ew, *_ = segment_inputs(seed=6)
    seg = port_graph(ei, et, ew).segments.to("meta")
    x, rel = torch.empty(V, F, device="meta"), torch.empty(2 * R, F, device="meta")
    with pytest.raises(ValueError, match=field):
        seg = dataclasses.replace(seg, **{field: getattr(seg, field)[1:]})
        rspmm_minmax_cuda.rspmm_minmax_drel(seg, torch.empty(len(ew), device="meta"), rel, x,
                                            x, x, "mul")
    assert not rspmm_minmax_cuda.rspmm_minmax_drel.launches


def emulate_dw(csr, weight, rel, x, g, mul, out=None, parts=rspmm_cuda.DW_PARTS):
    """B6 over ``csr``'s piece table, in ``g``'s type: each piece cut into
    ``parts`` parts of ceil(length / parts) edges (the last shorter, some
    empty) as the kernel cuts it, each part's edges, in the kernel's order,
    each edge's terms ``route * (rel op x[src]) * g[row]`` summed over the
    features and written at its ``eid``; the route is 1 without ``out``
    (sum) and, with the forward's ``out`` (min/max), 1 where the edge is
    live and its message, computed in f32 as the forward did, equals
    ``out[row]``. Returns (d_w, the writes of each slot)."""
    d_w = torch.zeros(weight.shape, dtype=g.dtype)
    writes = torch.zeros(weight.shape, dtype=torch.int64)
    for k in range(csr.piece_row.numel() * parts):
        p = int(csr.piece_order[k // parts])
        first, end = int(csr.piece_ptr[p]), int(csr.piece_ptr[p + 1])
        span = -(-(end - first) // parts)
        lo = first + (k % parts) * span
        hi = min(lo + span, end)
        if hi <= lo:
            continue
        row, eid = int(csr.piece_row[p]), csr.eid[lo:hi].long()
        r, s = rel[csr.etype[lo:hi].long()], x[csr.col[lo:hi].long()]
        m = r * s if mul == "mul" else r + s
        terms = m.to(g.dtype) * g[row]
        if out is not None:
            w = weight[eid].unsqueeze(1)
            route = (w != 0) & (m * w == out[row])
            terms = torch.where(route, terms, torch.zeros((), dtype=g.dtype))
        d_w[eid] = terms.sum(1)
        writes[eid] += 1
    return d_w, writes


def dw_case(agg, mul, seed, dtype):
    """(graph, mask, rel, x, g in ``dtype``, out or None, hub) on
    power_law_inputs' tie-heavy operands; ``out`` is the f32 min/max
    forward's output on the runtime weights."""
    ei, et, ew, mask, rel, x, hub = power_law_inputs(seed)
    graph = port_graph(ei, et, ew)
    g = torch.from_numpy(np.random.default_rng(seed + 30).normal(size=(V, F))).to(dtype)
    w, rel_t, x_t = (torch.from_numpy(a) for a in (mask, rel, x))
    out = None if agg == "sum" else rspmm_minmax_fwd_plain(graph.csr, w, rel_t, x_t, mul,
                                                           agg == "min")
    return graph, ei, et, ew, w, rel_t, x_t, g, out, hub


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("agg", ["sum", "minmax"])
def test_dw_walk_writes_every_edge_once(small_pieces, agg, parts):
    """B6's walk, with each piece split over 1, 2 or 3 groups, writes d_w
    once at the eid of every edge of the CSR (the edges live at build time),
    and never a padding slot or an edge dead at build time, which keep the
    wrapper's zeros."""
    graph, _, _, ew, w, rel, x, g, out, _ = dw_case(agg, "mul", seed=13, dtype=torch.float64)
    got, writes = emulate_dw(graph.csr, w, rel, x, g, "mul", out, parts)
    built = torch.from_numpy(ew != 0)
    assert (writes[built] == 1).all() and (writes[~built] == 0).all()
    assert (got[~built] == 0).all() and graph.csr.long_rows.numel() >= 5


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("agg", ["sum", "max", "min"])
def test_dw_walk_equals_the_plain_version(small_pieces, agg, mul):
    """B6's walk in f64 against ``rspmm_dw_plain`` in f64 (min/max routing
    in f32 on both sides), on tie-heavy inputs, within rtol 1e-12. The long
    row whose edges are all masked at run time gets the sum's derivative and
    0 for min/max."""
    graph, _, _, _, w, rel, x, g, out, hub = dw_case(
        "sum" if agg == "sum" else agg, mul, seed=14, dtype=torch.float64)
    if agg == "sum":
        rel, x = rel.double(), x.double()
    got, _ = emulate_dw(graph.csr, w.double() if agg == "sum" else w, rel, x, g, mul, out)
    want = rspmm_dw_plain(graph.csr, w.double() if agg == "sum" else w, rel, x, g, mul, out)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    csr = graph.csr
    assert hub in csr.long_rows.tolist()
    hub_edges = csr.eid[csr.rowptr[hub]:csr.rowptr[hub + 1]].long()
    assert (got[hub_edges] != 0).any() if agg == "sum" else (got[hub_edges] == 0).all()
    if agg != "sum":  # the inputs tie: some output is the message of two or more live edges
        rows = csr_rows(csr)
        w_e = w[csr.eid.long()].unsqueeze(1)
        r, s = rel[csr.etype.long()], x[csr.col.long()]
        route = (w_e != 0) & (((r * s if mul == "mul" else r + s) * w_e) == out[rows])
        assert (torch.zeros(V, F).index_add_(0, rows, route.float()) >= 2).any()


@pytest.mark.parametrize("mul", ["mul", "add"])
@pytest.mark.parametrize("agg", ["sum", "max", "min"])
def test_dw_walk_matches_jax(small_pieces, agg, mul):
    """B6's walk in f32 against the edge-weight gradient of the JAX
    package's ``generalized_rspmm(backend="xla")`` (jax.vjp with respect to
    the weights), over the edges live when the graph was built (XLA gives
    the others their derivative, the port 0): a runtime-masked edge gets its
    derivative for the sum and 0 for min/max in both."""
    graph, ei, et, ew, w, rel, x, g, out, _ = dw_case(
        "sum" if agg == "sum" else agg, mul, seed=15, dtype=torch.float32)
    got, _ = emulate_dw(graph.csr, w, rel, x, g, mul, out)
    fn = lambda ww: jax_generalized_rspmm(
        jnp.asarray(ei), jnp.asarray(et), ww, jnp.asarray(rel[:, None].numpy()),
        jnp.asarray(x[:, None].numpy()), sum="add" if agg == "sum" else agg, mul=mul,
        backend="xla")
    _, vjp = jax.vjp(fn, jnp.asarray(w.numpy()))
    (want,) = vjp(jnp.asarray(g[:, None].numpy()))
    built = ew != 0
    np.testing.assert_allclose(got.numpy()[built], np.asarray(want)[built], rtol=1e-5,
                               atol=1e-5)
    assert np.abs(np.asarray(want)[built]).sum() > 0


def dw_lanes(num_feat):
    """B6's f32 instance's lanes (``csrc/rspmm_dw.cu``, ``launch``) for F =
    ``num_feat``: (float4 units of the row, lanes of a group, units a lane
    in a pass K, passes)."""
    width = num_feat // 4
    group = 32 if width > 32 else max(8, 1 << (width - 1).bit_length())
    k = 1 if width <= group else 2 if width <= 2 * group else 4
    return width, group, k, -(-width // (k * group))


def butterfly(acc, group):
    """``acc += __shfl_xor_sync(acc, offset)`` for offset group/2 ... 1 over
    the lanes (the last axis), each lane's own value first."""
    offset = group // 2
    while offset:
        acc = acc + acc[:, torch.arange(group) ^ offset]
        offset //= 2
    return acc


def quads(terms, unit):
    """Each edge's 4 terms of float4 unit ``unit`` (a (E,) column per lane),
    added as ``terms`` in csrc/rspmm_dw.cu adds them: ((t0 + t1) + t2) + t3."""
    q = terms[:, 4 * unit:4 * unit + 4]
    return ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]


def dw_sum_f32_lanes(terms):
    """Each edge's sum over its (E, F) f32 ``terms`` in the order of B6's
    f32 instance: lane m adds its units (pass * K + c) * group + m, c < K,
    to 0 in order, a butterfly of shuffles adds the lanes, lane 0's value
    is the pass's sum, and the passes add in order."""
    width, group, k, passes = dw_lanes(terms.shape[1])
    total = None
    for p in range(passes):
        acc = torch.zeros(terms.shape[0], group)
        for c in range(k):
            for m in range(group):
                unit = (p * k + c) * group + m
                if unit < width:
                    acc[:, m] = acc[:, m] + quads(terms, unit)
        acc = butterfly(acc, group)[:, 0]
        total = acc if total is None else total + acc
    return total


def dw_sum_8_feature_lanes(terms):
    """The same sums in the order of B6's 8-feature pass (its bf16
    instance): lane l of a group of group / 2 holds units of 8 features,
    (pass * K + c) * group / 2 + l, and adds the two float4 halves of each
    into sums of its own, lo and hi (the f32 instance's lanes 2l and
    2l + 1); the butterfly runs on both over group / 2 lanes, and lane 0's
    lo + hi is the pass's sum."""
    width, group, k, passes = dw_lanes(terms.shape[1])
    half = group // 2
    total = None
    for p in range(passes):
        lo, hi = torch.zeros(terms.shape[0], half), torch.zeros(terms.shape[0], half)
        for c in range(k):
            for lane in range(half):
                unit8 = (p * k + c) * half + lane
                if 2 * unit8 < width:
                    lo[:, lane] = lo[:, lane] + quads(terms, 2 * unit8)
                    hi[:, lane] = hi[:, lane] + quads(terms, 2 * unit8 + 1)
        acc = butterfly(lo, half)[:, 0] + butterfly(hi, half)[:, 0]
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("agg", ["sum", "max", "min"])
@pytest.mark.parametrize("num_feat", [16, 64, 128, 256, 512, 1056])
def test_dw_8_feature_pass_adds_in_the_f32_instances_order(agg, num_feat):
    """B6's 8-feature pass (its bf16 instance) adds each edge's terms in
    the f32 instance's order, so the two give the same bits on the same
    bf16-rounded operands: in f32, the sums of both orders are equal bit
    for bit, at the widths where a lane holds one float4 (F <= 128; F = 16
    leaves lanes idle), several (256, 512) and where the row takes passes
    (1,056, the last one ragged); for the sum and for min/max routing. A
    plain left-to-right sum differs from both on some edge (the order
    matters on these inputs), and both agree with ``rspmm_dw_plain`` within
    f32 rounding."""
    ei, et, ew, mask, *_ = power_law_inputs(seed=40)
    graph = port_graph(ei, et, ew)
    rng = np.random.default_rng(num_feat)
    rel, x = (torch.from_numpy(rng.normal(size=(n, num_feat)).astype(np.float32))
              .bfloat16() for n in (2 * R, V))
    g = torch.from_numpy(rng.normal(size=(V, num_feat)).astype(np.float32))
    w = torch.from_numpy(mask)
    out = None if agg == "sum" else rspmm_minmax_fwd_plain(graph.csr, w, rel, x, "mul",
                                                           agg == "min")
    terms = rspmm_cuda.rspmm_dw_terms(graph.csr, w, rel, x, g, "mul", out)
    assert terms.dtype == torch.float32 and (terms != 0).any()
    f32_order, walk8_order = dw_sum_f32_lanes(terms), dw_sum_8_feature_lanes(terms)
    assert torch.equal(f32_order.view(torch.int32), walk8_order.view(torch.int32))
    left_to_right = terms[:, 0].clone()
    for f in range(1, num_feat):
        left_to_right = left_to_right + terms[:, f]
    assert not torch.equal(left_to_right, f32_order)
    want = rspmm_dw_plain(graph.csr, w, rel, x, g.double(), "mul", out)[graph.csr.eid.long()]
    torch.testing.assert_close(f32_order.double(), want, rtol=1e-5, atol=1e-5)

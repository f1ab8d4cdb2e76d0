"""The sum-aggregation rspmm kernels for Hopper, their C signatures and
launch counters (``ops/build.py``), and their plain PyTorch versions.

- B1, ``csrc/rspmm_sum_fwd.cu``: the forward over a destination-major CSR.
  It replaces the TPU kernels ``ultra_tpu/ops/rspmm_pallas.py::_fwd_kernel``,
  ``rspmm_pallas_v2.py::_fused_kernel`` and ``rspmm_pallas_w3.py::_w3_kernel``
  (all compute the same function). Two wrappers launch it:
  :func:`rspmm_sum_fwd` (the forward) and :func:`rspmm_sum_dx` (the input
  gradient: the same function on the source-major CSR, as
  ``rspmm_pallas.py:1341-1374`` does), each with its own count. It walks the
  CSR's piece table (``graph.py``): a group of threads per piece of at most
  ``ROW_PIECE`` edges, so a hub row no longer sets the launch's length, and
  a second pass that adds a long row's partial rows in order, into scratch
  the wrapper allocates; both passes are one launch in the count. Where x
  is larger than a share of the card's L2 it walks x in slabs of columns,
  one warp's features wide (:func:`slab_tile`), with the same bits as one
  tile a row.
- B2, ``csrc/rspmm_sum_drel.cu``: the relation gradient over the type
  segments (:func:`rspmm_sum_drel`). It replaces
  ``rspmm_pallas.py::_rel_grad_kernel``, ``rspmm_pallas_v2.py::_drel_kernel``
  and ``rspmm_pallas_v2.py::_drel_add_kernel``. It walks the segments' piece
  table as B1 walks a CSR's, with the type as the row.
- B6, ``csrc/rspmm_dw.cu``: the edge-weight gradient over the
  destination-major CSR, for the sum and (given the forward's output) the
  min/max aggregators (:func:`rspmm_dw`). It replaces
  ``rspmm_pallas.py::_dw_kernel``. It walks the CSR's piece table, each
  piece split evenly over :data:`DW_PARTS` groups of at most one warp, and
  writes each edge's sum once, at its ``eid``: one pass, no scratch.

The kernels are bound by memory traffic on the card; each source says what
its design does about that. They launch through ``ops/pieces.py``. A
wrapper takes the plain version for a tensor on the CPU and launches the
kernel for one on a CUDA device; it never falls back from one to the other.

Operand types (``compute_dtype: bfloat16``, as the Pallas kernels take it):
the relation and x rows may each be f32 or bf16; the edge weights, the
output gradient ``g`` and the min/max forward's saved output are f32, and
every output is f32. Each source is built with one C entry point per
combination of row types the paths give it (``rspmm_sum_fwd`` for f32
rows, ``rspmm_sum_fwd_bf16_bf16``, and ``rspmm_sum_fwd_bf16_f32`` for the
input gradient; B2, whose only row operand is x, ``rspmm_sum_drel_bf16``;
B3-B6 ``..._bf16_bf16``; each kernel's module declares them with its C
signature, ``build.declare``), and a wrapper launches the one its
operands' types name: no operand is cast, and any other type or
combination raises ``TypeError``, on the CPU too.
The plain versions widen a bf16 row to f32 before any arithmetic, as the
kernels do, so both compute f32 arithmetic on bf16-rounded operands.
Every bf16 instance (B1's two, B2's, B3's, B4's, B5's and B6's) walks 8
features a thread (one 16-byte load of a bf16 row, ``pieces.features``) and
takes on the card only F % 8 == 0; every f32 instance walks 4 and takes F
% 4 == 0. Every row operand of every instance starts 16-byte aligned.
Anything else raises ``ValueError`` before any launch.

Each wrapper's ``launches`` (``build.counted``) is a
:class:`collections.Counter` of its kernel launches by output shape
``(rows, F)`` since the last ``clear()``, so a caller can tell the entity
graph's launches from the relation graph's; a launch of a bf16 instance
counts under the shape and the instance's types, e.g. ``(rows, F,
"bf16_bf16")``. B2 counts by ``(V, R, F)``, the graph's nodes before its
output shape: every relation graph has R = 4, so its output shape alone
names no graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ultra_tpu_torch.graph import CSR, TypeSegments
from ultra_tpu_torch.ops import build, pieces
from ultra_tpu_torch.utils import profiling

_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C parameters before the stream, as each source's PIECES_ENTRIES lists them
build.declare("rspmm_sum_fwd", [_P] * 14 + [_LL, _LL, _LL, _INT, _LL],
              instances=("", "bf16_bf16", "bf16_f32"))
build.declare("rspmm_sum_drel", [_P] * 14 + [_LL, _LL, _LL, _INT], instances=("", "bf16"))
build.declare("rspmm_dw", [_P] * 12 + [_LL, _LL, _INT, _INT, _INT],
              instances=("", "bf16_bf16"))

# the groups of threads B6 splits each piece of the CSR over: its edges' sums
# are independent, so the longest walk shortens with no second pass
DW_PARTS = 2


# the share of the card's L2 that B1's x may fill and still be walked in
# whole rows (slab_tile); timed on an H100 against 5/8 and 3/4 of its 50 MB
# (PERF.md): FB15k-237's x at F = 512, 29.8 MB, walks faster in slabs
SLAB_SHARE = 0.5
# B1's feature tile where x does not fit: one warp (32 accumulator units),
# the narrowest group that never shares a warp with another group's piece
SLAB_TILE = 32
# the threads of a pass-1 block, and so the widest feature tile
# (csrc/rspmm_pieces.cuh kBlock)
_BLOCK = 256


def group_size(width: int) -> int:
    """Threads of a group for a whole row of ``width`` accumulator units
    (``csrc/rspmm_pieces.cuh::group_size``): a power of two from 8 to 32,
    else ``width`` rounded up to a multiple of 32, at most 256."""
    if width > 32:
        return min(_BLOCK, -(-width // 32) * 32)
    group = 8
    while group < width:
        group *= 2
    return group


def slab_tile(rows: int, feat: int, elem_bytes: int, features: int, budget: int) -> int:
    """The feature tile, in accumulator units of ``features`` features, in
    which B1 walks an x of ``rows`` x ``feat`` elements of ``elem_bytes``
    each, given ``budget`` bytes of L2 (:func:`slab_budget`).

    Where x fits the budget, ``group_size`` of the row's width: every row in
    one tile up to 256 units, as every other walk takes it. Where it does
    not, :data:`SLAB_TILE` units, where they divide a wider row: the tiles
    are the grid's slowest dimension, so the blocks resident at once gather
    from one slab of x, ``rows`` x the tile's columns, which stays in L2
    largely (the ranking pass's, 63 MB at F = 1,024 in f32) or whole. On an
    H100 this beat every other tile wherever x did not fit, narrower slabs
    that fit the L2 whole included: a group of fewer than 32 threads shares
    its warp with other groups' pieces, which the warp walks in step, and
    more tiles stage the piece table again (PERF.md). Only shapes and the
    card's L2 decide it."""
    width = feat // features
    whole = group_size(width)
    if rows * feat * elem_bytes <= budget or width <= SLAB_TILE or width % SLAB_TILE:
        return whole
    return SLAB_TILE


def slab_budget(l2_bytes: int) -> int:
    """Bytes of a card's L2 of ``l2_bytes`` that B1's x may fill and still
    be walked in whole rows."""
    return int(l2_bytes * SLAB_SHARE)


@functools.cache
def l2_bytes(device) -> int:
    """The bytes of the L2 of the CUDA ``device``, read once."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def launch_sum(entry: str, op: str, csr: CSR, edge_weight, relation, x, mul_code: int,
               budget: int | None = None):
    """B1 (``entry``, one of its instances) on the card over ``csr``'s piece
    table in the feature tile :func:`slab_tile` gives for x on the card's L2
    (``budget`` replaces the card's share, for tests); (rows of ``csr``, F)
    f32 out. A launch whose x does not fit adds its tiles to the counter
    ``rspmm_sum_fwd.slab_tiles`` of ``utils/profiling.py``."""
    features = pieces.features(entry)
    width = x.shape[1] // features
    tile = group_size(width)
    if x.is_cuda:  # a tensor elsewhere is refused before any launch
        if budget is None:
            budget = slab_budget(l2_bytes(x.device))
        tile = slab_tile(x.shape[0], x.shape[1], x.element_size(), features, budget)
    out = pieces.launch_pieces(entry, op, csr, edge_weight, relation, x, mul_code, tile)
    if tile < group_size(width):
        profiling.count("rspmm_sum_fwd.slab_tiles", -(-width // tile))
    return out


def rspmm_sum_fwd_plain(csr: CSR, edge_weight, relation, x, mul: str = "mul"):
    """``out[v] = sum_{e in row v} w[eid_e] * op(rel[etype_e], x[col_e])``
    with index_select, the elementwise op and index_add_, in
    :func:`pieces.compute_type` (f32 on the path, bf16 rows widened first; f64
    gives a reference for the kernel's rounding)."""
    num_rows = csr.rowptr.numel() - 1
    dst = pieces.csr_rows(csr)
    dtype = pieces.compute_type(edge_weight, relation, x)
    rel_e = relation.index_select(0, csr.etype).to(dtype)
    x_e = x.index_select(0, csr.col).to(dtype)
    msg = rel_e * x_e if mul == "mul" else rel_e + x_e
    msg = msg * edge_weight.index_select(0, csr.eid).to(dtype).unsqueeze(1)
    out = torch.zeros(num_rows, x.shape[1], dtype=msg.dtype, device=x.device)
    return out.index_add_(0, dst, msg)


@build.counted
def rspmm_sum_fwd(csr: CSR, edge_weight, relation, x, mul: str = "mul"):
    """Sum rspmm forward over a destination-major CSR; (V, F) f32 out.

    ``relation`` (R, F) and ``x`` (N, F) are f32 or bf16 each and
    contiguous (and on the card both 16-byte aligned, and F % 4 == 0 for
    f32 rows, F % 8 == 0 for bf16 ones); ``mul`` is
    ``"mul"`` (distmult) or ``"add"`` (transe). On a
    CPU tensor this runs :func:`rspmm_sum_fwd_plain`; on a CUDA tensor it
    launches B1's instance for the two types, building it first if needed,
    and raises if it cannot.
    """
    pieces.check_dtypes(edge_weight, relation, x, mul)
    entry = pieces.entry("rspmm_sum_fwd", "rspmm_sum_fwd", relation, x)
    if x.device.type == "cpu":
        return rspmm_sum_fwd_plain(csr, edge_weight, relation, x, mul)
    out = launch_sum(entry, "rspmm_sum_fwd", csr, edge_weight, relation, x, pieces.MUL_CODE[mul])
    rspmm_sum_fwd.launches[pieces.launch_key(out.shape, entry)] += 1
    return out


def _rel_or_ones(relation, mul):
    # d message / d x is rel (mul) or 1 (add): the transposed forward with
    # that relation and mul="mul" gives d_x (rspmm_pallas.py:1345-1347); the
    # ones take the relation's type (1 is exact in bf16)
    return relation if mul == "mul" else torch.ones_like(relation)


def rspmm_sum_dx_plain(csr_src: CSR, edge_weight, relation, g, mul: str = "mul"):
    """``d_x[u] = sum_{e: src_e = u} w_e * (rel[type_e] if mul else 1) * g[dst_e]``:
    :func:`rspmm_sum_fwd_plain` on the source-major CSR."""
    return rspmm_sum_fwd_plain(csr_src, edge_weight, _rel_or_ones(relation, mul), g, "mul")


@build.counted
def rspmm_sum_dx(csr_src: CSR, edge_weight, relation, g, mul: str = "mul"):
    """Input gradient of the sum rspmm: (N, F) f32 from the f32 output
    gradient ``g`` (V, F) and the f32 or bf16 ``relation``, walking the
    source-major CSR ``csr_src``. Launches B1 on a CUDA tensor (its
    (relation type, f32) instance, which for bf16 relation rows takes F %
    8 == 0 and 16-byte aligned rows; counted here, not in
    :func:`rspmm_sum_fwd`), runs :func:`rspmm_sum_dx_plain` on a CPU one."""
    pieces.check_dtypes(edge_weight, relation, g, mul, op="rspmm_sum_dx", g=g)
    entry = pieces.entry("rspmm_sum_dx", "rspmm_sum_fwd", relation, g)
    if g.device.type == "cpu":
        return rspmm_sum_dx_plain(csr_src, edge_weight, relation, g, mul)
    rel = _rel_or_ones(relation, mul)
    out = launch_sum(entry, "rspmm_sum_dx", csr_src, edge_weight, rel, g, pieces.MUL_CODE["mul"])
    rspmm_sum_dx.launches[pieces.launch_key(out.shape, entry)] += 1
    return out


def rspmm_sum_drel_plain(seg: TypeSegments, edge_weight, x, g, mul: str = "mul"):
    """``d_rel[t] = sum_{e: type_e = t} w_e * (x[src_e] if mul else 1) * g[dst_e]``
    with index_select on the type-sorted edges, the product and index_add_
    by type, in :func:`pieces.compute_type`."""
    dtype = pieces.compute_type(edge_weight, x, g)
    msg = g.index_select(0, seg.dst).to(dtype)
    if mul == "mul":
        msg = x.index_select(0, seg.src).to(dtype) * msg
    msg = msg * edge_weight.index_select(0, seg.eid).to(dtype).unsqueeze(1)
    out = torch.zeros(seg.num_types, g.shape[1], dtype=msg.dtype, device=g.device)
    return out.index_add_(0, seg.etype, msg)


@build.counted
def rspmm_sum_drel(seg: TypeSegments, edge_weight, x, g, mul: str = "mul"):
    """Relation gradient of the sum rspmm: (R, F) f32, R = ``seg.num_types``,
    from the forward's input ``x`` (N, F, f32 or bf16; not read for
    ``"add"``) and the f32 output gradient ``g`` (V, F). On a CPU tensor
    this runs :func:`rspmm_sum_drel_plain`; on a CUDA tensor it launches
    B2's instance for x's type over the segments' piece table (both of its
    passes, one count; for bf16 x, F % 8 == 0 and x and g 16-byte
    aligned), building it first if needed, and raises if it cannot."""
    pieces.check_mul(mul)
    pieces.check_types("rspmm_sum_drel", {"x": x}, {"g": g, "edge_weight": edge_weight})
    if x.dim() != 2 or g.dim() != 2 or x.shape[1] != g.shape[1]:
        raise ValueError(f"want x (N, F) and g (V, F), got {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    entry = pieces.entry("rspmm_sum_drel", "rspmm_sum_drel", x)
    if g.device.type == "cpu":
        return rspmm_sum_drel_plain(seg, edge_weight, x, g, mul)
    out = pieces.launch_walk(entry, "rspmm_sum_drel", seg, seg.num_types,
                             {"src": seg.src, "dst": seg.dst, "eid": seg.eid},
                             edge_weight, {"x": x, "g": g}, pieces.MUL_CODE[mul])
    rspmm_sum_drel.launches[pieces.launch_key((g.shape[0], *out.shape), entry)] += 1
    return out


def rspmm_dw_terms(csr: CSR, edge_weight, relation, x, g, mul: str = "mul", out=None):
    """The edge-weight gradient's terms, one row per CSR edge: ``terms[e] =
    route_e * (rel[type_e] op x[src_e]) * g[dst_e]`` in ``g``'s type. Without
    ``out`` (sum) the route is 1; with the forward's saved ``out`` (min/max)
    it is 1 where the edge is live and ``(rel op x) * w == out[dst]``,
    compared in :func:`pieces.compute_type` of ``relation`` and ``x`` (f32 for
    f32 and bf16 rows), so an f64 ``g`` gives a reference that routes as the
    forward did. d_w[eid] is each row's sum."""
    rows = pieces.csr_rows(csr)
    dtype = pieces.compute_type(relation, x)
    m = relation.index_select(0, csr.etype).to(dtype)
    x_e = x.index_select(0, csr.col).to(dtype)
    m = m * x_e if mul == "mul" else m + x_e
    terms = m.to(g.dtype) * g.index_select(0, rows)
    if out is None:
        return terms
    w_e = edge_weight.index_select(0, csr.eid).unsqueeze(1)
    route = (m * w_e == out.index_select(0, rows)) & (w_e != 0)
    return torch.where(route, terms, torch.zeros((), dtype=g.dtype, device=g.device))


def rspmm_dw_plain(csr: CSR, edge_weight, relation, x, g, mul: str = "mul", out=None):
    """(E_pad,) edge-weight gradient: each CSR edge's :func:`rspmm_dw_terms`
    summed over the features and put at its ``eid``; a slot not in the CSR
    (the padding) is 0. In ``g``'s type."""
    d_w = torch.zeros(edge_weight.shape, dtype=g.dtype, device=g.device)
    return d_w.index_put_((csr.eid.long(),),
                          rspmm_dw_terms(csr, edge_weight, relation, x, g, mul, out).sum(1))


@build.counted
def rspmm_dw(csr: CSR, edge_weight, relation, x, g, mul: str = "mul", out=None):
    """Edge-weight gradient of the rspmm: (E_pad,) f32 from the forward's
    inputs (``relation`` (R, F), ``x`` (N, F), f32 or bf16 each) and the f32
    output gradient ``g`` (V, F), walking the destination-major CSR
    ``csr``; all contiguous (and on the card 16-byte aligned, with F % 4
    == 0 for f32 rows and F % 8 == 0 for bf16 ones). ``out``, the min/max
    forward's saved output (f32), switches the tie routing on; without it
    this is the sum's gradient, which a runtime-masked edge gets in full. A
    slot not in the CSR is 0. On a CPU
    tensor this runs :func:`rspmm_dw_plain`; on a CUDA tensor it launches
    B6's instance for the two row types over ``csr``'s piece table, building
    it first if needed, and raises if it cannot."""
    pieces.check_dtypes(edge_weight, relation, x, mul, op="rspmm_dw", g=g,
                        **({} if out is None else {"out": out}))
    num_rows = csr.rowptr.numel() - 1
    if g.shape != (num_rows, x.shape[1]) or (out is not None and out.shape != g.shape):
        raise ValueError(f"rspmm_dw: want g (and out) ({num_rows}, {x.shape[1]}), got "
                         f"{tuple(g.shape)}" + ("" if out is None else f", {tuple(out.shape)}"))
    entry = pieces.entry("rspmm_dw", "rspmm_dw", relation, x)
    if g.device.type == "cpu":
        return rspmm_dw_plain(csr, edge_weight, relation, x, g, mul, out)
    kernel = build.bind(entry)
    rows = {"relation": relation, "x": x, "g": g, **({} if out is None else {"out": out})}
    # the CSR checked its own fields when it was made (graph.CSR): col stands
    # for them, as in the forwards' wrappers
    pieces.check_operands("rspmm_dw", g.device, rows, ("col", csr.col), edge_weight,
                          pieces.features(entry))
    d_w = torch.zeros(edge_weight.shape, dtype=torch.float32, device=g.device)
    if num_rows == 0 or x.shape[1] == 0:
        return d_w
    launch_dw(kernel, csr, edge_weight, relation, x, g, mul, out, d_w)
    rspmm_dw.launches[pieces.launch_key((num_rows, x.shape[1]), entry)] += 1
    return d_w


def launch_dw(kernel, csr: CSR, edge_weight, relation, x, g, mul, out, d_w):
    """B6 (``kernel``, one of its bound entry points) on checked operands:
    writes the d_w of each CSR edge into ``d_w`` at its eid and leaves every
    other slot as it was."""
    operands = (csr.piece_ptr, csr.piece_row, csr.piece_order, csr.col, csr.etype, csr.eid,
                edge_weight, relation, x, g)
    build.launch(kernel, "rspmm_dw", g.device, *(t.data_ptr() for t in operands),
                 0 if out is None else out.data_ptr(), d_w.data_ptr(), csr.piece_row.numel(),
                 x.shape[1], pieces.MUL_CODE[mul], int(out is not None), DW_PARTS)

"""The sum-aggregation rspmm kernels for Hopper, their ctypes bindings and
launch counters, and their plain PyTorch versions.

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
its design does about that. A wrapper takes the plain version for a tensor
on the CPU and launches the kernel for one on a CUDA device; it never falls
back from one to the other.

Operand types (``compute_dtype: bfloat16``, as the Pallas kernels take it):
the relation and x rows may each be f32 or bf16; the edge weights, the
output gradient ``g`` and the min/max forward's saved output are f32, and
every output is f32. Each source is built with one C entry point per
combination of row types the paths give it (``rspmm_sum_fwd`` for f32
rows, ``rspmm_sum_fwd_bf16_bf16``, and ``rspmm_sum_fwd_bf16_f32`` for the
input gradient; B2, whose only row operand is x, ``rspmm_sum_drel_bf16``;
B3-B6 ``..._bf16_bf16``: :data:`_INSTANCES`), and a wrapper launches the
one its operands' types name: no operand is cast, and any other type or
combination raises ``TypeError``, on the CPU too.
The plain versions widen a bf16 row to f32 before any arithmetic, as the
kernels do, so both compute f32 arithmetic on bf16-rounded operands.
Every bf16 instance (B1's two, B2's, B3's, B4's, B5's and B6's) walks 8
features a thread (one 16-byte load of a bf16 row, :data:`_FEATURES`) and
takes on the card only F % 8 == 0; every f32 instance walks 4 and takes F
% 4 == 0. Every row operand of every instance starts 16-byte aligned.
Anything else raises ``ValueError`` before any launch.

Each wrapper's ``launches`` is a :class:`collections.Counter` of its kernel
launches by output shape ``(rows, F)`` since the last ``clear()``, so a
caller can tell the entity graph's launches from the relation graph's; a
launch of a bf16 instance counts under the shape and the instance's types,
e.g. ``(rows, F, "bf16_bf16")``. B2 counts by ``(V, R, F)``, the graph's
nodes before its output shape: every relation graph has R = 4, so its
output shape alone names no graph.
"""

from __future__ import annotations

import collections
import ctypes
import re

import torch

from ultra_tpu_torch.graph import CSR, TypeSegments
from ultra_tpu_torch.ops import build
from ultra_tpu_torch.utils import profiling

_MUL_CODE = {"mul": 0, "add": 1}
# the groups of threads B6 splits each piece of the CSR over: its edges' sums
# are independent, so the longest walk shortens with no second pass
DW_PARTS = 2
_KERNELS = {}  # name -> the bound C entry point, set at first launch
# the C signatures of every kernel in csrc/ (the min/max ones are launched
# from ops/rspmm_minmax_cuda.py, the gathers from ops/gather_cuda.py, the
# conv epilogue from ops/epilogue_cuda.py); a
# bf16 instance, named as its kernel with a suffix of row types, takes its
# kernel's signature
_ARGTYPES = {
    "rspmm_sum_fwd": [ctypes.c_void_p] * 14 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p,
    ],
    "rspmm_sum_drel": [ctypes.c_void_p] * 14 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "rspmm_minmax_fwd": [ctypes.c_void_p] * 14 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "rspmm_minmax_dx": [ctypes.c_void_p] * 16 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "rspmm_minmax_drel": [ctypes.c_void_p] * 16 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "rspmm_dw": [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "gather_rows": [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ],
    "gather_lanes": [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "gather_lanes_indices": [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "gather_empty": [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "conv_epilogue": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ],
}
# the source of each C entry point that is not named after its own source
_SOURCE = {"gather_rows": "gather", "gather_lanes": "gather", "gather_lanes_indices": "gather",
           "gather_empty": "gather"}


# the element types of the row operands, as the entry points' suffixes name them
_ROW_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the instances each kernel is built with ("" is the f32 one): its row types
# as the paths give them, (relation, x) or B2's x alone; B1's (bf16, f32) is
# the input gradient's, bf16 relation rows against the f32 output gradient
_INSTANCES = {"rspmm_sum_fwd": ("", "bf16_bf16", "bf16_f32"), "rspmm_sum_drel": ("", "bf16"),
              "rspmm_minmax_fwd": ("", "bf16_bf16"), "rspmm_minmax_dx": ("", "bf16_bf16"),
              "rspmm_minmax_drel": ("", "bf16_bf16"), "rspmm_dw": ("", "bf16_bf16")}
# the features a thread owns in the entry points on the 8-feature walk
# (csrc/rspmm_pieces.cuh; B6's own 8-feature pass): every bf16 instance.
# Every f32 instance's thread owns 4
_FEATURES = dict.fromkeys(("rspmm_sum_fwd_bf16_bf16", "rspmm_sum_fwd_bf16_f32",
                           "rspmm_sum_drel_bf16", "rspmm_minmax_fwd_bf16_bf16",
                           "rspmm_minmax_dx_bf16_bf16", "rspmm_minmax_drel_bf16_bf16",
                           "rspmm_dw_bf16_bf16"), 8)


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


_L2_BYTES = {}  # CUDA device index -> its L2's bytes


def _l2_bytes(device) -> int:
    if device.index not in _L2_BYTES:
        _L2_BYTES[device.index] = torch.cuda.get_device_properties(device).L2_cache_size
    return _L2_BYTES[device.index]


def _kernel(name: str):
    """The C entry point ``name`` (a kernel, or one of its instances:
    ``rspmm_sum_fwd_bf16_bf16``), from its source's library."""
    fn = _KERNELS.get(name)
    if fn is None:
        base = re.sub(r"(_(?:bf16|f32))+$", "", name)
        fn = getattr(build.load(_SOURCE.get(base, base)), name)
        fn.argtypes = _ARGTYPES[base]
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn
    return fn


def _instance(op: str, kernel: str, *rows) -> str:
    """The suffix of ``kernel``'s entry point for row operands of these
    types: "" for f32 rows, else their types in the kernel's order
    (``"bf16_bf16"``). Types it is not built for raise, on every device."""
    types = [_ROW_TYPES[t.dtype] for t in rows]
    instance = "" if set(types) == {"f32"} else "_".join(types)
    if instance not in _INSTANCES[kernel]:
        raise TypeError(f"{op}: no instance of {kernel} takes rows of types {types}")
    return instance


def _entry(kernel: str, instance: str) -> str:
    """The C entry point of ``kernel``'s ``instance`` (:func:`_instance`)."""
    return f"{kernel}_{instance}" if instance else kernel


def _count(wrapper, key, instance):
    """One launch of ``wrapper``'s kernel (its ``instance``) at ``key``."""
    wrapper.launches[tuple(key) + ((instance,) if instance else ())] += 1


def _check_mul(mul):
    if mul not in _MUL_CODE:
        raise ValueError(f"mul must be one of {tuple(_MUL_CODE)}, got {mul!r}")


def _check_types(op: str, rows: dict, f32: dict):
    """``rows`` (the relation and x rows) f32 or bf16, ``f32`` (the edge
    weights, ``g``, the saved output) f32; anything else raises."""
    for name, t in rows.items():
        if t.dtype not in _ROW_TYPES:
            raise TypeError(f"{op} takes float32 or bfloat16 {name}, got {t.dtype}")
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{op} takes float32 {name}, got {t.dtype}")


def _check_dtypes(edge_weight, relation, x, mul, op="rspmm_sum_fwd", **f32):
    """mul, the types (relation and x rows f32 or bf16; edge_weight and
    ``f32`` f32) and the shapes: relation (R, F), x (N, F)."""
    _check_mul(mul)
    _check_types(op, {"relation": relation, "x": x}, {"edge_weight": edge_weight, **f32})
    if x.dim() != 2 or relation.dim() != 2 or relation.shape[1] != x.shape[1]:
        raise ValueError(
            f"want x (N, F) and relation (R, F), got {tuple(x.shape)} and "
            f"{tuple(relation.shape)}"
        )


def _compute_type(*tensors):
    """The type a plain version computes in: f32 for f32 and bf16 operands
    (a bf16 row is widened first, as the kernels widen it), f64 where an
    operand is f64 (a reference for the kernels' rounding)."""
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def _check_device_tensors(op: str, device, rows, ptrs, ints, floats, features: int = 4):
    """What the kernels need of their operands: rows of loads of
    ``features`` features a thread (F % features == 0, each row operand
    starting 16-byte aligned, where one load of the walk is), everything
    contiguous on ``device`` (a CUDA device), ``ptrs`` 1-D int64 and
    ``ints`` 1-D int32 of one length. The kernels refuse other widths and
    alignments rather than running them on a slower path."""
    feat = next(iter(rows.values())).shape[1]
    if feat % features:
        raise ValueError(f"{op}: the kernel needs F % {features} == 0, got F={feat}")
    for name, t in rows.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must start 16-byte aligned")
    for name, t in {**rows, **ptrs, **ints, **floats}.items():
        if t.device != device or not t.is_cuda:
            raise ValueError(f"{op}: {name} is on {t.device}, want the CUDA device {device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    for name, t in ptrs.items():
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{op}: {name} must be 1-D int64")
    n = next(iter(ints.values())).numel()
    for name, t in ints.items():
        if t.dtype != torch.int32 or t.dim() != 1 or t.numel() != n:
            raise TypeError(f"{op}: {name} must be 1-D int32 of length {n}")


# the piece table's fields, in the kernels' C order (graph.CSR, graph.TypeSegments)
_TABLE = ("piece_ptr", "piece_row", "piece_slot", "piece_order", "long_rows", "long_slot_ptr")


def _launch_walk(name: str, op: str, table, num_rows: int, indices: dict, edge_weight,
                 rows: dict, *codes, out_name: str = "out"):
    """The kernel entry point ``name`` (an instance of B1, B2, B3, B4 or B5)
    on the card over ``table``'s pieces (a :class:`CSR` or the
    :class:`TypeSegments`); (num_rows, F) f32 out. Its C arguments: the
    piece table, ``indices`` (the layout's three index arrays),
    ``edge_weight``, ``rows`` (the kernel's row operands), each in the
    kernel's order, the partial rows' scratch, the output, the counts and F,
    then ``codes`` (mul_op, and is_min for B3)."""
    kernel = _kernel(name)
    num_feat = next(iter(rows.values())).shape[1]
    device = edge_weight.device
    num_pieces, num_long = table.piece_row.numel(), table.long_rows.numel()
    out = torch.empty(num_rows, num_feat, dtype=torch.float32, device=device)
    scratch = {out_name: out}
    if num_long:  # the long rows' partials; none where every row is one piece
        scratch["partial"] = torch.empty(table.num_slots, num_feat, dtype=torch.float32,
                                         device=device)
    # the layout checked its own fields' types, lengths and device when it
    # was made (graph.CSR, graph.TypeSegments): its first index array stands
    # for all of them
    first = next(iter(indices))
    _check_device_tensors(op, device, rows={**rows, **scratch}, ptrs={},
                          ints={first: indices[first]}, floats={"edge_weight": edge_weight},
                          features=_FEATURES.get(name, 4))
    if num_rows == 0 or num_feat == 0:
        return out
    operands = ([getattr(table, f) for f in _TABLE] + list(indices.values()) + [edge_weight]
                + list(rows.values()))
    partial = scratch["partial"].data_ptr() if num_long else 0
    with torch.cuda.device(device):
        status = kernel(*(t.data_ptr() for t in operands), partial, out.data_ptr(),
                        num_pieces, num_long, num_feat,
                        *codes, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{op} launch failed with CUDA error {status}")
    return out


def _launch_pieces(name: str, op: str, csr: CSR, edge_weight, relation, x, *codes):
    """B1 (``name`` "rspmm_sum_fwd" or one of its instances) or B3
    ("rspmm_minmax_fwd"...) on the card over ``csr``'s piece table; (rows of
    ``csr``, F) f32 out. ``codes`` are the kernel's int arguments after F
    (mul_op and B1's tile, or mul_op and is_min for B3)."""
    return _launch_walk(name, op, csr, csr.rowptr.numel() - 1,
                        {"col": csr.col, "etype": csr.etype, "eid": csr.eid}, edge_weight,
                        {"relation": relation, "x": x}, *codes)


def _launch_sum(name: str, op: str, csr: CSR, edge_weight, relation, x, mul_code: int,
                budget: int | None = None):
    """B1 (``name``, one of its instances) on the card over ``csr``'s piece
    table in the feature tile :func:`slab_tile` gives for x on the card's L2
    (``budget`` replaces the card's share, for tests); (rows of ``csr``, F)
    f32 out. A launch whose x does not fit adds its tiles to the counter
    ``rspmm_sum_fwd.slab_tiles`` of ``utils/profiling.py``."""
    features = _FEATURES.get(name, 4)
    width = x.shape[1] // features
    tile = group_size(width)
    if x.is_cuda:  # a tensor elsewhere is refused before any launch
        if budget is None:
            budget = slab_budget(_l2_bytes(x.device))
        tile = slab_tile(x.shape[0], x.shape[1], x.element_size(), features, budget)
    out = _launch_pieces(name, op, csr, edge_weight, relation, x, mul_code, tile)
    if tile < group_size(width):
        profiling.count("rspmm_sum_fwd.slab_tiles", -(-width // tile))
    return out


def _csr_rows(csr: CSR):
    """The row of each CSR edge, (E,) int64."""
    num_rows = csr.rowptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(num_rows, device=csr.rowptr.device), csr.rowptr.diff(),
        output_size=csr.col.numel(),
    )


def rspmm_sum_fwd_plain(csr: CSR, edge_weight, relation, x, mul: str = "mul"):
    """``out[v] = sum_{e in row v} w[eid_e] * op(rel[etype_e], x[col_e])``
    with index_select, the elementwise op and index_add_, in
    :func:`_compute_type` (f32 on the path, bf16 rows widened first; f64
    gives a reference for the kernel's rounding)."""
    num_rows = csr.rowptr.numel() - 1
    dst = _csr_rows(csr)
    dtype = _compute_type(edge_weight, relation, x)
    rel_e = relation.index_select(0, csr.etype).to(dtype)
    x_e = x.index_select(0, csr.col).to(dtype)
    msg = rel_e * x_e if mul == "mul" else rel_e + x_e
    msg = msg * edge_weight.index_select(0, csr.eid).to(dtype).unsqueeze(1)
    out = torch.zeros(num_rows, x.shape[1], dtype=msg.dtype, device=x.device)
    return out.index_add_(0, dst, msg)


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
    _check_dtypes(edge_weight, relation, x, mul)
    instance = _instance("rspmm_sum_fwd", "rspmm_sum_fwd", relation, x)
    if x.device.type == "cpu":
        return rspmm_sum_fwd_plain(csr, edge_weight, relation, x, mul)
    out = _launch_sum(_entry("rspmm_sum_fwd", instance), "rspmm_sum_fwd",
                      csr, edge_weight, relation, x, _MUL_CODE[mul])
    _count(rspmm_sum_fwd, out.shape, instance)
    return out


rspmm_sum_fwd.launches = collections.Counter()  # launches by output shape


def _rel_or_ones(relation, mul):
    # d message / d x is rel (mul) or 1 (add): the transposed forward with
    # that relation and mul="mul" gives d_x (rspmm_pallas.py:1345-1347); the
    # ones take the relation's type (1 is exact in bf16)
    return relation if mul == "mul" else torch.ones_like(relation)


def rspmm_sum_dx_plain(csr_src: CSR, edge_weight, relation, g, mul: str = "mul"):
    """``d_x[u] = sum_{e: src_e = u} w_e * (rel[type_e] if mul else 1) * g[dst_e]``:
    :func:`rspmm_sum_fwd_plain` on the source-major CSR."""
    return rspmm_sum_fwd_plain(csr_src, edge_weight, _rel_or_ones(relation, mul), g, "mul")


def rspmm_sum_dx(csr_src: CSR, edge_weight, relation, g, mul: str = "mul"):
    """Input gradient of the sum rspmm: (N, F) f32 from the f32 output
    gradient ``g`` (V, F) and the f32 or bf16 ``relation``, walking the
    source-major CSR ``csr_src``. Launches B1 on a CUDA tensor (its
    (relation type, f32) instance, which for bf16 relation rows takes F %
    8 == 0 and 16-byte aligned rows; counted here, not in
    :func:`rspmm_sum_fwd`), runs :func:`rspmm_sum_dx_plain` on a CPU one."""
    _check_dtypes(edge_weight, relation, g, mul, op="rspmm_sum_dx", g=g)
    instance = _instance("rspmm_sum_dx", "rspmm_sum_fwd", relation, g)
    if g.device.type == "cpu":
        return rspmm_sum_dx_plain(csr_src, edge_weight, relation, g, mul)
    rel = _rel_or_ones(relation, mul)
    out = _launch_sum(_entry("rspmm_sum_fwd", instance), "rspmm_sum_dx",
                      csr_src, edge_weight, rel, g, _MUL_CODE["mul"])
    _count(rspmm_sum_dx, out.shape, instance)
    return out


rspmm_sum_dx.launches = collections.Counter()


def rspmm_sum_drel_plain(seg: TypeSegments, edge_weight, x, g, mul: str = "mul"):
    """``d_rel[t] = sum_{e: type_e = t} w_e * (x[src_e] if mul else 1) * g[dst_e]``
    with index_select on the type-sorted edges, the product and index_add_
    by type, in :func:`_compute_type`."""
    dtype = _compute_type(edge_weight, x, g)
    msg = g.index_select(0, seg.dst).to(dtype)
    if mul == "mul":
        msg = x.index_select(0, seg.src).to(dtype) * msg
    msg = msg * edge_weight.index_select(0, seg.eid).to(dtype).unsqueeze(1)
    out = torch.zeros(seg.num_types, g.shape[1], dtype=msg.dtype, device=g.device)
    return out.index_add_(0, seg.etype, msg)


def rspmm_sum_drel(seg: TypeSegments, edge_weight, x, g, mul: str = "mul"):
    """Relation gradient of the sum rspmm: (R, F) f32, R = ``seg.num_types``,
    from the forward's input ``x`` (N, F, f32 or bf16; not read for
    ``"add"``) and the f32 output gradient ``g`` (V, F). On a CPU tensor
    this runs :func:`rspmm_sum_drel_plain`; on a CUDA tensor it launches
    B2's instance for x's type over the segments' piece table (both of its
    passes, one count; for bf16 x, F % 8 == 0 and x and g 16-byte
    aligned), building it first if needed, and raises if it cannot."""
    _check_mul(mul)
    _check_types("rspmm_sum_drel", {"x": x}, {"g": g, "edge_weight": edge_weight})
    if x.dim() != 2 or g.dim() != 2 or x.shape[1] != g.shape[1]:
        raise ValueError(f"want x (N, F) and g (V, F), got {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    instance = _instance("rspmm_sum_drel", "rspmm_sum_drel", x)
    if g.device.type == "cpu":
        return rspmm_sum_drel_plain(seg, edge_weight, x, g, mul)
    out = _launch_walk(_entry("rspmm_sum_drel", instance), "rspmm_sum_drel",
                       seg, seg.num_types, {"src": seg.src, "dst": seg.dst, "eid": seg.eid},
                       edge_weight, {"x": x, "g": g}, _MUL_CODE[mul])
    _count(rspmm_sum_drel, (g.shape[0], *out.shape), instance)
    return out


rspmm_sum_drel.launches = collections.Counter()  # launches by (V, R, F)


def rspmm_dw_terms(csr: CSR, edge_weight, relation, x, g, mul: str = "mul", out=None):
    """The edge-weight gradient's terms, one row per CSR edge: ``terms[e] =
    route_e * (rel[type_e] op x[src_e]) * g[dst_e]`` in ``g``'s type. Without
    ``out`` (sum) the route is 1; with the forward's saved ``out`` (min/max)
    it is 1 where the edge is live and ``(rel op x) * w == out[dst]``,
    compared in :func:`_compute_type` of ``relation`` and ``x`` (f32 for
    f32 and bf16 rows), so an f64 ``g`` gives a reference that routes as the
    forward did. d_w[eid] is each row's sum."""
    rows = _csr_rows(csr)
    dtype = _compute_type(relation, x)
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
    _check_dtypes(edge_weight, relation, x, mul, op="rspmm_dw", g=g,
                  **({} if out is None else {"out": out}))
    num_rows = csr.rowptr.numel() - 1
    if g.shape != (num_rows, x.shape[1]) or (out is not None and out.shape != g.shape):
        raise ValueError(f"rspmm_dw: want g (and out) ({num_rows}, {x.shape[1]}), got "
                         f"{tuple(g.shape)}" + ("" if out is None else f", {tuple(out.shape)}"))
    instance = _instance("rspmm_dw", "rspmm_dw", relation, x)
    if g.device.type == "cpu":
        return rspmm_dw_plain(csr, edge_weight, relation, x, g, mul, out)
    entry = _entry("rspmm_dw", instance)
    kernel = _kernel(entry)
    rows = {"relation": relation, "x": x, "g": g, **({} if out is None else {"out": out})}
    # the CSR checked its own fields when it was made (graph.CSR): col stands
    # for them, as in the forwards' wrappers
    _check_device_tensors("rspmm_dw", g.device, rows=rows, ptrs={}, ints={"col": csr.col},
                          floats={"edge_weight": edge_weight},
                          features=_FEATURES.get(entry, 4))
    d_w = torch.zeros(edge_weight.shape, dtype=torch.float32, device=g.device)
    if num_rows == 0 or x.shape[1] == 0:
        return d_w
    _launch_dw(kernel, csr, edge_weight, relation, x, g, mul, out, d_w)
    _count(rspmm_dw, (num_rows, x.shape[1]), instance)
    return d_w


def _launch_dw(kernel, csr: CSR, edge_weight, relation, x, g, mul, out, d_w):
    """B6 (``kernel``) on checked operands: writes the d_w of each CSR edge
    into ``d_w`` at its eid and leaves every other slot as it was."""
    operands = (csr.piece_ptr, csr.piece_row, csr.piece_order, csr.col, csr.etype, csr.eid,
                edge_weight, relation, x, g)
    with torch.cuda.device(g.device):
        status = kernel(*(t.data_ptr() for t in operands),
                        0 if out is None else out.data_ptr(), d_w.data_ptr(),
                        csr.piece_row.numel(), x.shape[1], _MUL_CODE[mul], int(out is not None),
                        DW_PARTS, torch.cuda.current_stream(g.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"rspmm_dw launch failed with CUDA error {status}")


rspmm_dw.launches = collections.Counter()  # launches by (rows of the CSR, F)

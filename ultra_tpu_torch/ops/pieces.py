"""The host side of the piece walk that the rspmm kernels B1-B5 share
(``csrc/rspmm_pieces.cuh``), with the operand rules B6 keeps with them:
the instance a call's row types name and the features a thread of it owns
(``ops/rspmm_cuda.py`` says which), the operand checks, the launch over a
layout's piece table, and the plain versions' helpers. ``ops/rspmm_cuda.py``
(B1, B2, B6) and ``ops/rspmm_minmax_cuda.py`` (B3-B5) launch through it.
"""

from __future__ import annotations

import torch

from ultra_tpu_torch.graph import CSR
from ultra_tpu_torch.ops import build

# the edge message's op, as the kernels' mul_op argument codes it
MUL_CODE = {"mul": 0, "add": 1}
# the element types of the row operands, as the instances' names spell them
_ROW_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the piece table's fields, in the kernels' C order (graph.CSR, graph.TypeSegments)
_TABLE = ("piece_ptr", "piece_row", "piece_slot", "piece_order", "long_rows", "long_slot_ptr")


def entry(op: str, kernel: str, *rows) -> str:
    """The entry point of ``kernel``'s instance for row operands of these
    types: "" for f32 rows, else their types in the kernel's order
    (``"bf16_bf16"``). Types it is not built for raise, on every device."""
    types = [_ROW_TYPES[t.dtype] for t in rows]
    name = build.entry_point(kernel, "" if set(types) == {"f32"} else "_".join(types))
    if name not in build.ENTRY_POINTS:
        raise TypeError(f"{op}: no instance of {kernel} takes rows of types {types}")
    return name


def features(entry: str) -> int:
    """The features a thread of the entry point ``entry`` owns: 8 in every
    bf16 instance (the 8-feature walk; B6's own 8-feature pass), else 4."""
    return 8 if build.ENTRY_POINTS[entry][1] else 4


def launch_key(shape, entry: str) -> tuple:
    """A launch counter's key: ``shape``, with the instance ``entry``
    launches after it where that is not the f32 one (``(rows, F,
    "bf16_bf16")``)."""
    instance = build.ENTRY_POINTS[entry][1]
    return (*shape, instance) if instance else tuple(shape)


def check_mul(mul):
    if mul not in MUL_CODE:
        raise ValueError(f"mul must be one of {tuple(MUL_CODE)}, got {mul!r}")


def check_types(op: str, rows: dict, f32: dict):
    """``rows`` (the relation and x rows) f32 or bf16, ``f32`` (the edge
    weights, ``g``, the saved output) f32; anything else raises."""
    for name, t in rows.items():
        if t.dtype not in _ROW_TYPES:
            raise TypeError(f"{op} takes float32 or bfloat16 {name}, got {t.dtype}")
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{op} takes float32 {name}, got {t.dtype}")


def check_dtypes(edge_weight, relation, x, mul, op="rspmm_sum_fwd", **f32):
    """mul, the types (relation and x rows f32 or bf16; edge_weight and
    ``f32`` f32) and the shapes: relation (R, F), x (N, F)."""
    check_mul(mul)
    check_types(op, {"relation": relation, "x": x}, {"edge_weight": edge_weight, **f32})
    if x.dim() != 2 or relation.dim() != 2 or relation.shape[1] != x.shape[1]:
        raise ValueError(
            f"want x (N, F) and relation (R, F), got {tuple(x.shape)} and "
            f"{tuple(relation.shape)}"
        )


def compute_type(*tensors):
    """The type a plain version computes in: f32 for f32 and bf16 operands
    (a bf16 row is widened first, as the kernels widen it), f64 where an
    operand is f64 (a reference for the kernels' rounding)."""
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def check_operands(op: str, device, rows: dict, index: tuple, edge_weight, features: int):
    """What the kernels need of their operands: ``rows`` ({name: row
    operand}) in loads of ``features`` features a thread (F % features ==
    0, each starting 16-byte aligned, where one load of the walk is),
    everything contiguous on ``device`` (a CUDA device), and ``index`` (its
    name and tensor: the layout's first index array, which stands for the
    fields the layout checked when it was made, ``graph.CSR``,
    ``graph.TypeSegments``) 1-D int32. The kernels refuse other widths and
    alignments rather than running them on a slower path."""
    feat = next(iter(rows.values())).shape[1]
    if feat % features:
        raise ValueError(f"{op}: the kernel needs F % {features} == 0, got F={feat}")
    for name, t in rows.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must start 16-byte aligned")
    name, idx = index
    build.check_device(op, device, {**rows, name: idx, "edge_weight": edge_weight})
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"{op}: {name} must be 1-D int32")


def launch_walk(entry: str, op: str, table, num_rows: int, indices: dict, edge_weight,
                rows: dict, *codes, out_name: str = "out"):
    """The entry point ``entry`` (an instance of B1, B2, B3, B4 or B5) on
    the card over ``table``'s pieces (a :class:`CSR` or the
    :class:`TypeSegments`); (num_rows, F) f32 out. Its C arguments: the
    piece table, ``indices`` (the layout's three index arrays),
    ``edge_weight``, ``rows`` (the kernel's row operands), each in the
    kernel's order, the partial rows' scratch, the output, the counts and F,
    then ``codes`` (mul_op, B1's tile, B3's is_min)."""
    kernel = build.bind(entry)
    num_feat = next(iter(rows.values())).shape[1]
    device = edge_weight.device
    num_pieces, num_long = table.piece_row.numel(), table.long_rows.numel()
    out = torch.empty(num_rows, num_feat, dtype=torch.float32, device=device)
    scratch = {out_name: out}
    if num_long:  # the long rows' partials; none where every row is one piece
        scratch["partial"] = torch.empty(table.num_slots, num_feat, dtype=torch.float32,
                                         device=device)
    first = next(iter(indices))
    check_operands(op, device, {**rows, **scratch}, (first, indices[first]), edge_weight,
                   features(entry))
    if num_rows == 0 or num_feat == 0:
        return out
    operands = ([getattr(table, f) for f in _TABLE] + list(indices.values()) + [edge_weight]
                + list(rows.values()))
    partial = scratch["partial"].data_ptr() if num_long else 0
    build.launch(kernel, op, device, *(t.data_ptr() for t in operands), partial,
                 out.data_ptr(), num_pieces, num_long, num_feat, *codes)
    return out


def launch_pieces(entry: str, op: str, csr: CSR, edge_weight, relation, x, *codes):
    """B1 (``entry`` "rspmm_sum_fwd" or one of its instances) or B3
    ("rspmm_minmax_fwd"...) on the card over ``csr``'s piece table; (rows of
    ``csr``, F) f32 out. ``codes`` are the kernel's int arguments after F
    (mul_op and B1's tile, or mul_op and is_min for B3)."""
    return launch_walk(entry, op, csr, csr.rowptr.numel() - 1,
                       {"col": csr.col, "etype": csr.etype, "eid": csr.eid}, edge_weight,
                       {"relation": relation, "x": x}, *codes)


def csr_rows(csr: CSR):
    """The row of each CSR edge, (E,) int64."""
    num_rows = csr.rowptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(num_rows, device=csr.rowptr.device), csr.rowptr.diff(),
        output_size=csr.col.numel(),
    )

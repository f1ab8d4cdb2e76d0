"""The min/max-aggregation rspmm kernels for Hopper, their ctypes bindings
and launch counters, and their plain PyTorch versions.

- B3, ``csrc/rspmm_minmax_fwd.cu``: the forward over a destination-major
  CSR (:func:`rspmm_minmax_fwd`). It replaces
  ``ultra_tpu/ops/rspmm_pallas.py::_minmax_kernel`` and
  ``rspmm_pallas_v2.py::_minmax_kernel_v2``. It walks the CSR's piece table
  as B1 does (``ops/rspmm_cuda.py``), and takes the extreme of a long row's
  partial rows in a second pass: exact, so the output does not depend on
  how the rows were cut.
- B4, ``csrc/rspmm_minmax_dx.cu``: the input gradient over the source-major
  CSR (:func:`rspmm_minmax_dx`). It replaces
  ``rspmm_pallas.py::_minmax_dx_kernel`` and
  ``rspmm_pallas_v2.py::_minmax_dx_kernel_v2``. It walks that CSR's piece
  table as B1 does, and adds a long row's partial rows in slot order.
- B5, ``csrc/rspmm_minmax_drel.cu``: the relation gradient over the type
  segments (:func:`rspmm_minmax_drel`). It replaces
  ``rspmm_pallas.py::_minmax_drel_kernel`` and
  ``rspmm_pallas_v2.py::_minmax_drel_kernel_v2``. It walks the segments'
  piece table as B2 does (``ops/rspmm_cuda.py``), and adds a long type's
  partial rows in a fixed order.

The message of a live edge (weight not 0) is ``(rel op x) * w``, rounded
after each operation to f32 (a bf16 row widened to f32 first), in that
order, in the kernels and in the plain versions alike: the gradients route
``g[dst]`` to every live edge whose recomputed message equals the forward's
saved output, so the two sides of that comparison must be bit-identical. Every tying edge gets the whole
gradient. A row with no live edge is -inf (max) or +inf (min).

As in ``rspmm_cuda``, the relation and x rows are f32 or bf16 (both alike)
and select the kernel's instance, ``g`` and the saved output are f32; a wrapper
takes the plain version for a tensor on the CPU and launches the kernel for
one on a CUDA device, never falling back from one to the other; each
wrapper's ``launches`` counts its kernel launches by output shape ``(rows,
F)`` (and a bf16 instance's types) since the last ``clear()``.
"""

from __future__ import annotations

import collections

import torch

from ultra_tpu_torch.graph import CSR, TypeSegments
from ultra_tpu_torch.ops.rspmm_cuda import (
    _MUL_CODE, _check_dtypes, _compute_type, _count, _csr_rows, _entry, _instance,
    _launch_pieces, _launch_walk,
)


def _message(rel_e, x_e, w_e, mul):
    """``(rel op x) * w`` per edge, each operation rounded in
    :func:`_compute_type` of the three (f32 for f32 and bf16 rows): the
    value the kernels compute and route against."""
    dtype = _compute_type(rel_e, x_e, w_e)
    rel_e, x_e = rel_e.to(dtype), x_e.to(dtype)
    m = rel_e * x_e if mul == "mul" else rel_e + x_e
    return m * w_e.to(dtype).unsqueeze(1)


def rspmm_minmax_fwd_plain(csr: CSR, edge_weight, relation, x, mul: str = "mul",
                           is_min: bool = False):
    """``out[v] = max`` (or ``min``) ``over the live edges e of row v of
    (rel[etype_e] op x[col_e]) * w[eid_e]`` with index_select and
    scatter_reduce_ (an exact reduction, so the order does not matter); a
    row with no live edge is -inf (max) or +inf (min). Forward values only:
    scatter_reduce_'s own gradient shares a tie between the tying edges,
    where the rspmm gives each of them the whole gradient."""
    rows = _csr_rows(csr)
    w_e = edge_weight.index_select(0, csr.eid)
    live = w_e != 0
    rows, w_e = rows[live], w_e[live]
    msg = _message(relation.index_select(0, csr.etype[live]),
                   x.index_select(0, csr.col[live]), w_e, mul)
    fill = float("inf") if is_min else float("-inf")
    out = torch.full((csr.rowptr.numel() - 1, x.shape[1]), fill, dtype=msg.dtype,
                     device=x.device)
    return out.scatter_reduce_(0, rows.unsqueeze(1).expand_as(msg), msg,
                               "amin" if is_min else "amax", include_self=True)


def rspmm_minmax_fwd(csr: CSR, edge_weight, relation, x, mul: str = "mul",
                     is_min: bool = False):
    """Min/max rspmm forward over a destination-major CSR; (V, F) f32 out.

    ``relation`` (R, F) and ``x`` (N, F) are f32 or bf16 each and
    contiguous (and on the card, F % 4 == 0 and both 16-byte aligned for f32
    rows; for bf16 rows F % 8 == 0 and both 16-byte aligned). On a CPU
    tensor this runs :func:`rspmm_minmax_fwd_plain`; on
    a CUDA tensor it launches B3's instance for the two types, building it
    first if needed, and raises if it cannot."""
    _check_dtypes(edge_weight, relation, x, mul, op="rspmm_minmax_fwd")
    instance = _instance("rspmm_minmax_fwd", "rspmm_minmax_fwd", relation, x)
    if x.device.type == "cpu":
        return rspmm_minmax_fwd_plain(csr, edge_weight, relation, x, mul, is_min)
    out = _launch_pieces(_entry("rspmm_minmax_fwd", instance), "rspmm_minmax_fwd", csr,
                         edge_weight, relation, x, _MUL_CODE[mul], int(bool(is_min)))
    _count(rspmm_minmax_fwd, out.shape, instance)
    return out


rspmm_minmax_fwd.launches = collections.Counter()  # launches by output shape


def _check_backward(op, edge_weight, relation, x, g, out, mul):
    """The operands' types and shapes; returns the instance to launch."""
    _check_dtypes(edge_weight, relation, x, mul, op=op, g=g, out=out)
    if g.shape != out.shape or g.dim() != 2 or g.shape[1] != x.shape[1]:
        raise ValueError(f"{op}: want g and out (V, F) with F={x.shape[1]}, got "
                         f"{tuple(g.shape)} and {tuple(out.shape)}")
    return _instance(op, op, relation, x)


def rspmm_minmax_dx_terms(csr_src: CSR, edge_weight, relation, x, g, out, mul: str = "mul"):
    """The input gradient's terms, one row per live edge: ``(src, terms)``
    with ``terms[e] = w_e * (rel[type_e] if mul else 1) * g[dst_e]`` where
    the edge is routed (``(rel op x[src]) * w == out[dst]``, the message as
    :func:`_message` computes it) and 0 elsewhere, in ``g``'s type; d_x is
    their sum by ``src``. An f64 ``g`` gives a reference that routes as the
    forward did."""
    src = _csr_rows(csr_src)
    w_e = edge_weight.index_select(0, csr_src.eid)
    live = w_e != 0
    src, w_e = src[live], w_e[live]
    dst, rel_e = csr_src.col[live], relation.index_select(0, csr_src.etype[live])
    route = _message(rel_e, x.index_select(0, src), w_e, mul) == out.index_select(0, dst)
    terms = w_e.to(g.dtype).unsqueeze(1)
    if mul == "mul":
        terms = terms * rel_e.to(g.dtype)
    terms = terms * g.index_select(0, dst)
    return src, torch.where(route, terms, torch.zeros((), dtype=g.dtype, device=g.device))


def rspmm_minmax_dx_plain(csr_src: CSR, edge_weight, relation, x, g, out, mul: str = "mul"):
    """``d_x[u] = sum over the routed live edges e with src_e = u of
    w_e * (rel[type_e] if mul else 1) * g[dst_e]`` (:func:`rspmm_minmax_dx_terms`
    added by source with index_add_), in ``g``'s type."""
    src, terms = rspmm_minmax_dx_terms(csr_src, edge_weight, relation, x, g, out, mul)
    d_x = torch.zeros(x.shape[0], g.shape[1], dtype=g.dtype, device=g.device)
    return d_x.index_add_(0, src, terms)


def rspmm_minmax_dx(csr_src: CSR, edge_weight, relation, x, g, out, mul: str = "mul"):
    """Input gradient of the min/max rspmm: (N, F) f32 from the forward's
    inputs (``relation`` (R, F) and ``x`` (N, F), f32 or bf16 each), its
    saved output ``out`` (V, F; +-inf rows kept) and the output gradient
    ``g`` (V, F), both f32, walking the source-major CSR ``csr_src``; all
    contiguous (and on the card, F % 4 == 0 for f32 rows and F % 8 == 0
    for bf16 ones, and every row operand 16-byte aligned). On a
    CPU tensor this runs :func:`rspmm_minmax_dx_plain`; on a CUDA tensor it
    launches B4's instance for the two row types over ``csr_src``'s piece
    table (both of its passes, one count), building it first if needed, and
    raises if it cannot."""
    instance = _check_backward("rspmm_minmax_dx", edge_weight, relation, x, g, out, mul)
    if g.device.type == "cpu":
        return rspmm_minmax_dx_plain(csr_src, edge_weight, relation, x, g, out, mul)
    d_x = _launch_walk(_entry("rspmm_minmax_dx", instance), "rspmm_minmax_dx", csr_src,
                       csr_src.rowptr.numel() - 1,
                       {"col": csr_src.col, "etype": csr_src.etype, "eid": csr_src.eid},
                       edge_weight, {"relation": relation, "x": x, "g": g, "out": out},
                       _MUL_CODE[mul], out_name="d_x")
    _count(rspmm_minmax_dx, d_x.shape, instance)
    return d_x


rspmm_minmax_dx.launches = collections.Counter()


def rspmm_minmax_drel_terms(seg: TypeSegments, edge_weight, relation, x, g, out,
                            mul: str = "mul"):
    """The relation gradient's terms, one row per live edge: ``(type,
    terms)`` with ``terms[e] = w_e * (x[src_e] if mul else 1) * g[dst_e]``
    where the edge is routed (as in :func:`rspmm_minmax_dx_terms`) and 0
    elsewhere, in ``g``'s type; d_rel is their sum by type."""
    w_e = edge_weight.index_select(0, seg.eid)
    live = w_e != 0
    w_e, etype, dst = w_e[live], seg.etype[live], seg.dst[live]
    x_e = x.index_select(0, seg.src[live])
    route = (_message(relation.index_select(0, etype), x_e, w_e, mul)
             == out.index_select(0, dst))
    terms = w_e.to(g.dtype).unsqueeze(1)
    if mul == "mul":
        terms = terms * x_e.to(g.dtype)
    terms = terms * g.index_select(0, dst)
    return etype, torch.where(route, terms, torch.zeros((), dtype=g.dtype, device=g.device))


def rspmm_minmax_drel_plain(seg: TypeSegments, edge_weight, relation, x, g, out,
                            mul: str = "mul"):
    """``d_rel[t] = sum over the routed live edges e of type t of
    w_e * (x[src_e] if mul else 1) * g[dst_e]`` (:func:`rspmm_minmax_drel_terms`
    added by type with index_add_), in ``g``'s type."""
    etype, terms = rspmm_minmax_drel_terms(seg, edge_weight, relation, x, g, out, mul)
    d_rel = torch.zeros(seg.num_types, g.shape[1], dtype=g.dtype, device=g.device)
    return d_rel.index_add_(0, etype, terms)


def rspmm_minmax_drel(seg: TypeSegments, edge_weight, relation, x, g, out, mul: str = "mul"):
    """Relation gradient of the min/max rspmm: (R, F) f32, R =
    ``seg.num_types`` = the rows of ``relation``, from the forward's inputs,
    its saved output ``out`` and the output gradient ``g`` (types as for
    :func:`rspmm_minmax_dx`; on the card F % 4 == 0 for f32 rows and F % 8
    == 0 for bf16 ones, every row operand 16-byte aligned). ``x`` is read for
    ``"add"`` too: the route needs the message. On a CPU tensor this runs
    :func:`rspmm_minmax_drel_plain`; on a CUDA tensor it launches B5's
    instance for the two row types over the segments' piece table (both of
    its passes, one count), building it first if needed, and raises if it
    cannot."""
    instance = _check_backward("rspmm_minmax_drel", edge_weight, relation, x, g, out, mul)
    if relation.shape[0] != seg.num_types:
        raise ValueError(f"rspmm_minmax_drel: relation has {relation.shape[0]} rows, the "
                         f"segments {seg.num_types} types")
    if g.device.type == "cpu":
        return rspmm_minmax_drel_plain(seg, edge_weight, relation, x, g, out, mul)
    d_rel = _launch_walk(_entry("rspmm_minmax_drel", instance), "rspmm_minmax_drel", seg,
                         seg.num_types, {"src": seg.src, "dst": seg.dst, "eid": seg.eid},
                         edge_weight, {"relation": relation, "x": x, "g": g, "out": out},
                         _MUL_CODE[mul], out_name="d_rel")
    _count(rspmm_minmax_drel, d_rel.shape, instance)
    return d_rel


rspmm_minmax_drel.launches = collections.Counter()

"""The min/max-aggregation rspmm kernels for Hopper, their ctypes bindings
and launch counters, and their plain PyTorch versions.

- B3, ``csrc/rspmm_minmax_fwd.cu``: the forward over a destination-major
  CSR (:func:`rspmm_minmax_fwd`). It replaces
  ``ultra_tpu/ops/rspmm_pallas.py::_minmax_kernel`` and
  ``rspmm_pallas_v2.py::_minmax_kernel_v2``.
- B4, ``csrc/rspmm_minmax_dx.cu``: the input gradient over the source-major
  CSR (:func:`rspmm_minmax_dx`). It replaces
  ``rspmm_pallas.py::_minmax_dx_kernel`` and
  ``rspmm_pallas_v2.py::_minmax_dx_kernel_v2``.
- B5, ``csrc/rspmm_minmax_drel.cu``: the relation gradient over the type
  segments (:func:`rspmm_minmax_drel`). It replaces
  ``rspmm_pallas.py::_minmax_drel_kernel`` and
  ``rspmm_pallas_v2.py::_minmax_drel_kernel_v2``.

The message of a live edge (weight not 0) is ``(rel op x) * w``, rounded
after each operation, in that order, in the kernels and in the plain
versions alike: the gradients route ``g[dst]`` to every live edge whose
recomputed message equals the forward's saved output, so the two sides of
that comparison must be bit-identical. Every tying edge gets the whole
gradient. A row with no live edge is -inf (max) or +inf (min).

As in ``rspmm_cuda``, a wrapper takes the plain version for a tensor on the
CPU and launches the kernel for one on a CUDA device, never falling back
from one to the other; each wrapper's ``launches`` counts its kernel
launches by output shape ``(rows, F)`` since the last ``clear()``.
"""

from __future__ import annotations

import collections

import torch

from ultra_tpu_torch.graph import CSR, TypeSegments
from ultra_tpu_torch.ops.rspmm_cuda import (
    _MUL_CODE, _check_device_tensors, _check_dtypes, _check_f32, _kernel,
)


def _csr_rows(csr: CSR):
    """The row of each CSR edge, (E,) int64."""
    num_rows = csr.rowptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(num_rows, device=csr.rowptr.device), csr.rowptr.diff(),
        output_size=csr.col.numel(),
    )


def _message(rel_e, x_e, w_e, mul):
    """``(rel op x) * w`` per edge, each operation rounded in the operands'
    type: the value the kernels compute and route against."""
    m = rel_e * x_e if mul == "mul" else rel_e + x_e
    return m * w_e.unsqueeze(1)


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

    ``relation`` (R, F) and ``x`` (N, F) are f32 and contiguous (and on the
    card, F % 4 == 0 and both 16-byte aligned). On a CPU tensor this runs
    :func:`rspmm_minmax_fwd_plain`; on a CUDA tensor it launches B3,
    building it first if needed, and raises if it cannot."""
    _check_dtypes(edge_weight, relation, x, mul, op="rspmm_minmax_fwd")
    if x.device.type == "cpu":
        return rspmm_minmax_fwd_plain(csr, edge_weight, relation, x, mul, is_min)
    kernel = _kernel("rspmm_minmax_fwd")
    _check_device_tensors(
        "rspmm_minmax_fwd", x.device, rows={"relation": relation, "x": x},
        ptrs={"rowptr": csr.rowptr},
        ints={"col": csr.col, "etype": csr.etype, "eid": csr.eid},
        floats={"edge_weight": edge_weight},
    )
    num_rows, num_feat = csr.rowptr.numel() - 1, x.shape[1]
    out = torch.empty(num_rows, num_feat, dtype=torch.float32, device=x.device)
    if num_rows == 0 or num_feat == 0:
        return out
    with torch.cuda.device(x.device):
        status = kernel(
            csr.rowptr.data_ptr(), csr.col.data_ptr(), csr.etype.data_ptr(),
            csr.eid.data_ptr(), edge_weight.data_ptr(), relation.data_ptr(),
            x.data_ptr(), out.data_ptr(), num_rows, num_feat, _MUL_CODE[mul],
            int(bool(is_min)), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"rspmm_minmax_fwd launch failed with CUDA error {status}")
    rspmm_minmax_fwd.launches[tuple(out.shape)] += 1
    return out


rspmm_minmax_fwd.launches = collections.Counter()  # launches by output shape


def _check_backward(op, edge_weight, relation, x, g, out, mul):
    _check_dtypes(edge_weight, relation, x, mul, op=op)
    _check_f32(op, g=g, out=out)
    if g.shape != out.shape or g.dim() != 2 or g.shape[1] != x.shape[1]:
        raise ValueError(f"{op}: want g and out (V, F) with F={x.shape[1]}, got "
                         f"{tuple(g.shape)} and {tuple(out.shape)}")


def rspmm_minmax_dx_terms(csr_src: CSR, edge_weight, relation, x, g, out, mul: str = "mul"):
    """The input gradient's terms, one row per live edge: ``(src, terms)``
    with ``terms[e] = w_e * (rel[type_e] if mul else 1) * g[dst_e]`` where
    the edge is routed (``(rel op x[src]) * w == out[dst]``, compared in the
    type of ``relation``, ``x`` and ``out``) and 0 elsewhere, in ``g``'s
    type; d_x is their sum by ``src``. An f64 ``g`` gives a reference that
    routes as the f32 forward did."""
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
    input ``x`` (N, F), its saved output ``out`` (V, F; +-inf rows kept)
    and the output gradient ``g`` (V, F), walking the source-major CSR
    ``csr_src``. On a CPU tensor this runs :func:`rspmm_minmax_dx_plain`; on
    a CUDA tensor it launches B4, building it first if needed, and raises if
    it cannot."""
    _check_backward("rspmm_minmax_dx", edge_weight, relation, x, g, out, mul)
    if g.device.type == "cpu":
        return rspmm_minmax_dx_plain(csr_src, edge_weight, relation, x, g, out, mul)
    kernel = _kernel("rspmm_minmax_dx")
    num_rows, num_feat = csr_src.rowptr.numel() - 1, x.shape[1]
    d_x = torch.empty(num_rows, num_feat, dtype=torch.float32, device=g.device)
    _check_device_tensors(
        "rspmm_minmax_dx", g.device,
        rows={"relation": relation, "x": x, "g": g, "out": out, "d_x": d_x},
        ptrs={"rowptr": csr_src.rowptr},
        ints={"col": csr_src.col, "etype": csr_src.etype, "eid": csr_src.eid},
        floats={"edge_weight": edge_weight},
    )
    if num_rows == 0 or num_feat == 0:
        return d_x
    with torch.cuda.device(g.device):
        status = kernel(
            csr_src.rowptr.data_ptr(), csr_src.col.data_ptr(), csr_src.etype.data_ptr(),
            csr_src.eid.data_ptr(), edge_weight.data_ptr(), relation.data_ptr(),
            x.data_ptr(), g.data_ptr(), out.data_ptr(), d_x.data_ptr(), num_rows,
            num_feat, _MUL_CODE[mul], torch.cuda.current_stream(g.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"rspmm_minmax_dx launch failed with CUDA error {status}")
    rspmm_minmax_dx.launches[tuple(d_x.shape)] += 1
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
    its saved output ``out`` and the output gradient ``g``. ``x`` is read for
    ``"add"`` too: the route needs the message. On a CPU tensor this runs
    :func:`rspmm_minmax_drel_plain`; on a CUDA tensor it launches B5 (both of
    its passes, one count), building it first if needed, and raises if it
    cannot."""
    _check_backward("rspmm_minmax_drel", edge_weight, relation, x, g, out, mul)
    if relation.shape[0] != seg.num_types:
        raise ValueError(f"rspmm_minmax_drel: relation has {relation.shape[0]} rows, the "
                         f"segments {seg.num_types} types")
    if g.device.type == "cpu":
        return rspmm_minmax_drel_plain(seg, edge_weight, relation, x, g, out, mul)
    kernel = _kernel("rspmm_minmax_drel")
    num_chunks, num_types, num_feat = seg.chunkptr.numel() - 1, seg.num_types, g.shape[1]
    d_rel = torch.empty(num_types, num_feat, dtype=torch.float32, device=g.device)
    partial = torch.empty(num_chunks, num_feat, dtype=torch.float32, device=g.device)
    _check_device_tensors(
        "rspmm_minmax_drel", g.device,
        rows={"relation": relation, "x": x, "g": g, "out": out, "partial": partial,
              "d_rel": d_rel},
        ptrs={"chunkptr": seg.chunkptr, "type_chunkptr": seg.type_chunkptr},
        ints={"etype": seg.etype, "src": seg.src, "dst": seg.dst, "eid": seg.eid},
        floats={"edge_weight": edge_weight},
    )
    if num_types == 0 or num_feat == 0:
        return d_rel
    with torch.cuda.device(g.device):
        status = kernel(
            seg.chunkptr.data_ptr(), seg.type_chunkptr.data_ptr(), seg.etype.data_ptr(),
            seg.src.data_ptr(), seg.dst.data_ptr(), seg.eid.data_ptr(),
            edge_weight.data_ptr(), relation.data_ptr(), x.data_ptr(), g.data_ptr(),
            out.data_ptr(), partial.data_ptr(), d_rel.data_ptr(), num_chunks, num_types,
            num_feat, _MUL_CODE[mul], torch.cuda.current_stream(g.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"rspmm_minmax_drel launch failed with CUDA error {status}")
    rspmm_minmax_drel.launches[tuple(d_rel.shape)] += 1
    return d_rel


rspmm_minmax_drel.launches = collections.Counter()

"""The sum-aggregation rspmm kernels for Hopper, their ctypes bindings and
launch counters, and their plain PyTorch versions.

- B1, ``csrc/rspmm_sum_fwd.cu``: the forward over a destination-major CSR.
  It replaces the TPU kernels ``ultra_tpu/ops/rspmm_pallas.py::_fwd_kernel``,
  ``rspmm_pallas_v2.py::_fused_kernel`` and ``rspmm_pallas_w3.py::_w3_kernel``
  (all compute the same function). Two wrappers launch it:
  :func:`rspmm_sum_fwd` (the forward) and :func:`rspmm_sum_dx` (the input
  gradient: the same function on the source-major CSR, as
  ``rspmm_pallas.py:1341-1374`` does), each with its own count.
- B2, ``csrc/rspmm_sum_drel.cu``: the relation gradient over the type
  segments (:func:`rspmm_sum_drel`). It replaces
  ``rspmm_pallas.py::_rel_grad_kernel``, ``rspmm_pallas_v2.py::_drel_kernel``
  and ``rspmm_pallas_v2.py::_drel_add_kernel``.

Both kernels are bound by memory traffic on the card; each source says what
its design does about that. A wrapper takes the plain version for a tensor
on the CPU and launches the kernel for one on a CUDA device; it never falls
back from one to the other.

Each wrapper's ``launches`` is a :class:`collections.Counter` of its kernel
launches by output shape ``(rows, F)`` since the last ``clear()``, so a
caller can tell the entity graph's launches from the relation graph's.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ultra_tpu_torch.graph import CSR, TypeSegments
from ultra_tpu_torch.ops import build

_MUL_CODE = {"mul": 0, "add": 1}
_KERNELS = {}  # name -> the bound C entry point, set at first launch
# the C signatures of every kernel in csrc/ (the min/max ones are launched
# from ops/rspmm_minmax_cuda.py)
_ARGTYPES = {
    "rspmm_sum_fwd": [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ],
    "rspmm_sum_drel": [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "rspmm_minmax_fwd": [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "rspmm_minmax_dx": [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ],
    "rspmm_minmax_drel": [ctypes.c_void_p] * 13 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ],
}


def _kernel(name: str):
    fn = _KERNELS.get(name)
    if fn is None:
        fn = getattr(build.load(name), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn
    return fn


def _check_mul(mul):
    if mul not in _MUL_CODE:
        raise ValueError(f"mul must be one of {tuple(_MUL_CODE)}, got {mul!r}")


def _check_f32(op: str, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(
                f"{op} takes float32 {name}, got {t.dtype} (bf16 operands are "
                "ROADMAP B1 work)"
            )


def _check_dtypes(edge_weight, relation, x, mul, op="rspmm_sum_fwd"):
    _check_mul(mul)
    _check_f32(op, x=x, relation=relation, edge_weight=edge_weight)
    if x.dim() != 2 or relation.dim() != 2 or relation.shape[1] != x.shape[1]:
        raise ValueError(
            f"want x (N, F) and relation (R, F), got {tuple(x.shape)} and "
            f"{tuple(relation.shape)}"
        )


def _check_device_tensors(op: str, device, rows, ptrs, ints, floats):
    """What both kernels need of their operands: float4 rows (F % 4 == 0,
    16-byte aligned starts), everything contiguous on ``device`` (a CUDA
    device), ``ptrs`` 1-D int64 and ``ints`` 1-D int32 of one length. The
    kernels load float4 only: they refuse other widths and alignments
    rather than running them on a slower path."""
    feat = next(iter(rows.values())).shape[1]
    if feat % 4:
        raise ValueError(f"{op}: the kernel needs F % 4 == 0, got F={feat}")
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


def _launch_fwd(op: str, csr: CSR, edge_weight, relation, x, mul):
    """B1 on the card; (rows of ``csr``, F) f32 out."""
    kernel = _kernel("rspmm_sum_fwd")
    _check_device_tensors(
        op, x.device, rows={"relation": relation, "x": x}, ptrs={"rowptr": csr.rowptr},
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
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"{op} launch failed with CUDA error {status}")
    return out


def rspmm_sum_fwd_plain(csr: CSR, edge_weight, relation, x, mul: str = "mul"):
    """``out[v] = sum_{e in row v} w[eid_e] * op(rel[etype_e], x[col_e])``
    with index_select, the elementwise op and index_add_, in the operands'
    type (f32 on the path; f64 gives a reference for the kernel's rounding)."""
    num_rows = csr.rowptr.numel() - 1
    dst = torch.repeat_interleave(
        torch.arange(num_rows, device=x.device), csr.rowptr.diff(),
        output_size=csr.col.numel(),
    )
    rel_e = relation.index_select(0, csr.etype)
    x_e = x.index_select(0, csr.col)
    msg = rel_e * x_e if mul == "mul" else rel_e + x_e
    msg = msg * edge_weight.index_select(0, csr.eid).unsqueeze(1)
    out = torch.zeros(num_rows, x.shape[1], dtype=msg.dtype, device=x.device)
    return out.index_add_(0, dst, msg)


def rspmm_sum_fwd(csr: CSR, edge_weight, relation, x, mul: str = "mul"):
    """Sum rspmm forward over a destination-major CSR; (V, F) f32 out.

    ``relation`` (R, F) and ``x`` (N, F) are f32 and contiguous (and on the
    card, F % 4 == 0 and both 16-byte aligned); ``mul`` is
    ``"mul"`` (distmult) or ``"add"`` (transe). On a CPU tensor this runs
    :func:`rspmm_sum_fwd_plain`; on a CUDA tensor it launches B1, building
    it first if needed, and raises if it cannot.
    """
    _check_dtypes(edge_weight, relation, x, mul)
    if x.device.type == "cpu":
        return rspmm_sum_fwd_plain(csr, edge_weight, relation, x, mul)
    out = _launch_fwd("rspmm_sum_fwd", csr, edge_weight, relation, x, mul)
    rspmm_sum_fwd.launches[tuple(out.shape)] += 1
    return out


rspmm_sum_fwd.launches = collections.Counter()  # launches by output shape


def _rel_or_ones(relation, mul):
    # d message / d x is rel (mul) or 1 (add): the transposed forward with
    # that relation and mul="mul" gives d_x (rspmm_pallas.py:1345-1347)
    return relation if mul == "mul" else torch.ones_like(relation)


def rspmm_sum_dx_plain(csr_src: CSR, edge_weight, relation, g, mul: str = "mul"):
    """``d_x[u] = sum_{e: src_e = u} w_e * (rel[type_e] if mul else 1) * g[dst_e]``:
    :func:`rspmm_sum_fwd_plain` on the source-major CSR."""
    return rspmm_sum_fwd_plain(csr_src, edge_weight, _rel_or_ones(relation, mul), g, "mul")


def rspmm_sum_dx(csr_src: CSR, edge_weight, relation, g, mul: str = "mul"):
    """Input gradient of the sum rspmm: (N, F) f32 from the output gradient
    ``g`` (V, F), walking the source-major CSR ``csr_src``. Launches B1 on a
    CUDA tensor (counted here, not in :func:`rspmm_sum_fwd`), runs
    :func:`rspmm_sum_dx_plain` on a CPU one."""
    _check_dtypes(edge_weight, relation, g, mul, op="rspmm_sum_dx")
    if g.device.type == "cpu":
        return rspmm_sum_dx_plain(csr_src, edge_weight, relation, g, mul)
    out = _launch_fwd("rspmm_sum_dx", csr_src, edge_weight, _rel_or_ones(relation, mul),
                      g, "mul")
    rspmm_sum_dx.launches[tuple(out.shape)] += 1
    return out


rspmm_sum_dx.launches = collections.Counter()


def rspmm_sum_drel_plain(seg: TypeSegments, edge_weight, x, g, mul: str = "mul"):
    """``d_rel[t] = sum_{e: type_e = t} w_e * (x[src_e] if mul else 1) * g[dst_e]``
    with index_select on the type-sorted edges, the product and index_add_
    by type, in the operands' type."""
    msg = g.index_select(0, seg.dst)
    if mul == "mul":
        msg = x.index_select(0, seg.src) * msg
    msg = msg * edge_weight.index_select(0, seg.eid).unsqueeze(1)
    out = torch.zeros(seg.num_types, g.shape[1], dtype=msg.dtype, device=g.device)
    return out.index_add_(0, seg.etype, msg)


def rspmm_sum_drel(seg: TypeSegments, edge_weight, x, g, mul: str = "mul"):
    """Relation gradient of the sum rspmm: (R, F) f32, R = ``seg.num_types``,
    from the forward's input ``x`` (N, F; not read for ``"add"``) and the
    output gradient ``g`` (V, F). On a CPU tensor this runs
    :func:`rspmm_sum_drel_plain`; on a CUDA tensor it launches B2 (both of
    its passes, one count), building it first if needed, and raises if it
    cannot."""
    _check_mul(mul)
    _check_f32("rspmm_sum_drel", x=x, g=g, edge_weight=edge_weight)
    if x.dim() != 2 or g.dim() != 2 or x.shape[1] != g.shape[1]:
        raise ValueError(f"want x (N, F) and g (V, F), got {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    if g.device.type == "cpu":
        return rspmm_sum_drel_plain(seg, edge_weight, x, g, mul)
    kernel = _kernel("rspmm_sum_drel")
    num_chunks, num_types, num_feat = seg.chunkptr.numel() - 1, seg.num_types, g.shape[1]
    out = torch.empty(num_types, num_feat, dtype=torch.float32, device=g.device)
    partial = torch.empty(num_chunks, num_feat, dtype=torch.float32, device=g.device)
    _check_device_tensors(
        "rspmm_sum_drel", g.device,
        rows={"x": x, "g": g, "partial": partial, "out": out},
        ptrs={"chunkptr": seg.chunkptr, "type_chunkptr": seg.type_chunkptr},
        ints={"src": seg.src, "dst": seg.dst, "eid": seg.eid},
        floats={"edge_weight": edge_weight},
    )
    if num_types == 0 or num_feat == 0:
        return out
    with torch.cuda.device(g.device):
        status = kernel(
            seg.chunkptr.data_ptr(), seg.type_chunkptr.data_ptr(), seg.src.data_ptr(),
            seg.dst.data_ptr(), seg.eid.data_ptr(), edge_weight.data_ptr(),
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
            num_chunks, num_types, num_feat, _MUL_CODE[mul],
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"rspmm_sum_drel launch failed with CUDA error {status}")
    rspmm_sum_drel.launches[tuple(out.shape)] += 1
    return out


rspmm_sum_drel.launches = collections.Counter()

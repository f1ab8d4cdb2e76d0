"""The sum-aggregation rspmm forward: the Hopper kernel
(``csrc/rspmm_sum_fwd.cu``), its ctypes binding and launch counter, and its
plain PyTorch version.

It replaces the TPU kernels ``ultra_tpu/ops/rspmm_pallas.py::_fwd_kernel``,
``rspmm_pallas_v2.py::_fused_kernel`` and ``rspmm_pallas_w3.py::_w3_kernel``
(all compute the same function). The kernel is bound by memory traffic on
the card; the source says what its design does about that.

:func:`rspmm_sum_fwd` takes the plain version for a tensor on the CPU and
launches the kernel for one on a CUDA device; it never falls back from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ultra_tpu_torch.graph import CSR
from ultra_tpu_torch.ops import build

_MUL_CODE = {"mul": 0, "add": 1}
_KERNEL = None  # the bound C entry point, set at first launch


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        fn = build.load("rspmm_sum_fwd").rspmm_sum_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _KERNEL = fn
    return _KERNEL


def _check_dtypes(edge_weight, relation, x, mul):
    if mul not in _MUL_CODE:
        raise ValueError(f"mul must be one of {tuple(_MUL_CODE)}, got {mul!r}")
    for name, t in (("x", x), ("relation", relation), ("edge_weight", edge_weight)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"rspmm_sum_fwd takes float32 {name}, got {t.dtype} (bf16 "
                "operands are ROADMAP B1 work)"
            )
    if x.dim() != 2 or relation.dim() != 2 or relation.shape[1] != x.shape[1]:
        raise ValueError(
            f"want x (N, F) and relation (R, F), got {tuple(x.shape)} and "
            f"{tuple(relation.shape)}"
        )


def _check_launch(csr: CSR, edge_weight, relation, x):
    # the kernel loads float4 only: it refuses other widths and alignments
    # rather than running them on a slower path
    if x.shape[1] % 4:
        raise ValueError(f"rspmm_sum_fwd: the kernel needs F % 4 == 0, got F={x.shape[1]}")
    for name, t in (("relation", relation), ("x", x)):
        if t.data_ptr() % 16:
            raise ValueError(f"rspmm_sum_fwd: {name} must start 16-byte aligned")
    tensors = {
        "rowptr": csr.rowptr, "col": csr.col, "etype": csr.etype, "eid": csr.eid,
        "edge_weight": edge_weight, "relation": relation, "x": x,
    }
    for name, t in tensors.items():
        if t.device != x.device or not t.is_cuda:
            raise ValueError(
                f"rspmm_sum_fwd: {name} is on {t.device}, want x's CUDA device "
                f"({x.device})"
            )
        if not t.is_contiguous():
            raise ValueError(f"rspmm_sum_fwd: {name} must be contiguous")
    if csr.rowptr.dtype != torch.int64 or csr.rowptr.dim() != 1:
        raise TypeError("rspmm_sum_fwd: rowptr must be 1-D int64")
    n = csr.col.numel()
    for name in ("col", "etype", "eid"):
        t = tensors[name]
        if t.dtype != torch.int32 or t.dim() != 1 or t.numel() != n:
            raise TypeError(f"rspmm_sum_fwd: {name} must be 1-D int32 of length {n}")


def rspmm_sum_fwd_plain(csr: CSR, edge_weight, relation, x, mul: str = "mul"):
    """``out[v] = sum_{e in row v} w[eid_e] * op(rel[etype_e], x[col_e])``
    with index_select, the elementwise op and index_add_ in f32."""
    num_rows = csr.rowptr.numel() - 1
    dst = torch.repeat_interleave(
        torch.arange(num_rows, device=x.device), csr.rowptr.diff(),
        output_size=csr.col.numel(),
    )
    rel_e = relation.index_select(0, csr.etype)
    x_e = x.index_select(0, csr.col)
    msg = rel_e * x_e if mul == "mul" else rel_e + x_e
    msg = msg * edge_weight.index_select(0, csr.eid).unsqueeze(1)
    out = torch.zeros(num_rows, x.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, dst, msg)


def rspmm_sum_fwd(csr: CSR, edge_weight, relation, x, mul: str = "mul"):
    """Sum rspmm forward over a destination-major CSR; (V, F) f32 out.

    ``relation`` (R, F) and ``x`` (N, F) are f32 and contiguous (and on the
    card, F % 4 == 0 and both 16-byte aligned); ``mul`` is
    ``"mul"`` (distmult) or ``"add"`` (transe). On a CPU tensor this runs
    :func:`rspmm_sum_fwd_plain`; on a CUDA tensor it launches the kernel,
    building it first if needed, and raises if it cannot.
    """
    _check_dtypes(edge_weight, relation, x, mul)
    if x.device.type == "cpu":
        return rspmm_sum_fwd_plain(csr, edge_weight, relation, x, mul)
    kernel = _kernel()
    _check_launch(csr, edge_weight, relation, x)
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
        raise RuntimeError(f"rspmm_sum_fwd launch failed with CUDA error {status}")
    rspmm_sum_fwd.launches += 1
    return out


rspmm_sum_fwd.launches = 0  # kernel launches since the last reset

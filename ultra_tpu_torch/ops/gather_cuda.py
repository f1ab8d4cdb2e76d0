"""The gather kernels for Hopper, their C signatures and launch counters
(``ops/build.py``), and their plain PyTorch versions.

- G1, :func:`gather_rows` (``csrc/gather.cu``): ``out[i] = x[idx[i]]``,
  the row gather that the TPU probes under ``scripts/`` built in Pallas
  (``aot_compile_probe.py``, ``exp_dma_gather.py``, ``exp_dma_gather3.py``,
  ``exp_vmem_gather.py``, ``exp_vmem_gather2.py``, and the gather stage of
  ``exp_v2proto.py`` / ``exp_v2_stages.py``). Any element type whose row is
  a multiple of 16 bytes (bf16 and f32 at F=512).
- G2, :func:`gather_lanes`: ``out[i, j] = x[i, idx[i, j]]``, the lane gather
  of ``aot_compile_probe.py::make_lane_gather`` and
  ``exp_dma_gather.py::probe_lane``. 2- and 4-byte elements.

Indices are int32, as the probes' are. As in ``rspmm_cuda``, a wrapper takes
the plain version for a tensor on the CPU and launches the kernel for one on
a CUDA device, never falling back from one to the other; ``launches`` counts
each wrapper's kernel launches by output shape and element type since the
last ``clear()``.
``scripts/torch_gather_probe.py`` times them on the card, and beside G2
:func:`gather_lanes_floor`, an empty kernel on G2's grid, and
:func:`gather_lanes_indices`, G2's walk storing its indices; nothing on a
model path calls them. G2's grid is computed here (:func:`lane_launch`).
"""

from __future__ import annotations

import ctypes

import torch

from ultra_tpu_torch.ops import build

_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C parameters of csrc/gather.cu's entry points before the stream
build.declare("gather_rows", [_P] * 3 + [_LL, _LL], source="gather")
build.declare("gather_lanes", [_P] * 3 + [_LL, _LL, _LL, _INT, _INT, _LL, _INT, _INT],
              source="gather")
build.declare("gather_lanes_indices", [_P] * 2 + [_LL, _LL, _INT, _INT, _LL, _INT, _INT],
              source="gather")
build.declare("gather_empty", [_LL, _INT, _INT], source="gather")


def _check_index(op: str, x, idx, dims: int):
    if idx.dtype != torch.int32 or idx.dim() != dims or x.dim() != 2:
        raise TypeError(f"{op}: want x 2-D and idx {dims}-D int32, got x {tuple(x.shape)} "
                        f"and idx {idx.dtype} {tuple(idx.shape)}")


def launch_key(out):
    """A launch counter's key: the output's rows, columns and element type,
    as in ``(616448, 512, "bfloat16")``."""
    return (*out.shape, str(out.dtype).removeprefix("torch."))


def gather_rows_plain(x, idx):
    """``x.index_select(0, idx)``."""
    return x.index_select(0, idx)


@build.counted
def gather_rows(x, idx):
    """(N, F) rows ``x[idx]`` of ``x`` (V, F), ``idx`` (N,) int32 in [0, V).
    On a CPU tensor this runs :func:`gather_rows_plain`; on a CUDA tensor it
    launches G1, building it first if needed, and raises if it cannot: the
    kernel copies 16-byte vectors, so a row must be a multiple of 16 bytes
    and ``x`` 16-byte aligned."""
    _check_index("gather_rows", x, idx, 1)
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    kernel = build.bind("gather_rows")
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"gather_rows: the kernel copies 16-byte vectors; a row of "
                         f"{row_bytes} bytes or an unaligned x is refused")
    build.check_device("gather_rows", x.device, {"x": x, "idx": idx})
    out = torch.empty(idx.shape[0], x.shape[1], dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build.launch(kernel, "gather_rows", x.device, x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 idx.shape[0], row_bytes)
    gather_rows.launches[launch_key(out)] += 1
    return out


# G2: the threads of a block, and the lanes of a row each thread takes (of
# 2, 4 and 8, the fastest at the probe's shape on an H100: PERF.md)
LANE_BLOCK_THREADS = 256
LANES_PER_THREAD = 4


def lane_launch(rows: int, k: int, lanes: int = LANES_PER_THREAD):
    """G2's grid for (rows, k) outputs at ``lanes`` lanes a thread: (blocks,
    threads a row, rows a block). A row's threads cover its k lanes in runs
    of ``lanes`` (at most LANE_BLOCK_THREADS threads, which then loop), a
    block holds as many whole rows as LANE_BLOCK_THREADS threads allow, and
    the blocks are as few as cover the rows: (64, 32, 8) for (512, 128) at
    4 lanes."""
    if rows < 1 or k < 1 or lanes not in (2, 4, 8):
        raise ValueError(f"lane_launch: want rows, k >= 1 and lanes 2, 4 or 8, got "
                         f"{rows}, {k}, {lanes}")
    per_row = min(-(-k // lanes), LANE_BLOCK_THREADS)
    block_rows = min(LANE_BLOCK_THREADS // per_row, rows)
    return -(-rows // block_rows), per_row, block_rows


def gather_lanes_plain(x, idx):
    """``torch.gather(x, 1, idx)``."""
    return torch.gather(x, 1, idx.long())


@build.counted
def gather_lanes(x, idx, lanes: int = LANES_PER_THREAD):
    """(M, K) ``out[i, j] = x[i, idx[i, j]]`` of ``x`` (M, W) with 2- or
    4-byte elements, ``idx`` (M, K) int32 in [0, W). On a CPU tensor this
    runs :func:`gather_lanes_plain`; on a CUDA tensor it launches G2 with
    ``lanes`` lanes a thread on :func:`lane_launch`'s grid, building it
    first if needed, and raises if it cannot."""
    _check_index("gather_lanes", x, idx, 2)
    if idx.shape[0] != x.shape[0]:
        raise ValueError(f"gather_lanes: idx has {idx.shape[0]} rows, x {x.shape[0]}")
    if x.device.type == "cpu":
        return gather_lanes_plain(x, idx)
    kernel = build.bind("gather_lanes")
    if x.element_size() not in (2, 4):
        raise TypeError(f"gather_lanes: the kernel copies 2- or 4-byte elements, got {x.dtype}")
    build.check_device("gather_lanes", x.device, {"x": x, "idx": idx})
    out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build.launch(kernel, "gather_lanes", x.device, x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 x.shape[0], x.shape[1], idx.shape[1], x.element_size(), lanes,
                 *lane_launch(*idx.shape, lanes))
    gather_lanes.launches[launch_key(out)] += 1
    return out


def gather_lanes_indices(idx, dtype, lanes: int = LANES_PER_THREAD):
    """G2's walk over ``idx`` (M, K) int32 on a CUDA device, storing each
    index's bits (the low 16 for a 2-byte ``dtype``) as an (M, K) ``dtype``
    tensor instead of the element it points at: G2 without its second,
    dependent load, whose time says what that load costs. Counts no
    launch: it is a probe, not G2."""
    build.check_device("gather_lanes_indices", idx.device, {"idx": idx})
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise TypeError(f"gather_lanes_indices: want idx 2-D int32, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    out = torch.empty(idx.shape, dtype=dtype, device=idx.device)
    build.launch(build.bind("gather_lanes_indices"), "gather_lanes_indices", idx.device,
                 idx.data_ptr(), out.data_ptr(), idx.shape[0], idx.shape[1], out.element_size(),
                 lanes, *lane_launch(*idx.shape, lanes))
    return out


def launch_empty(device, grid: int, block_x: int, block_y: int = 1):
    """Launch a kernel that does nothing on ``grid`` blocks of ``block_x`` x
    ``block_y`` threads on ``device``'s current stream (through ``ctypes``,
    as the gathers launch); returns nothing. Its device time is the floor
    under any launch on that grid."""
    build.launch(build.bind("gather_empty"), "gather_empty", device, grid, block_x, block_y)


def gather_lanes_floor(x, idx, lanes: int = LANES_PER_THREAD):
    """Launch, as :func:`gather_lanes` launches G2 for ``x`` and ``idx`` on a
    CUDA device (on :func:`lane_launch`'s grid), a kernel that does nothing;
    returns nothing. Its device time is the floor under G2's. Counts no
    launch: it computes nothing."""
    _check_index("gather_lanes_floor", x, idx, 2)
    build.check_device("gather_lanes_floor", x.device, {"x": x, "idx": idx})
    launch_empty(x.device, *lane_launch(*idx.shape, lanes))

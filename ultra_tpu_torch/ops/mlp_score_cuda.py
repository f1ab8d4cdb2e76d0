"""The scorer for Hopper, its C signature and launch counter
(``ops/build.py``), and its plain PyTorch twin.

S1, ``csrc/mlp_score.cu`` (:func:`mlp_score`): the entity model's scoring
MLP, ``Linear(128, 128)``, ReLU, ``Linear(128, 1)``, over every node's
``[hidden | query]`` at inference, in one pass over the last hidden state
where PyTorch ran four kernels (``torch.cat``, the first linear's GEMM, the
ReLU and the last linear's gemv). The query half of the first linear is
computed once a query, not once a node, and the (V, B, 128) hidden layer
never leaves the registers. It replaces no TPU kernel: the JAX package
leaves those ops to XLA (``ultra_tpu/models/nbfnet.py``). It is bound by
operations; the source says what its design does about that. It computes
no gradient: ``models/nbfnet.py`` takes it only where none is wanted.

As in ``rspmm_cuda``, the wrapper takes the plain version for a tensor on
the CPU and launches the kernel for one on a CUDA device, never falling
back from one to the other; ``launches`` counts the kernel's launches by
``(rows, B)`` since the last ``clear()``. While a profiler records, each
launch adds its rows to the profiling counter ``score_rows``. The module's
names do not start with ``rspmm_``, so the benchmark's readers of the rspmm
counters do not count it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ultra_tpu_torch.ops import build
from ultra_tpu_torch.utils import profiling

# the C parameters before the stream: h, q, w1, b1, w2, b2, out, rows, batch
build.declare("mlp_score", [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int])
# the grid of a launch at a batch (a query of the kernel's occupancy)
build.declare("mlp_score_blocks", [ctypes.c_int], source="mlp_score")

WIDTH = 64  # the hidden state's width, and the query's
HIDDEN = 2 * WIDTH  # the first linear's outputs, over [hidden | query]
# the most queries whose query half a block holds in shared memory
# (csrc/mlp_score.cu kMaxBatch): the cells' 16 and 32, serving's 8
MAX_BATCH = 64


def mlp_score_plain(h, q, w1, b1, w2, b2):
    """The scoring MLP's composed ops over ``[h | q]`` with ``q`` repeated
    over the nodes: ``mlp(torch.cat([h, q.expand(...)], -1)).squeeze(-1)``
    of an ``nn.Sequential(Linear(w1, b1), ReLU(), Linear(w2, b2))``."""
    feature = torch.cat([h, q.expand(h.shape[0], *q.shape)], dim=-1)
    return F.linear(F.relu(F.linear(feature, w1, b1)), w2, b2).squeeze(-1)


def _check(h, q, w1, b1, w2, b2):
    """Raise where S1 does not take these operands: anything but f32, on
    one device and contiguous, of the widths of :func:`mlp_score`, with a
    batch from 1 to :data:`MAX_BATCH`, and h, q and w1 16-byte aligned (the
    kernel moves 16-byte vectors of them). It holds on every device, so the
    CPU refuses what the card refuses."""
    tensors = {"h": h, "q": q, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    for name, t in tensors.items():
        if t is None:
            raise ValueError(f"mlp_score: {name} is None, want a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"mlp_score: {name} is {t.dtype}, want torch.float32")
    build.check_device("mlp_score", h.device, tensors, cuda=False)
    if h.dim() != 3 or h.shape[-1] != WIDTH or q.shape != (h.shape[1], WIDTH):
        raise ValueError(f"mlp_score: h {tuple(h.shape)} and q {tuple(q.shape)}, want "
                         f"(V, B, {WIDTH}) and (B, {WIDTH})")
    if not 1 <= h.shape[1] <= MAX_BATCH:
        raise ValueError(f"mlp_score: a batch of {h.shape[1]} queries, want 1 to {MAX_BATCH}")
    if (w1.shape != (HIDDEN, HIDDEN) or b1.shape != (HIDDEN,) or w2.shape != (1, HIDDEN)
            or b2.shape != (1,)):
        raise ValueError(f"mlp_score: w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)}, want ({HIDDEN}, {HIDDEN}), "
                         f"({HIDDEN},), (1, {HIDDEN}), (1,)")
    if any(t.data_ptr() % 16 for t in (h, q, w1)):
        raise ValueError("mlp_score: the kernel moves 16-byte vectors of h, q and w1; one "
                         "that does not start 16-byte aligned is refused")


def takes(h, q, w1, b1, w2, b2) -> bool:
    """Whether :func:`mlp_score` takes these operands (:func:`_check`
    raises nothing): the model's rule for S1 (``models/nbfnet.py``)."""
    try:
        _check(h, q, w1, b1, w2, b2)
    except (TypeError, ValueError):
        return False
    return True


@build.counted
def mlp_score(h, q, w1, b1, w2, b2):
    """(V, B) logits ``w2 . relu([h | q] @ w1.T + b1) + b2`` of each node v
    and query b: h (V, B, 64) the last hidden state, q (B, 64) the queries,
    w1 (128, 128) and b1 (128,) the first linear over ``[hidden | query]``,
    w2 (1, 128) and b2 (1,) the last; B from 1 to :data:`MAX_BATCH`. Every
    tensor f32 and contiguous, and h, q and w1 16-byte aligned, else it
    raises, on every device (:func:`takes`). On a CPU tensor this runs
    :func:`mlp_score_plain`; on a CUDA tensor it launches S1, building it
    first if needed, into a new tensor."""
    _check(h, q, w1, b1, w2, b2)
    if h.device.type == "cpu":
        return mlp_score_plain(h, q, w1, b1, w2, b2)
    out = torch.empty(h.shape[:2], dtype=h.dtype, device=h.device)
    rows, batch = out.numel(), h.shape[1]
    if rows == 0:
        return out
    build.launch(build.bind("mlp_score"), "mlp_score", h.device,
                 *(t.data_ptr() for t in (h, q, w1, b1, w2, b2, out)), rows, batch)
    mlp_score.launches[(rows, batch)] += 1
    profiling.count("score_rows", rows)
    return out


def blocks(batch: int, device) -> int:
    """The grid S1 takes at ``batch`` queries where the rows fill it (the
    card's SMs times the blocks an SM holds) on the CUDA ``device``."""
    with torch.cuda.device(device):
        return build.bind("mlp_score_blocks")(batch, None)

"""The conv's tail for Hopper, its C signature and launch counter
(``ops/build.py``), and its plain PyTorch twin.

E2, ``csrc/conv_tail.cu`` (:func:`conv_tail`): all of a 64 -> 64 conv layer
after its aggregation at inference, ``act(layer_norm([x | u] @ W.T + bias))
+ x``, in one pass where the conv ran three kernels (``torch.cat``, the
``linear``'s GEMM and E1, ``ops/epilogue_cuda.py``). It replaces no TPU
kernel: the JAX package leaves those ops to XLA
(``ultra_tpu/models/layers.py``). It is bound by operations and bytes
together; the source says what its design does about that. It computes no
gradient: the conv takes it only where none is wanted
(``models/layers.py``).

Its bf16-x instance (``round_x``, entry point ``conv_tail_bf16_x``) is the
tail of a conv under ``compute_dtype: bfloat16``: the linear reads ``x``
rounded to bf16 and widened back, as the JAX package's concatenation
promotes the conv's bf16 rspmm operand, while the short cut adds ``x`` as it
is. It takes the same f32 ``x`` and rounds it on chip, in shared memory.

As in ``rspmm_cuda``, the wrapper takes the plain version for a tensor on
the CPU and launches the kernel for one on a CUDA device, never falling
back from one to the other; ``launches`` counts the kernel's launches by
``(rows, 64)``, the bf16-x instance's by ``(rows, 64, "bf16_x")``, since the
last ``clear()``. While a profiler records, each launch adds its rows to the
profiling counter ``conv_tail_rows``, from which the benchmark reads E2's
share of its roofline. The module's names do not start
with ``rspmm_``, so the benchmark's readers of the rspmm counters do not
count it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ultra_tpu_torch.ops import build
from ultra_tpu_torch.ops.epilogue_cuda import conv_epilogue_plain
from ultra_tpu_torch.utils import profiling

ROUND_X = "bf16_x"  # the instance whose linear reads x rounded to bf16
# the C parameters before the stream: x, u, w, bias, gamma, beta, out, rows,
# eps, relu, residual
build.declare("conv_tail", [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int], instances=("", ROUND_X))

WIDTH = 64  # the layer's width in and out, which the kernel is built for


def conv_tail_plain(x, u, weight, bias, gamma, beta, eps: float, relu: bool, residual=None,
                    round_x: bool = False):
    """``F.linear`` of ``[x | u]``, then E1's twin (layer norm, ReLU or
    none, ``+ residual`` or none): the conv's composed ops. ``round_x``:
    the linear reads ``x`` rounded to bf16 and widened back, the short cut
    ``residual`` as it is."""
    lin_x = x.to(torch.bfloat16).float() if round_x else x
    return conv_epilogue_plain(F.linear(torch.cat([lin_x, u], dim=-1), weight, bias), gamma,
                               beta, eps, relu, residual)


def _check(x, u, weight, bias, gamma, beta, residual):
    if residual is not None and residual is not x:
        raise ValueError("conv_tail: the short cut's input must be x itself, or None")
    tensors = {"x": x, "u": u, "weight": weight, "bias": bias, "gamma": gamma, "beta": beta}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"conv_tail: {name} is {t.dtype}, want torch.float32")
    build.check_device("conv_tail", x.device, tensors, cuda=False)
    if x.dim() == 0 or x.shape[-1] != WIDTH or u.shape != x.shape:
        raise ValueError(f"conv_tail: x {tuple(x.shape)} and u {tuple(u.shape)}, want one "
                         f"shape (..., {WIDTH})")
    if weight.shape != (WIDTH, 2 * WIDTH) or any(t.shape != (WIDTH,) for t in (bias, gamma,
                                                                               beta)):
        raise ValueError(f"conv_tail: weight {tuple(weight.shape)}, bias, gamma and beta "
                         f"{[tuple(t.shape) for t in (bias, gamma, beta)]}, want "
                         f"({WIDTH}, {2 * WIDTH}) and ({WIDTH},)")


@build.counted
def conv_tail(x, u, weight, bias, gamma, beta, eps: float, relu: bool, residual=None,
              round_x: bool = False):
    """``act(layer_norm(F.linear([x | u], weight, bias))) + residual``: x
    and u (..., 64) of one shape, ``weight`` (64, 128) and ``bias`` (64,) a
    linear over their concatenation, nn.LayerNorm's normalisation with
    ``gamma``, ``beta`` (64,) and ``eps``, ReLU where ``relu``, and the
    short cut where ``residual`` is given, which must be ``x`` itself;
    ``round_x``: the linear reads ``x`` rounded to bf16 (the bf16-x
    instance). Every tensor f32 and contiguous, else it raises, on every
    device. On a CPU tensor this runs :func:`conv_tail_plain`; on a CUDA
    tensor it launches E2, building it first if needed, into a new tensor
    (every operand 16-byte aligned, else it raises)."""
    _check(x, u, weight, bias, gamma, beta, residual)
    if x.device.type == "cpu":
        return conv_tail_plain(x, u, weight, bias, gamma, beta, eps, relu, residual, round_x)
    operands = (x, u, weight, bias, gamma, beta)
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError("conv_tail: the kernel moves 16-byte vectors; an operand that does "
                         "not start 16-byte aligned is refused")
    out = torch.empty_like(x)
    rows = x.numel() // WIDTH
    if rows == 0:
        return out
    instance = ROUND_X if round_x else ""
    build.launch(build.bind(build.entry_point("conv_tail", instance)), "conv_tail", x.device,
                 *(t.data_ptr() for t in operands), out.data_ptr(), rows, eps, int(relu),
                 int(residual is not None))
    conv_tail.launches[(rows, WIDTH, ROUND_X) if round_x else (rows, WIDTH)] += 1
    profiling.count("conv_tail_rows", rows)
    return out

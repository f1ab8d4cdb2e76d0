"""The conv epilogue for Hopper, its C signature and launch counter
(``ops/build.py``), and its plain PyTorch twin.

E1, ``csrc/conv_epilogue.cu`` (:func:`conv_epilogue`): the end of a conv
layer at inference, ``act(layer_norm(y)) + residual`` over the rows of the
layer's ``linear`` output, in one pass where PyTorch runs three kernels
(``F.layer_norm``, the activation, the short cut's add). It replaces no TPU
kernel: the JAX package leaves those ops to XLA
(``ultra_tpu/models/layers.py:122``). The kernel is bound by bytes; the
source says what its design does about that. It computes no gradient: the
conv takes it only where none is wanted (``models/layers.py``).

As in ``rspmm_cuda``, the wrapper takes the plain version for a tensor on
the CPU and launches the kernel for one on a CUDA device, never falling
back from one to the other; ``launches`` counts the kernel's launches by
``(rows, N)`` since the last ``clear()``. The module's names do not start
with ``rspmm_``, so the benchmark's readers of the rspmm counters do not
count it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ultra_tpu_torch.ops import build

# the C parameters before the stream: y, gamma, beta, residual, out, rows, N, eps, relu
build.declare("conv_epilogue", [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int])

# the row widths N the kernel is built for (csrc/conv_epilogue.cu): the
# models' 64, and 128 (config/transductive/pretrain_synth_128.yaml)
WIDTHS = (64, 128)


def conv_epilogue_plain(y, gamma, beta, eps: float, relu: bool, residual=None):
    """``F.layer_norm`` over the last dimension of ``y``, then ReLU (or
    none), then ``+ residual`` (or none): the conv's composed ops."""
    out = F.layer_norm(y, tuple(gamma.shape), gamma, beta, eps)
    if relu:
        out = F.relu(out)
    return out if residual is None else out + residual


def _check(y, gamma, beta, residual):
    tensors = {"y": y, "gamma": gamma, "beta": beta}
    if residual is not None:
        tensors["residual"] = residual
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"conv_epilogue: {name} is {t.dtype}, want torch.float32")
    build.check_device("conv_epilogue", y.device, tensors, cuda=False)
    n = y.shape[-1] if y.dim() else 0
    if n % 4 or n == 0:
        raise ValueError(f"conv_epilogue: rows of {n} elements; the kernel reads 4 at a "
                         "time, so N must be a positive multiple of 4")
    if gamma.shape != (n,) or beta.shape != (n,):
        raise ValueError(f"conv_epilogue: gamma {tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)}, want ({n},)")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"conv_epilogue: residual {tuple(residual.shape)}, want y's "
                         f"{tuple(y.shape)}")


@build.counted
def conv_epilogue(y, gamma, beta, eps: float, relu: bool, residual=None):
    """``act(layer_norm(y)) + residual`` over the last dimension of ``y``
    (..., N): nn.LayerNorm's normalisation with ``gamma``, ``beta`` (N,) and
    ``eps``, then ReLU where ``relu``, then the short cut's ``residual``
    (y's shape) where given. Every tensor f32 and contiguous, N a multiple
    of 4, else it raises, on every device. On a CPU tensor this runs
    :func:`conv_epilogue_plain`; on a CUDA tensor it launches E1, building it
    first if needed, writes the result over ``y`` and returns ``y`` (N one
    of :data:`WIDTHS` and every operand 16-byte aligned, else it
    raises)."""
    _check(y, gamma, beta, residual)
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, gamma, beta, eps, relu, residual)
    n = y.shape[-1]
    if n not in WIDTHS:
        raise ValueError(f"conv_epilogue: built for N in {WIDTHS}, got {n}")
    if any(t.data_ptr() % 16 for t in (y, gamma, beta, residual) if t is not None):
        raise ValueError("conv_epilogue: the kernel moves 16-byte vectors; an operand that "
                         "does not start 16-byte aligned is refused")
    kernel = build.bind("conv_epilogue")
    rows = y.numel() // n
    if rows == 0:
        return y
    build.launch(kernel, "conv_epilogue", y.device, y.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), None if residual is None else residual.data_ptr(),
                 y.data_ptr(), rows, n, eps, int(relu))
    conv_epilogue.launches[(rows, n)] += 1
    return y

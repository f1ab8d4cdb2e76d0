"""Variadic (ragged-set) ops over a flat value tensor and a per-set size
vector, on torch tensors.

Counterpart of ``ultra_tpu/ops/variadic.py`` (the 15 ops of the reference's
``variadic.py``). Every op takes ``value`` (flat along dim 0, of length
``size.sum()``) and ``size`` (N,) and reduces or transforms each set; the
result lies on the inputs' device. The semantics are the JAX package's:

- an empty set's max is -inf for a float (the dtype's least value for an
  integer) and its min +inf (the greatest), as ``jax.ops.segment_max`` and
  ``segment_min`` give;
- sorts are exact and stable in both directions: ties keep their input
  order when descending too (``jnp.lexsort`` on the negated value);
- ``variadic_topk`` pads a set smaller than k with its last sorted value
  (an empty set reads position 0 of its start).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def size_to_index(size: Tensor) -> Tensor:
    """(N,) sizes -> (total,) set id per element."""
    return torch.repeat_interleave(torch.arange(size.shape[0], device=size.device), size)


def _starts(size: Tensor) -> Tensor:
    return torch.cumsum(size, 0) - size


def _segment(value: Tensor, size: Tensor, reduce: str, fill) -> Tensor:
    """Each set's ``reduce`` ("sum", "amax", "amin") of ``value``, ``fill``
    for an empty set."""
    out = torch.full((size.shape[0],) + value.shape[1:], fill, dtype=value.dtype,
                     device=value.device)
    idx = size_to_index(size).reshape((-1,) + (1,) * (value.ndim - 1)).expand_as(value)
    return out.scatter_reduce_(0, idx, value, reduce, include_self=True)


def _extreme(dtype: torch.dtype, largest: bool):
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def variadic_sum(value: Tensor, size: Tensor) -> Tensor:
    return _segment(value, size, "sum", 0)


def variadic_mean(value: Tensor, size: Tensor) -> Tensor:
    s = variadic_sum(value, size)
    denom = torch.clamp(size, min=1).to(s.dtype)
    return s / denom.reshape((-1,) + (1,) * (s.ndim - 1))


def variadic_max(value: Tensor, size: Tensor) -> Tensor:
    return _segment(value, size, "amax", _extreme(value.dtype, largest=False))


def variadic_min(value: Tensor, size: Tensor) -> Tensor:
    return _segment(value, size, "amin", _extreme(value.dtype, largest=True))


def variadic_arange(size: Tensor) -> Tensor:
    """Concatenated [0..s) ranges."""
    idx = size_to_index(size)
    return torch.arange(idx.shape[0], device=size.device) - _starts(size)[idx]


def variadic_softmax(value: Tensor, size: Tensor) -> Tensor:
    """Per-set softmax (the adversarial negative weighting)."""
    idx = size_to_index(size)
    e = torch.exp(value - variadic_max(value, size)[idx])
    return e / variadic_sum(e, size)[idx]


def variadic_log_softmax(value: Tensor, size: Tensor) -> Tensor:
    idx = size_to_index(size)
    shifted = value - variadic_max(value, size)[idx]
    return shifted - torch.log(variadic_sum(torch.exp(shifted), size))[idx]


def variadic_cross_entropy(pred: Tensor, target_index: Tensor, size: Tensor) -> Tensor:
    """Per-set cross entropy; ``target_index`` is the true class's position
    in its set."""
    return -variadic_log_softmax(pred, size)[_starts(size) + target_index]


def variadic_sort(value: Tensor, size: Tensor, descending: bool = False) -> Tuple[Tensor, Tensor]:
    """Exact per-set sort; returns (sorted values, in-set order indices).
    Two stable sorts, by value (negated when descending) and then by set,
    make the lexicographic order: ties keep their input order."""
    idx = size_to_index(size)
    key = -value if descending else value
    by_key = torch.sort(key, stable=True).indices
    order = by_key[torch.sort(idx[by_key], stable=True).indices]
    return value[order], order - _starts(size)[idx]


def variadic_topk(value: Tensor, size: Tensor, k: int, largest: bool = True):
    """Per-set top-k, padded with each set's last sorted value when it has
    fewer than k; returns (values (N, k), in-set indices (N, k))."""
    sorted_vals, in_set = variadic_sort(value, size, descending=largest)
    ks = torch.arange(k, device=size.device)[None, :]
    pos = _starts(size)[:, None] + torch.minimum(ks, torch.clamp(size[:, None] - 1, min=0))
    # an empty last set starts past the end: clamped, as a jnp gather clamps
    pos = torch.clamp(pos, max=value.shape[0] - 1)
    return sorted_vals[pos], in_set[pos]


def multi_slice_mask(starts: Tensor, ends: Tensor, length: int) -> Tensor:
    """Boolean mask of ``length``, True on each [starts_i, ends_i)."""
    delta = torch.zeros(length + 1, dtype=starts.dtype, device=starts.device)
    delta.index_add_(0, starts, torch.ones_like(starts))
    delta.index_add_(0, ends, -torch.ones_like(ends))
    return torch.cumsum(delta[:-1], 0) > 0


def masked_mean(value: Tensor, mask: Tensor, axis=None) -> Tensor:
    m = mask.to(value.dtype)
    if axis is None:
        return (value * m).sum() / torch.clamp(m.sum(), min=1)
    return (value * m).sum(axis) / torch.clamp(m.sum(axis), min=1)


def mean_with_nan(value: Tensor, axis=None) -> Tensor:
    return masked_mean(torch.nan_to_num(value), ~torch.isnan(value), axis)


def variadic_extend(a: Tensor, a_size: Tensor, b: Tensor, b_size: Tensor):
    """Interleave two ragged tensors set-wise: set i of the output is
    [a_i .. b_i] (merges easy and hard answer ranks)."""
    new_size = a_size + b_size
    new_starts = _starts(new_size)
    out = torch.zeros((a.shape[0] + b.shape[0],) + a.shape[1:], dtype=a.dtype, device=a.device)
    a_set, b_set = size_to_index(a_size), size_to_index(b_size)
    out[new_starts[a_set] + variadic_arange(a_size)] = a
    out[new_starts[b_set] + a_size[b_set] + variadic_arange(b_size)] = b
    return out, new_size

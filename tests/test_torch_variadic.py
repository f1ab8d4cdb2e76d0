"""The port's ragged-set ops (``ultra_tpu_torch/ops/variadic.py``) and
``spmm_max`` (``ultra_tpu_torch/ops/rspmm.py``) against the JAX package's
(``ultra_tpu/ops/variadic.py``, ``ultra_tpu/ops/rspmm.py::spmm_max``) on the
same inputs, made from a numpy seed, on the CPU.

The sets include empty ones (in the middle and last) and, for the sorts,
heavy ties. Tolerances: integer outputs and every index are equal; floats
at rtol 1e-6 / atol 1e-7 (sums and exponentials taken in another order);
a max, a min and a sort move no value and must be equal; ``spmm_max`` takes
the max of the same f32 products and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_tpu.ops import rspmm as jrspmm
from ultra_tpu.ops import variadic as JV
from ultra_tpu_torch.ops import spmm_max
from ultra_tpu_torch.ops import variadic as V

RTOL, ATOL = 1e-6, 1e-7
SIZES = np.array([3, 0, 5, 1, 7, 0, 4, 2, 0])  # empty sets, the last one too


def values(kind, seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    n = int(sizes.sum())
    if kind == "float":
        return rng.normal(size=n).astype(np.float32)
    if kind == "ties":  # few distinct values: every set ties
        return rng.integers(0, 3, size=n).astype(np.float32)
    if kind == "int":
        return rng.integers(-50, 50, size=n).astype(np.int32)
    if kind == "rows":
        return rng.normal(size=(n, 3)).astype(np.float32)
    raise ValueError(kind)


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def both(name, *args, **kw):
    """The op ``name`` of each package on the same numpy arguments."""
    t = getattr(V, name)(*(torch.from_numpy(np.asarray(a)) for a in args), **kw)
    j = getattr(JV, name)(*(jnp.asarray(a) for a in args), **kw)
    return t, j


@pytest.mark.parametrize("kind", ["float", "ties", "int", "rows"])
@pytest.mark.parametrize("op", ["variadic_sum", "variadic_mean", "variadic_max",
                                "variadic_min"])
def test_reductions(op, kind):
    t, j = both(op, values(kind), SIZES)
    same(t, j)
    if op in ("variadic_max", "variadic_min"):
        assert t.dtype == torch.from_numpy(values(kind)).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))  # empty sets' fills too


@pytest.mark.parametrize("op", ["size_to_index", "variadic_arange"])
def test_indices(op):
    t, j = both(op, SIZES)
    same(t, j)


@pytest.mark.parametrize("kind", ["float", "ties"])
@pytest.mark.parametrize("op", ["variadic_softmax", "variadic_log_softmax"])
def test_softmax(op, kind):
    t, j = both(op, values(kind), SIZES)
    same(t, j)


def test_cross_entropy():
    sizes = SIZES[SIZES > 0]
    rng = np.random.default_rng(1)
    target = np.array([rng.integers(s) for s in sizes])
    t, j = both("variadic_cross_entropy", values("float", 1, sizes), target, sizes)
    same(t, j)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["float", "ties", "int"])
def test_sort(kind, descending):
    (tv, ti), (jv, ji) = both("variadic_sort", values(kind), SIZES, descending=descending)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 3, 9])  # 9 is larger than every set
@pytest.mark.parametrize("kind", ["float", "ties"])
def test_topk(kind, k, largest):
    (tv, ti), (jv, ji) = both("variadic_topk", values(kind), SIZES, k=k, largest=largest)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_multi_slice_mask():
    starts, ends = np.array([1, 6, 12, 12]), np.array([3, 9, 15, 13])
    t = V.multi_slice_mask(torch.from_numpy(starts), torch.from_numpy(ends), 15)
    j = JV.multi_slice_mask(jnp.asarray(starts), jnp.asarray(ends), 15)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_masked_mean_and_mean_with_nan(axis):
    rng = np.random.default_rng(2)
    value = rng.normal(size=(6, 5)).astype(np.float32)
    mask = rng.random((6, 5)) < 0.5
    mask[:, 0] = False  # a column with nothing kept divides by max(0, 1)
    t, j = both("masked_mean", value, mask, axis=axis)
    same(t, j)
    with_nan = np.where(mask, value, np.nan).astype(np.float32)
    t, j = both("mean_with_nan", with_nan, axis=axis)
    same(t, j)


@pytest.mark.parametrize("kind", ["float", "int"])
def test_extend(kind):
    b_sizes = np.array([2, 1, 0, 3, 0, 1, 2, 0, 4])
    a, b = values(kind, 3), values(kind, 4, b_sizes)
    (tv, ts), (jv, js) = both("variadic_extend", a, SIZES, b, b_sizes)
    same(tv, jv)
    same(ts, js)


@pytest.mark.parametrize("dims", [2, 1])
def test_spmm_max(dims):
    """Rows without edges read -inf, a 0 value is a message of 0, and a 1-D
    matrix is taken as (n, 1): equal to the JAX function."""
    rng = np.random.default_rng(5)
    m, n, e = 12, 9, 40
    edge_index = np.stack([rng.integers(0, m - 3, e), rng.integers(0, n, e)])  # 3 rows empty
    value = rng.normal(size=e).astype(np.float32)
    value[::5] = 0.0
    matrix = rng.normal(size=(n, 4) if dims == 2 else (n,)).astype(np.float32)
    got = spmm_max(torch.from_numpy(edge_index), torch.from_numpy(value), m, n,
                   torch.from_numpy(matrix))
    want = np.asarray(jrspmm.spmm_max(jnp.asarray(edge_index), jnp.asarray(value), m, n,
                                      jnp.asarray(matrix)))
    assert got.shape == want.shape == (m, 4 if dims == 2 else 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isneginf(want[m - 3:]).all()

"""The gather wrappers of the port (``ultra_tpu_torch/ops/gather_cuda.py``:
G1 row gather, G2 lane gather) against numpy. On the CPU they run their
plain versions and count no launch; a tensor off the CPU never takes the
plain version. Exact: a gather copies values.
"""

import numpy as np
import pytest
import torch

from ultra_tpu_torch.ops import build, gather_cuda, rspmm_cuda
from ultra_tpu_torch.ops.gather_cuda import gather_lanes, gather_rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_matches_numpy(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 24)).astype(np.float32)
    idx = rng.integers(0, 37, 200).astype(np.int32)  # repeats, any order
    x_t = torch.from_numpy(x).to(dtype)
    out = gather_rows(x_t, torch.from_numpy(idx))
    assert out.dtype == dtype and out.shape == (200, 24)
    np.testing.assert_array_equal(out.float().numpy(), x_t.float().numpy()[idx])
    assert not gather_rows.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_lanes_matches_numpy(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (16, 128)).astype(np.int32)
    x_t = torch.from_numpy(x).to(dtype)
    out = gather_lanes(x_t, torch.from_numpy(idx))
    assert out.dtype == dtype and out.shape == (16, 128)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.take_along_axis(x_t.float().numpy(), idx, axis=1))
    assert not gather_lanes.launches


def test_gathers_refuse_other_index_types():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="int32"):
        gather_rows(x, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="int32"):
        gather_lanes(x, torch.zeros(4, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="rows"):
        gather_lanes(x, torch.zeros(3, 2, dtype=torch.int32))


def test_device_tensor_without_kernel_library_raises(monkeypatch, tmp_path):
    """With no built library and no nvcc to build one, a tensor off the CPU
    raises instead of taking the plain version."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "_BUILD", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(rspmm_cuda, "_KERNELS", {})
    x = torch.empty(10, 8, device="meta")
    for call in (lambda: gather_rows(x, torch.empty(5, dtype=torch.int32, device="meta")),
                 lambda: gather_lanes(x, torch.empty(10, 3, dtype=torch.int32, device="meta"))):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert not gather_rows.launches and not gather_lanes.launches


def test_device_tensor_off_the_kernel_layout_is_refused(monkeypatch):
    """G1 copies 16-byte vectors and G2 2- or 4-byte elements: other rows
    and element sizes raise before any launch."""
    monkeypatch.setattr(gather_cuda, "_kernel", lambda name: lambda *_: pytest.fail("launched"))
    idx = torch.empty(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="16-byte"):
        gather_rows(torch.empty(10, 6, device="meta"), idx)  # 24-byte rows
    with pytest.raises(TypeError, match="2- or 4-byte"):
        gather_lanes(torch.empty(10, 8, dtype=torch.float64, device="meta"),
                     torch.empty(10, 3, dtype=torch.int32, device="meta"))


def test_launch_floor_refuses_a_cpu_tensor(monkeypatch):
    """The empty kernel beside G2 measures the card: it has no plain version,
    and a tensor on the CPU raises before any launch."""
    monkeypatch.setattr(gather_cuda, "_kernel", lambda name: lambda *_: pytest.fail("launched"))
    with pytest.raises(ValueError, match="CUDA device"):
        gather_cuda.gather_lanes_floor(torch.zeros(4, 8), torch.zeros(4, 2, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        gather_cuda.gather_lanes_floor(torch.zeros(4, 8), torch.zeros(4, 2))


def test_lane_launch_at_the_probe_shape():
    """G2's grid at the TPU probes' (512, 128): as few blocks as cover the
    rows, 8 whole rows of 32 threads a block at 4 lanes a thread."""
    assert gather_cuda.lane_launch(512, 128) == (64, 32, 8)
    assert gather_cuda.lane_launch(512, 128, 2) == (128, 64, 4)
    assert gather_cuda.lane_launch(512, 128, 8) == (32, 16, 16)
    for bad in ((0, 4, 4), (4, 0, 4), (4, 4, 3)):
        with pytest.raises(ValueError, match="lane_launch"):
            gather_cuda.lane_launch(*bad)


@pytest.mark.parametrize("rows, k, lanes", [(512, 128, 4), (512, 128, 2), (512, 128, 8),
                                            (1, 1, 2), (3, 5, 4), (7, 1000, 8), (300, 33, 2)])
def test_lane_launch_covers_every_output_once(rows, k, lanes):
    """The kernel's walk over lane_launch's grid (row blockIdx.x * rows a
    block + threadIdx.y; runs of ``lanes`` from threadIdx.x * lanes, a
    block's row width apart), emulated: every output written exactly once,
    at most 256 threads a block, no block without a row."""
    grid, per_row, block_rows = gather_cuda.lane_launch(rows, k, lanes)
    assert per_row * block_rows <= gather_cuda.LANE_BLOCK_THREADS
    assert (grid - 1) * block_rows < rows <= grid * block_rows
    written = np.zeros((rows, k), dtype=np.int64)
    for block in range(grid):
        for ty in range(block_rows):
            row = block * block_rows + ty
            if row >= rows:
                continue
            for tx in range(per_row):
                for j in range(tx * lanes, k, per_row * lanes):
                    written[row, j:j + lanes] += 1
    assert (written == 1).all()


def test_index_walk_refuses_a_cpu_tensor(monkeypatch):
    """G2's index-only walk is a probe of the card: a tensor on the CPU, or
    indices that are not 2-D int32, raise before any launch."""
    monkeypatch.setattr(gather_cuda, "_kernel", lambda name: lambda *_: pytest.fail("launched"))
    with pytest.raises(ValueError, match="CUDA device"):
        gather_cuda.gather_lanes_indices(torch.zeros(4, 2, dtype=torch.int32), torch.float32)

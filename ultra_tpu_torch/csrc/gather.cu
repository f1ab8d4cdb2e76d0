// Gathers for Hopper (sm_90a): the row gather G1 and the lane gather G2.
//
//   G1 (gather_rows):  out[i, :] = x[idx[i], :]       x (V, F), idx (N,) int32
//   G2 (gather_lanes): out[i, j] = x[i, idx[i, j]]    x (M, W), idx (M, K) int32
//
// They replace the TPU gather probes under scripts/: the row gathers
// (aot_compile_probe.py make_dma_sp / make_same_shape_axis0,
// exp_dma_gather.py probe_dma / probe_same_shape / probe_windowed,
// exp_dma_gather3.py probe_dma_sp / probe_dma_db / probe_same_shape,
// exp_vmem_gather.py::run, exp_vmem_gather2.py::run, and the gather stage of
// exp_v2proto.py / exp_v2_stages.py), which tried DMA per row, Mosaic's
// same-shape dynamic gather and VMEM-resident tables because a TPU kernel
// cannot index memory by a loaded value; and the lane gathers
// (aot_compile_probe.py::make_lane_gather, exp_dma_gather.py::probe_lane).
// A GPU thread loads from any address, so each is one plain kernel.
//
// What bounds them on an H100: bytes. G1 moves each output row once and
// reads x's rows from wherever idx points (a row read many times is served
// from L2 after its first read); it copies 16-byte vectors, so any element
// type whose row is a multiple of 16 bytes (bf16 and f32 at F=512) takes the
// same path. One warp copies one output row, its lanes on neighbouring
// vectors, and reads the row's index once. The output is written with
// streaming stores (evict first), so the table can stay in L2 while the
// output passes through it. G2 copies one 2- or 4-byte element per thread;
// its reads within a row are scattered, its writes contiguous.
// Offsets are 64-bit.
//
// gather_empty launches a kernel that does nothing, on G2's grid: its time
// is the floor under any launch of G2, what no redesign of G2 can go below.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void gather_rows_kernel(const uint4* __restrict__ x, const int32_t* __restrict__ idx,
                                   uint4* __restrict__ out, int64_t num_idx, int64_t vecs) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
       i < num_idx; i += warps) {
    const uint4* src = x + static_cast<int64_t>(__ldg(idx + i)) * vecs;
    uint4* dst = out + i * vecs;
#pragma unroll 4
    for (int64_t j = lane; j < vecs; j += 32) __stcs(dst + j, __ldg(src + j));
  }
}

template <typename T>
__global__ void gather_lanes_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                                    T* __restrict__ out, int64_t rows, int64_t width,
                                    int64_t k_per_row) {
  const int64_t total = rows * k_per_row;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < total;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = k / k_per_row;
    out[k] = __ldg(x + i * width + __ldg(idx + k));
  }
}

__global__ void empty_kernel() {}

constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads per SM

// blocks for `total` work items of `per_block` each, at most kMaxBlocks
unsigned blocks_for(int64_t total, int64_t per_block = kThreads) {
  const int64_t b = (total + per_block - 1) / per_block;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: (V, row_bytes) of any element type; idx: (num_idx) int32 in [0, V);
// out: (num_idx, row_bytes). Contiguous on one device. row_bytes % 16 != 0 or
// an x or out not 16-byte aligned returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int gather_rows(const void* x, const void* idx, void* out, long long num_idx,
                           long long row_bytes, void* stream) {
  if (num_idx <= 0 || row_bytes <= 0 || row_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(x) || !aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
  const long long vecs = row_bytes / 16;
  gather_rows_kernel<<<blocks_for(num_idx, kWarpsPerBlock), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int32_t*>(idx), static_cast<uint4*>(out),
      num_idx, vecs);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: (rows, width) with elements of elem_bytes 2 or 4; idx: (rows, k) int32
// in [0, width); out: (rows, k) like x. Contiguous on one device. Another
// elem_bytes returns cudaErrorInvalidValue and launches nothing.
extern "C" int gather_lanes(const void* x, const void* idx, void* out, long long rows,
                            long long width, long long k, int elem_bytes, void* stream) {
  if (rows <= 0 || width <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int32_t*>(idx);
  const unsigned grid = blocks_for(rows * k);
  if (elem_bytes == 2) {
    gather_lanes_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), id, static_cast<uint16_t*>(out), rows, width, k);
  } else if (elem_bytes == 4) {
    gather_lanes_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), id, static_cast<uint32_t*>(out), rows, width, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches empty_kernel on `stream` with the grid gather_lanes takes for
// `total` = rows * k elements, and returns cudaGetLastError() (0 on success).
extern "C" int gather_empty(long long total, void* stream) {
  if (total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

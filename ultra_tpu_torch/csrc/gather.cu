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
// output passes through it. G1's offsets are 64-bit.
//
// G2 at the probes' shape, (512, 128), moves 0.5 MB: its time is the launch
// and one chain of dependent loads (index, then element, then the store),
// not bytes. So a block takes a group of whole rows and a thread a run of
// LANES neighbouring lanes of one row (a 2-D block: threadIdx.y the row,
// threadIdx.x the run), with no division anywhere; it reads its run's
// indices as one 8- or 16-byte vector where the row length allows, issues
// all LANES element loads before any store, and stores the run as one
// vector. Offsets are 32-bit where every offset fits, else 64-bit. The
// grid, from the wrapper (ops/gather_cuda.py::lane_launch), is as few blocks
// as cover the rows: 64 blocks of 32 x 8 threads at 4 lanes a thread for
// (512, 128). gather_lanes_indices runs the same walk but stores the
// indices themselves, loading no element: the time of the first link of the
// chain. gather_empty launches a kernel that does nothing on a given grid:
// its time is the floor under any launch on that grid.

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

// the run's LANES indices: one vector load where VEC (the run is whole and
// aligned), else one load per lane inside the row (0 past its end)
template <int LANES, bool VEC, typename Off>
__device__ __forceinline__ void load_indices(const int32_t* p, Off left, int32_t (&id)[LANES]) {
  if constexpr (VEC && LANES == 2) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(p));
    id[0] = q.x;
    id[1] = q.y;
  } else if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < LANES / 4; ++c) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(p) + c);
      id[4 * c] = q.x;
      id[4 * c + 1] = q.y;
      id[4 * c + 2] = q.z;
      id[4 * c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < LANES; ++l) id[l] = l < left ? __ldg(p + l) : 0;
  }
}

// the run's LANES values: vector stores of 16, 8 or 4 bytes where VEC, else
// one store per lane inside the row
template <typename T, int LANES, bool VEC, typename Off>
__device__ __forceinline__ void store_run(T* dst, Off left, const T* v) {
  constexpr int kBytes = LANES * static_cast<int>(sizeof(T));
  if constexpr (VEC && kBytes >= 16) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(v)[c];
    }
  } else if constexpr (VEC && kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
  } else if constexpr (VEC) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(v);
  } else {
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      if (l < left) dst[l] = v[l];
    }
  }
}

// Row blockIdx.x * blockDim.y + threadIdx.y; the thread's runs start at lane
// threadIdx.x * LANES and step by blockDim.x * LANES. INDEX_ONLY stores each
// index's bits (the low ones for a 2-byte T) instead of the element.
template <typename T, typename Off, int LANES, bool VEC, bool INDEX_ONLY>
__global__ void gather_lanes_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                                    T* __restrict__ out, Off rows, Off width, Off k) {
  const Off row = static_cast<Off>(blockIdx.x) * static_cast<Off>(blockDim.y) +
                  static_cast<Off>(threadIdx.y);
  if (row >= rows) return;
  const T* xr = x + row * width;
  const int32_t* ir = idx + row * k;
  T* orow = out + row * k;
  for (Off j = static_cast<Off>(threadIdx.x) * LANES; j < k;
       j += static_cast<Off>(blockDim.x) * LANES) {
    int32_t id[LANES];
    load_indices<LANES, VEC>(ir + j, k - j, id);
    alignas(16) T v[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      if constexpr (INDEX_ONLY) {
        v[l] = static_cast<T>(id[l]);
      } else {
        v[l] = (VEC || j + l < k) ? __ldg(xr + id[l]) : T(0);
      }
    }
    store_run<T, LANES, VEC>(orow + j, k - j, v);
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

namespace {

template <typename T, typename Off, int LANES, bool INDEX_ONLY>
void launch_lanes(bool vec, dim3 grid, dim3 block, cudaStream_t s, const void* x, const void* idx,
                  void* out, long long rows, long long width, long long k) {
  const auto* xt = static_cast<const T*>(x);
  const auto* it = static_cast<const int32_t*>(idx);
  auto* ot = static_cast<T*>(out);
  const Off r = static_cast<Off>(rows), w = static_cast<Off>(width), n = static_cast<Off>(k);
  if (vec) {
    gather_lanes_kernel<T, Off, LANES, true, INDEX_ONLY><<<grid, block, 0, s>>>(xt, it, ot, r, w, n);
  } else {
    gather_lanes_kernel<T, Off, LANES, false, INDEX_ONLY><<<grid, block, 0, s>>>(xt, it, ot, r, w, n);
  }
}

template <typename T, typename Off, bool INDEX_ONLY>
void launch_lanes_for(int lanes, bool vec, dim3 grid, dim3 block, cudaStream_t s, const void* x,
                      const void* idx, void* out, long long rows, long long width, long long k) {
  if (lanes == 2) {
    launch_lanes<T, Off, 2, INDEX_ONLY>(vec, grid, block, s, x, idx, out, rows, width, k);
  } else if (lanes == 4) {
    launch_lanes<T, Off, 4, INDEX_ONLY>(vec, grid, block, s, x, idx, out, rows, width, k);
  } else {
    launch_lanes<T, Off, 8, INDEX_ONLY>(vec, grid, block, s, x, idx, out, rows, width, k);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

// a grid the kernel can take: every row covered, at most 1024 threads a block
bool grid_ok(long long rows, long long grid, int block_x, int block_y) {
  return grid >= 1 && grid <= 0x7fffffffLL && block_x >= 1 && block_y >= 1 &&
         static_cast<long long>(block_x) * block_y <= 1024 && grid * block_y >= rows;
}

template <bool INDEX_ONLY>
int lanes_entry(const void* x, const void* idx, void* out, long long rows, long long width,
                long long k, int elem_bytes, int lanes, long long grid, int block_x, int block_y,
                void* stream) {
  if (rows <= 0 || width <= 0 || k <= 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      (lanes != 2 && lanes != 4 && lanes != 8) || !grid_ok(rows, grid, block_x, block_y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // whole runs, their index vectors and their stored vectors aligned
  const unsigned run_bytes = static_cast<unsigned>(lanes * elem_bytes);
  const bool vec = k % lanes == 0 && aligned(idx, lanes == 2 ? 8u : 16u) &&
                   aligned(out, run_bytes < 16u ? run_bytes : 16u);
  // 32-bit offsets where every offset (and a run's start past a row's end) fits
  const long long most = (rows * width > rows * k ? rows * width : rows * k) + 8 * 1024;
  const bool small = most < 0x7fffffffLL;
  const dim3 g(static_cast<unsigned>(grid)), b(block_x, block_y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2 && small) {
    launch_lanes_for<uint16_t, int32_t, INDEX_ONLY>(lanes, vec, g, b, s, x, idx, out, rows, width, k);
  } else if (elem_bytes == 2) {
    launch_lanes_for<uint16_t, int64_t, INDEX_ONLY>(lanes, vec, g, b, s, x, idx, out, rows, width, k);
  } else if (small) {
    launch_lanes_for<uint32_t, int32_t, INDEX_ONLY>(lanes, vec, g, b, s, x, idx, out, rows, width, k);
  } else {
    launch_lanes_for<uint32_t, int64_t, INDEX_ONLY>(lanes, vec, g, b, s, x, idx, out, rows, width, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: (rows, width) with elements of elem_bytes 2 or 4; idx: (rows, k) int32
// in [0, width); out: (rows, k) like x. Contiguous on one device. `lanes`
// (2, 4 or 8) lanes a thread, on a grid of `grid` blocks of block_x x
// block_y threads that covers the rows (grid * block_y >= rows). Another
// elem_bytes or lanes, or a grid that does not cover the rows, returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int gather_lanes(const void* x, const void* idx, void* out, long long rows,
                            long long width, long long k, int elem_bytes, int lanes,
                            long long grid, int block_x, int block_y, void* stream) {
  return lanes_entry<false>(x, idx, out, rows, width, k, elem_bytes, lanes, grid, block_x,
                            block_y, stream);
}

// As gather_lanes, but stores each index's bits (the low 16 for elem_bytes
// 2) and loads no element: x is not read.
extern "C" int gather_lanes_indices(const void* idx, void* out, long long rows, long long k,
                                    int elem_bytes, int lanes, long long grid, int block_x,
                                    int block_y, void* stream) {
  return lanes_entry<true>(nullptr, idx, out, rows, 1, k, elem_bytes, lanes, grid, block_x,
                           block_y, stream);
}

// Launches empty_kernel on `stream` on a grid of `grid` blocks of block_x x
// block_y threads, and returns cudaGetLastError() (0 on success).
extern "C" int gather_empty(long long grid, int block_x, int block_y, void* stream) {
  if (!grid_ok(1, grid, block_x, block_y)) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<static_cast<unsigned>(grid), dim3(block_x, block_y), 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

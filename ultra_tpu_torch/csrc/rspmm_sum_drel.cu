// Sum-aggregation relational SpMM, relation gradient, for Hopper (sm_90a).
//
//   d_rel[t, f] = sum over edges e of type t of  w[eid_e] * x[src_e, f] * g[dst_e, f]   (mul_op 0)
//   d_rel[t, f] = sum over edges e of type t of  w[eid_e] * g[dst_e, f]                 (mul_op 1)
//   a type with no edges is 0. f32 operands, f32 accumulation, f32 output.
//
// This is the gradient of rspmm_sum_fwd.cu's function with respect to its
// relation operand, for distmult (mul) and transe (add) messages. It replaces
// the TPU kernels ultra_tpu/ops/rspmm_pallas.py::_rel_grad_kernel,
// ultra_tpu/ops/rspmm_pallas_v2.py::_drel_kernel and ::_drel_add_kernel,
// which compute it with one-hot matrix products into one resident output
// block; a GPU thread gathers rows directly, so none of that is carried over.
//
// What bounds it on an H100: bytes. Per edge and feature it does 2-3 flops on
// two gathered 4-byte rows, far below the card's f32 flops-per-byte balance,
// so the floor is each input read once (x, g, w, the segments) and d_rel
// written once. The design:
// - the edges are sorted by type on the host (graph.py::build_segments) and
//   each type's run is cut into chunks of at most 256 edges. The types are
//   few and skewed (4 on the relation graph, each a quarter of its edges;
//   474 on the entity graph, the largest 23,200 of 544,230 edges), so one
//   block per type would leave most of the 132 SMs idle and let the largest
//   type set the launch's length. Chunks spread every type over many blocks;
// - pass 1: one block per (chunk, feature tile) walks its chunk's edges in
//   order with the sum in registers and writes one partial row per chunk;
// - pass 2: one block per (type, feature tile) adds that type's partial rows
//   in chunk order. No atomics anywhere, so two runs give the same bits;
// - each thread owns 4 contiguous features and loads float4, so a warp reads
//   512 contiguous bytes of every gathered row. F must be a multiple of 4 and
//   x, g, partial and out 16-byte aligned; anything else is refused, never run
//   on a slower path. Within a type the edges keep destination order, so the
//   g rows of neighbouring edges repeat and hit L1/L2.
// Offsets row*F are 64-bit, as in rspmm_sum_fwd.cu.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// `width` is the row length in float4s (F / 4).
template <int OP>
__global__ void drel_chunk_kernel(const int64_t* __restrict__ chunkptr,
                                  const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ eid,
                                  const float* __restrict__ weight,
                                  const float4* __restrict__ x,
                                  const float4* __restrict__ g,
                                  float4* __restrict__ partial,
                                  int64_t width) {
  const int64_t chunk = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const int64_t begin = chunkptr[chunk];
  const int64_t end = chunkptr[chunk + 1];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // unrolled so that the index and row loads of several edges are in flight
  // at once; the sum still adds the edges in order
#pragma unroll 4
  for (int64_t e = begin; e < end; ++e) {
    const float w = __ldg(weight + __ldg(eid + e));
    const float4 gv = __ldg(g + static_cast<int64_t>(__ldg(dst + e)) * width + j);
    if (OP == 0) {
      const float4 xv = __ldg(x + static_cast<int64_t>(__ldg(src + e)) * width + j);
      acc.x += w * (xv.x * gv.x);
      acc.y += w * (xv.y * gv.y);
      acc.z += w * (xv.z * gv.z);
      acc.w += w * (xv.w * gv.w);
    } else {
      acc.x += w * gv.x;
      acc.y += w * gv.y;
      acc.z += w * gv.z;
      acc.w += w * gv.w;
    }
  }
  partial[chunk * width + j] = acc;
}

__global__ void drel_type_kernel(const int64_t* __restrict__ type_chunkptr,
                                 const float4* __restrict__ partial,
                                 float4* __restrict__ out, int64_t width) {
  const int64_t type = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const int64_t begin = type_chunkptr[type];
  const int64_t end = type_chunkptr[type + 1];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t c = begin; c < end; ++c) {
    const float4 p = partial[c * width + j];
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  out[type * width + j] = acc;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). chunkptr: (num_chunks+1) int64; type_chunkptr: (num_types+1)
// int64; src, dst, eid: (E) int32 in type order; weight: f32 indexed by eid;
// x: (N, num_feat) f32 (not read for mul_op 1); g: (V, num_feat) f32;
// partial: (num_chunks, num_feat) f32 scratch; out: (num_types, num_feat) f32.
// All contiguous on one device; indices are trusted to be in range.
// num_feat % 4 != 0 or a misaligned x, g, partial or out returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int rspmm_sum_drel(const void* chunkptr, const void* type_chunkptr,
                              const void* src, const void* dst, const void* eid,
                              const void* weight, const void* x, const void* g,
                              void* partial, void* out, long long num_chunks,
                              long long num_types, long long num_feat, int mul_op,
                              void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_types <= 0 || num_chunks < 0 || num_feat <= 0 || num_feat % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(x) || !aligned16(g) || !aligned16(partial) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long width = num_feat / 4;
  const long long warps = (width + 31) / 32;
  const int threads = static_cast<int>(warps < 8 ? warps * 32 : 256);
  const unsigned tiles = static_cast<unsigned>((width + threads - 1) / threads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int64_t*>(chunkptr);
  const auto* tcp = static_cast<const int64_t*>(type_chunkptr);
  const auto* sr = static_cast<const int32_t*>(src);
  const auto* ds = static_cast<const int32_t*>(dst);
  const auto* id = static_cast<const int32_t*>(eid);
  const auto* w = static_cast<const float*>(weight);
  const auto* xs = static_cast<const float4*>(x);
  const auto* gs = static_cast<const float4*>(g);
  auto* part = static_cast<float4*>(partial);
  if (num_chunks > 0) {
    const dim3 grid(static_cast<unsigned>(num_chunks), tiles);
    if (mul_op == 0) {
      drel_chunk_kernel<0><<<grid, threads, 0, s>>>(cp, sr, ds, id, w, xs, gs, part, width);
    } else {
      drel_chunk_kernel<1><<<grid, threads, 0, s>>>(cp, sr, ds, id, w, xs, gs, part, width);
    }
    const int status = static_cast<int>(cudaGetLastError());
    if (status != 0) return status;
  }
  const dim3 grid2(static_cast<unsigned>(num_types), tiles);
  drel_type_kernel<<<grid2, threads, 0, s>>>(tcp, part, static_cast<float4*>(out), width);
  return static_cast<int>(cudaGetLastError());
}

// Min/max-aggregation relational SpMM, relation gradient, for Hopper (sm_90a).
//
//   d_rel[t, f] = sum over the live edges e of type t that are routed at f of
//                 w[eid_e] * (x[src_e, f] if mul_op 0 else 1) * g[dst_e, f]
//   where e is routed at f when (rel[t, f] op x[src_e, f]) * w[eid_e] equals
//   out[dst_e, f], the forward's saved output; every tying edge is routed. A
//   type with no routed edge is 0. f32 operands, f32 accumulation, f32 output.
//
// This is the gradient of rspmm_minmax_fwd.cu's function with respect to its
// relation operand. It replaces the TPU kernels
// ultra_tpu/ops/rspmm_pallas.py::_minmax_drel_kernel and
// ultra_tpu/ops/rspmm_pallas_v2.py::_minmax_drel_kernel_v2, which reduce into
// one resident output block through one-hot matrix products; GPU blocks run
// in no order, so the reduction over a type is split in two passes.
//
// Routing compares bit-identical values, as in rspmm_minmax_dx.cu: the
// message is recomputed as (rel op x) * w with __fmul_rn / __fadd_rn and
// compared with the forward's own output. Unlike the sum relation gradient
// (rspmm_sum_drel.cu), x is read for transe (add) too: the route needs the
// message.
//
// What bounds it on an H100: bytes. Per edge and feature it reads three
// gathered rows (x, out and g) and does about 6 operations. The design is
// B2's (rspmm_sum_drel.cu):
// - the edges are sorted by type on the host and each type's run is cut into
//   chunks of at most 256 edges (graph.py::build_segments), so the few,
//   skewed types spread over many blocks;
// - pass 1: one block per (chunk, feature tile) loads its type's rel row
//   once (a chunk holds one type), walks the chunk's edges with the sum in
//   registers and writes one partial row per chunk; an edge of weight 0 is
//   skipped before its rows are loaded;
// - pass 2: one block per (type, feature tile) adds that type's partial rows
//   in chunk order. No atomics anywhere, so two runs give the same bits;
// - each thread owns 4 contiguous features and loads float4 (F % 4 == 0 and
//   16-byte aligned rows; anything else is refused). Within a type the edges
//   keep destination order, so neighbouring edges share g and out rows.
// Offsets row*F are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int OP>
__device__ __forceinline__ float message(float r, float x, float w) {
  return __fmul_rn(OP == 0 ? __fmul_rn(r, x) : __fadd_rn(r, x), w);
}

// the routed term of one feature: w * (x if mul else 1) * g, or 0
template <int OP>
__device__ __forceinline__ float term(float r, float x, float w, float o, float g) {
  if (message<OP>(r, x, w) != o) return 0.f;
  return OP == 0 ? __fmul_rn(__fmul_rn(w, x), g) : __fmul_rn(w, g);
}

// `width` is the row length in float4s (F / 4).
template <int OP>
__global__ void minmax_drel_chunk_kernel(const int64_t* __restrict__ chunkptr,
                                         const int32_t* __restrict__ etype,
                                         const int32_t* __restrict__ src,
                                         const int32_t* __restrict__ dst,
                                         const int32_t* __restrict__ eid,
                                         const float* __restrict__ weight,
                                         const float4* __restrict__ rel,
                                         const float4* __restrict__ x,
                                         const float4* __restrict__ g,
                                         const float4* __restrict__ out,
                                         float4* __restrict__ partial,
                                         int64_t width) {
  const int64_t chunk = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const int64_t begin = chunkptr[chunk];
  const int64_t end = chunkptr[chunk + 1];
  const int64_t type = __ldg(etype + begin);  // chunks are never empty
  const float4 rv = __ldg(rel + type * width + j);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t e = begin; e < end; ++e) {
    const float w = __ldg(weight + __ldg(eid + e));
    if (w == 0.f) continue;
    const int64_t d = __ldg(dst + e);
    const float4 xv = __ldg(x + static_cast<int64_t>(__ldg(src + e)) * width + j);
    const float4 ov = __ldg(out + d * width + j);
    const float4 gv = __ldg(g + d * width + j);
    acc.x += term<OP>(rv.x, xv.x, w, ov.x, gv.x);
    acc.y += term<OP>(rv.y, xv.y, w, ov.y, gv.y);
    acc.z += term<OP>(rv.z, xv.z, w, ov.z, gv.z);
    acc.w += term<OP>(rv.w, xv.w, w, ov.w, gv.w);
  }
  partial[chunk * width + j] = acc;
}

__global__ void minmax_drel_type_kernel(const int64_t* __restrict__ type_chunkptr,
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
// int64; etype, src, dst, eid: (E) int32 in type order; weight: f32 indexed
// by eid; rel: (num_types, num_feat) f32; x: (N, num_feat) f32; g, out: (V,
// num_feat) f32; partial: (num_chunks, num_feat) f32 scratch; d_rel:
// (num_types, num_feat) f32. All contiguous on one device; indices are
// trusted to be in range. num_feat % 4 != 0 or a misaligned row operand
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int rspmm_minmax_drel(const void* chunkptr, const void* type_chunkptr,
                                 const void* etype, const void* src, const void* dst,
                                 const void* eid, const void* weight, const void* rel,
                                 const void* x, const void* g, const void* out,
                                 void* partial, void* d_rel, long long num_chunks,
                                 long long num_types, long long num_feat, int mul_op,
                                 void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_types <= 0 || num_chunks < 0 || num_feat <= 0 || num_feat % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(rel) || !aligned16(x) || !aligned16(g) || !aligned16(out) ||
      !aligned16(partial) || !aligned16(d_rel)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long width = num_feat / 4;
  const long long warps = (width + 31) / 32;
  const int threads = static_cast<int>(warps < 8 ? warps * 32 : 256);
  const unsigned tiles = static_cast<unsigned>((width + threads - 1) / threads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int64_t*>(chunkptr);
  const auto* tcp = static_cast<const int64_t*>(type_chunkptr);
  const auto* et = static_cast<const int32_t*>(etype);
  const auto* sr = static_cast<const int32_t*>(src);
  const auto* ds = static_cast<const int32_t*>(dst);
  const auto* id = static_cast<const int32_t*>(eid);
  const auto* w = static_cast<const float*>(weight);
  const auto* r = static_cast<const float4*>(rel);
  const auto* xs = static_cast<const float4*>(x);
  const auto* gs = static_cast<const float4*>(g);
  const auto* os = static_cast<const float4*>(out);
  auto* part = static_cast<float4*>(partial);
  if (num_chunks > 0) {
    const dim3 grid(static_cast<unsigned>(num_chunks), tiles);
    if (mul_op == 0) {
      minmax_drel_chunk_kernel<0><<<grid, threads, 0, s>>>(cp, et, sr, ds, id, w, r, xs, gs,
                                                           os, part, width);
    } else {
      minmax_drel_chunk_kernel<1><<<grid, threads, 0, s>>>(cp, et, sr, ds, id, w, r, xs, gs,
                                                           os, part, width);
    }
    const int status = static_cast<int>(cudaGetLastError());
    if (status != 0) return status;
  }
  const dim3 grid2(static_cast<unsigned>(num_types), tiles);
  minmax_drel_type_kernel<<<grid2, threads, 0, s>>>(tcp, part, static_cast<float4*>(d_rel),
                                                    width);
  return static_cast<int>(cudaGetLastError());
}

// Sum-aggregation relational SpMM, forward, for Hopper (sm_90a).
//
//   out[v, f] = sum over edges e of row v of  w[eid_e] * op(rel[type_e, f], x[src_e, f])
//   op = * (distmult, mul_op 0) or + (transe, mul_op 1); a row with no edges is 0.
//   f32 operands, f32 accumulation, f32 output.
//
// Replaces the TPU kernels ultra_tpu/ops/rspmm_pallas.py::_fwd_kernel,
// ultra_tpu/ops/rspmm_pallas_v2.py::_fused_kernel and
// ultra_tpu/ops/rspmm_pallas_w3.py::_w3_kernel, which compute this function.
// They build the gather and the scatter out of one-hot matrix products,
// fold-8 layouts and relation tables because the TPU kernel cannot gather
// rows; a GPU thread can load any row, so none of that is carried over.
//
// What bounds it on an H100: bytes. Per edge and feature it does 3 flops on
// two gathered 4-byte operands, far below the card's f32 flops-per-byte
// balance, so the floor is each input read once (x, rel, w, the CSR) and
// out written once. The design:
// - one block per (destination row, feature tile) walks the row's edges in
//   CSR order: the accumulator stays in registers, there are no atomics and
//   the result is deterministic;
// - each thread owns 4 contiguous features and loads float4, so a warp reads
//   512 contiguous bytes of every gathered row. F must be a multiple of 4 and
//   rel, x and out 16-byte aligned (every width on the serving path is B*64);
//   anything else is refused, never run on a slower path;
// - an x row is re-read once per incoming edge (E*F*4 bytes in all); those
//   reads hit L2 while x fits its 50 MB. Keeping x resident or staging rows
//   with asynchronous copies is left to a later version;
// - a row's edges are walked one after another by one block, each edge an
//   index load and then a dependent row load, so on power-law graphs the
//   rows with thousands of edges set the launch's length. Splitting long
//   rows across blocks is left to a later version.
// Offsets row*F are 64-bit: F=4096 on 120K-node graphs comes near 2^31.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int OP>
__device__ __forceinline__ float op(float r, float x) {
  return OP == 0 ? r * x : r + x;
}

// `width` is the row length in float4s (F / 4).
template <int OP>
__global__ void rspmm_sum_fwd_kernel(const int64_t* __restrict__ rowptr,
                                     const int32_t* __restrict__ col,
                                     const int32_t* __restrict__ etype,
                                     const int32_t* __restrict__ eid,
                                     const float* __restrict__ weight,
                                     const float4* __restrict__ rel,
                                     const float4* __restrict__ x,
                                     float4* __restrict__ out,
                                     int64_t width) {
  const int64_t row = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t e = begin; e < end; ++e) {
    const int64_t src = __ldg(col + e);
    const int64_t type = __ldg(etype + e);
    const float w = __ldg(weight + __ldg(eid + e));
    const float4 xv = __ldg(x + src * width + j);
    const float4 rv = __ldg(rel + type * width + j);
    acc.x += w * op<OP>(rv.x, xv.x);
    acc.y += w * op<OP>(rv.y, xv.y);
    acc.z += w * op<OP>(rv.z, xv.z);
    acc.w += w * op<OP>(rv.w, xv.w);
  }
  out[row * width + j] = acc;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rowptr: (num_rows+1) int64; col, etype, eid: (E) int32; weight: f32 indexed
// by eid; rel: (R, num_feat) f32; x: (N, num_feat) f32; out: (num_rows, num_feat)
// f32. All contiguous on one device; indices are trusted to be in range.
// num_feat % 4 != 0 or a rel, x or out not 16-byte aligned returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int rspmm_sum_fwd(const void* rowptr, const void* col, const void* etype,
                             const void* eid, const void* weight, const void* rel,
                             const void* x, void* out, long long num_rows,
                             long long num_feat, int mul_op, void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows <= 0 || num_feat <= 0 || num_feat % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(rel) || !aligned16(x) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long width = num_feat / 4;
  const long long warps = (width + 31) / 32;
  const int threads = static_cast<int>(warps < 8 ? warps * 32 : 256);
  const dim3 grid(static_cast<unsigned>(num_rows),
                  static_cast<unsigned>((width + threads - 1) / threads));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int64_t*>(rowptr);
  const auto* c = static_cast<const int32_t*>(col);
  const auto* t = static_cast<const int32_t*>(etype);
  const auto* id = static_cast<const int32_t*>(eid);
  const auto* w = static_cast<const float*>(weight);
  const auto* r = static_cast<const float4*>(rel);
  const auto* xs = static_cast<const float4*>(x);
  auto* o = static_cast<float4*>(out);
  if (mul_op == 0) {
    rspmm_sum_fwd_kernel<0><<<grid, threads, 0, s>>>(rp, c, t, id, w, r, xs, o, width);
  } else {
    rspmm_sum_fwd_kernel<1><<<grid, threads, 0, s>>>(rp, c, t, id, w, r, xs, o, width);
  }
  return static_cast<int>(cudaGetLastError());
}

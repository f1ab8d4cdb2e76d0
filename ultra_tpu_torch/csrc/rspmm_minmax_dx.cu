// Min/max-aggregation relational SpMM, input gradient, for Hopper (sm_90a).
//
//   d_x[u, f] = sum over the live edges e with src_e = u that are routed at f of
//               w[eid_e] * (rel[type_e, f] if mul_op 0 else 1) * g[dst_e, f]
//   where e is routed at f when (rel[type_e, f] op x[u, f]) * w[eid_e] equals
//   out[dst_e, f], the forward's saved output. Every tying edge is routed and
//   gets the whole gradient, not a share. A source with no routed edge is 0.
//   f32 operands, f32 accumulation, f32 output.
//
// This is the gradient of rspmm_minmax_fwd.cu's function with respect to x.
// It replaces the TPU kernels ultra_tpu/ops/rspmm_pallas.py::_minmax_dx_kernel
// and ultra_tpu/ops/rspmm_pallas_v2.py::_minmax_dx_kernel_v2, which gather
// and scatter with one-hot matrix products; a GPU thread loads rows directly.
//
// Routing compares bit-identical values: the message is recomputed as
// (rel op x) * w with __fmul_rn / __fadd_rn, exactly as the forward kernel
// and the plain versions write it, and `out` must be the forward's own
// output (a row with no live edge holds +-inf, which no finite message
// equals, so no fill is needed).
//
// What bounds it on an H100: bytes. Per edge and feature it reads three
// gathered rows (rel, out and g) and does about 6 operations, far below the
// card's f32 flops-per-byte balance. The design:
// - one block per (source row u, feature tile) walks u's edges on the
//   source-major CSR with the sum in registers: no atomics, and two runs give
//   the same bits;
// - x[u]'s tile is loaded once per block, not once per edge;
// - an edge of weight 0 is skipped before its rows are loaded;
// - each thread owns 4 contiguous features and loads float4 (F % 4 == 0 and
//   16-byte aligned rows; anything else is refused);
// - as in B1, the hub rows (out-degree in the thousands on power-law graphs)
//   set the launch's length; splitting them is left to a later version.
// Offsets row*F are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int OP>
__device__ __forceinline__ float message(float r, float x, float w) {
  return __fmul_rn(OP == 0 ? __fmul_rn(r, x) : __fadd_rn(r, x), w);
}

// the routed term of one feature: w * (r if mul else 1) * g, or 0
template <int OP>
__device__ __forceinline__ float term(float r, float x, float w, float o, float g) {
  if (message<OP>(r, x, w) != o) return 0.f;
  return OP == 0 ? __fmul_rn(__fmul_rn(w, r), g) : __fmul_rn(w, g);
}

// `width` is the row length in float4s (F / 4).
template <int OP>
__global__ void rspmm_minmax_dx_kernel(const int64_t* __restrict__ rowptr,
                                       const int32_t* __restrict__ col,
                                       const int32_t* __restrict__ etype,
                                       const int32_t* __restrict__ eid,
                                       const float* __restrict__ weight,
                                       const float4* __restrict__ rel,
                                       const float4* __restrict__ x,
                                       const float4* __restrict__ g,
                                       const float4* __restrict__ out,
                                       float4* __restrict__ dx,
                                       int64_t width) {
  const int64_t row = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (begin < end) {
    const float4 xv = __ldg(x + row * width + j);
    for (int64_t e = begin; e < end; ++e) {
      const float w = __ldg(weight + __ldg(eid + e));
      if (w == 0.f) continue;
      const int64_t dst = __ldg(col + e);
      const int64_t type = __ldg(etype + e);
      const float4 rv = __ldg(rel + type * width + j);
      const float4 ov = __ldg(out + dst * width + j);
      const float4 gv = __ldg(g + dst * width + j);
      acc.x += term<OP>(rv.x, xv.x, w, ov.x, gv.x);
      acc.y += term<OP>(rv.y, xv.y, w, ov.y, gv.y);
      acc.z += term<OP>(rv.z, xv.z, w, ov.z, gv.z);
      acc.w += term<OP>(rv.w, xv.w, w, ov.w, gv.w);
    }
  }
  dx[row * width + j] = acc;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rowptr: (num_rows+1) int64 of the source-major CSR; col (the destination),
// etype, eid: (E) int32; weight: f32 indexed by eid; rel: (R, num_feat) f32;
// x, dx: (num_rows, num_feat) f32; g, out: (V, num_feat) f32. All contiguous
// on one device; indices are trusted to be in range. num_feat % 4 != 0 or a
// row operand not 16-byte aligned returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int rspmm_minmax_dx(const void* rowptr, const void* col, const void* etype,
                               const void* eid, const void* weight, const void* rel,
                               const void* x, const void* g, const void* out, void* dx,
                               long long num_rows, long long num_feat, int mul_op,
                               void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows <= 0 || num_feat <= 0 || num_feat % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(rel) || !aligned16(x) || !aligned16(g) || !aligned16(out) ||
      !aligned16(dx)) {
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
  const auto* gs = static_cast<const float4*>(g);
  const auto* os = static_cast<const float4*>(out);
  auto* d = static_cast<float4*>(dx);
  if (mul_op == 0) {
    rspmm_minmax_dx_kernel<0><<<grid, threads, 0, s>>>(rp, c, t, id, w, r, xs, gs, os, d,
                                                       width);
  } else {
    rspmm_minmax_dx_kernel<1><<<grid, threads, 0, s>>>(rp, c, t, id, w, r, xs, gs, os, d,
                                                       width);
  }
  return static_cast<int>(cudaGetLastError());
}

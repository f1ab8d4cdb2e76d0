// Min/max-aggregation relational SpMM, forward, for Hopper (sm_90a).
//
//   out[v, f] = max (or min) over the live edges e of row v of
//               (rel[type_e, f] op x[src_e, f]) * w[eid_e]
//   op = * (distmult, mul_op 0) or + (transe, mul_op 1); an edge is live when
//   its weight is not 0. A row with no live edge is -inf (max) or +inf (min).
//   f32 operands, f32 output.
//
// Replaces the TPU kernels ultra_tpu/ops/rspmm_pallas.py::_minmax_kernel and
// ultra_tpu/ops/rspmm_pallas_v2.py::_minmax_kernel_v2, which compute this
// function. They gather rows with one-hot matrix products, take a segmented
// Hillis-Steele scan within each chunk and fill with a finite +-1e38 so that
// 0 * fill stays 0 inside a matrix product; a GPU thread loads any row and
// holds +-inf, so none of that is carried over.
//
// The backward (rspmm_minmax_dx.cu, rspmm_minmax_drel.cu) routes the
// gradient to every edge whose recomputed message equals the saved output,
// so the message is written as (rel op x) * w with __fmul_rn / __fadd_rn:
// the same two roundings as the plain version and the backward kernels, and
// nothing nvcc may contract or reorder.
//
// What bounds it on an H100: bytes. Per edge and feature it does 3
// operations on two gathered 4-byte operands, far below the card's f32
// flops-per-byte balance, so the floor is each input read once (x, rel, w,
// the CSR) and out written once. The design is B1's (rspmm_sum_fwd.cu):
// - one block per (destination row, feature tile) walks the row's edges in
//   CSR order with the running extreme in registers: no atomics, and min and
//   max are exact, so the result does not depend on the order;
// - each thread owns 4 contiguous features and loads float4 (F % 4 == 0 and
//   16-byte aligned rel, x and out; anything else is refused);
// - an edge of weight 0 is skipped before its rows are loaded: the runtime
//   easy-edge mask zeroes weights of edges that are in the CSR;
// - as in B1, the rows with thousands of edges set the launch's length on
//   power-law graphs; splitting them is left to a later version.
// Offsets row*F are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int OP>
__device__ __forceinline__ float message(float r, float x, float w) {
  return __fmul_rn(OP == 0 ? __fmul_rn(r, x) : __fadd_rn(r, x), w);
}

template <bool IS_MIN>
__device__ __forceinline__ float extreme(float a, float b) {
  return IS_MIN ? fminf(a, b) : fmaxf(a, b);
}

// `width` is the row length in float4s (F / 4).
template <int OP, bool IS_MIN>
__global__ void rspmm_minmax_fwd_kernel(const int64_t* __restrict__ rowptr,
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
  const float fill = IS_MIN ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
  float4 acc = make_float4(fill, fill, fill, fill);
  for (int64_t e = begin; e < end; ++e) {
    const float w = __ldg(weight + __ldg(eid + e));
    if (w == 0.f) continue;
    const int64_t src = __ldg(col + e);
    const int64_t type = __ldg(etype + e);
    const float4 xv = __ldg(x + src * width + j);
    const float4 rv = __ldg(rel + type * width + j);
    acc.x = extreme<IS_MIN>(acc.x, message<OP>(rv.x, xv.x, w));
    acc.y = extreme<IS_MIN>(acc.y, message<OP>(rv.y, xv.y, w));
    acc.z = extreme<IS_MIN>(acc.z, message<OP>(rv.z, xv.z, w));
    acc.w = extreme<IS_MIN>(acc.w, message<OP>(rv.w, xv.w, w));
  }
  out[row * width + j] = acc;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int OP, bool IS_MIN>
void launch(dim3 grid, int threads, cudaStream_t s, const int64_t* rp, const int32_t* c,
            const int32_t* t, const int32_t* id, const float* w, const float4* r,
            const float4* xs, float4* o, int64_t width) {
  rspmm_minmax_fwd_kernel<OP, IS_MIN><<<grid, threads, 0, s>>>(rp, c, t, id, w, r, xs, o,
                                                               width);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rowptr: (num_rows+1) int64; col, etype, eid: (E) int32; weight: f32 indexed
// by eid; rel: (R, num_feat) f32; x: (N, num_feat) f32; out: (num_rows,
// num_feat) f32. is_min 1 takes the minimum, 0 the maximum. All contiguous on
// one device; indices are trusted to be in range. num_feat % 4 != 0 or a rel,
// x or out not 16-byte aligned returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int rspmm_minmax_fwd(const void* rowptr, const void* col, const void* etype,
                                const void* eid, const void* weight, const void* rel,
                                const void* x, void* out, long long num_rows,
                                long long num_feat, int mul_op, int is_min, void* stream) {
  if ((mul_op != 0 && mul_op != 1) || (is_min != 0 && is_min != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
    if (is_min) launch<0, true>(grid, threads, s, rp, c, t, id, w, r, xs, o, width);
    else launch<0, false>(grid, threads, s, rp, c, t, id, w, r, xs, o, width);
  } else {
    if (is_min) launch<1, true>(grid, threads, s, rp, c, t, id, w, r, xs, o, width);
    else launch<1, false>(grid, threads, s, rp, c, t, id, w, r, xs, o, width);
  }
  return static_cast<int>(cudaGetLastError());
}

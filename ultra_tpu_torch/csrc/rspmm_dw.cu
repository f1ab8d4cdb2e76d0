// Relational SpMM, edge-weight gradient, for Hopper (sm_90a).
//
//   d_w[eid_e] = sum_f route_{e,f} * (rel[type_e, f] op x[src_e, f]) * g[dst_e, f]
//   for every edge e of the destination-major CSR; op = * (distmult, mul_op 0)
//   or + (transe, mul_op 1). Sum aggregation (minmax 0): route is 1, so an
//   edge masked to weight 0 at run time still gets its true derivative. Min
//   and max (minmax 1): route is 1 where the edge is live (weight not 0) and
//   (rel op x) * w equals out[dst_e, f], the forward's saved output, else 0;
//   every tying edge gets its whole term. f32 operands, f32 accumulation, f32
//   output. Slots of the weight vector that are not in the CSR (the padding)
//   are not written: the wrapper zeroes the output first.
//
// Replaces the TPU kernel ultra_tpu/ops/rspmm_pallas.py::_dw_kernel (wrapper
// rspmm_pallas_dw), which gathers x, rel, g and out with one-hot matrix
// products per chunk of dst-sorted slots and writes one scalar per slot,
// mapped back to edge order by inv_slot; a GPU thread loads rows directly
// and writes d_w[eid] in place.
//
// Routing compares bit-identical values: the message is recomputed as
// (rel op x) * w with __fmul_rn / __fadd_rn, exactly as rspmm_minmax_fwd.cu
// and the plain versions write it, and `out` must be the forward's own
// output (+-inf on a row with no live edge, which no finite message equals).
//
// What bounds it on an H100: bytes. Per edge and feature it reads two
// gathered rows (rel and x) and does 3 operations (5 for min/max), far below
// the card's f32 flops-per-byte balance. The design:
// - one block per destination row: the row's g (and out) is loaded into
//   shared memory once and read by every edge of the row;
// - one warp per edge, lanes striding the features as float4 (F % 4 == 0 and
//   16-byte aligned rows; anything else is refused);
// - each edge's sum is reduced across the warp by a butterfly of shuffles in
//   a fixed order and written once by lane 0: no atomics, and two runs give
//   the same bits;
// - for min/max an edge of weight 0 is skipped before its rows are loaded;
// - as in B1, the rows with thousands of edges set the launch's length on
//   power-law graphs; splitting them is left to a later version.
// Offsets row*F are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kSharedLimit = 48 * 1024;  // bytes of dynamic shared memory

template <int OP>
__device__ __forceinline__ float unweighted(float r, float x) {
  return OP == 0 ? __fmul_rn(r, x) : __fadd_rn(r, x);
}

// the term of one feature: route * m * g
template <int OP, bool MINMAX>
__device__ __forceinline__ float term(float r, float x, float g, float w, float o) {
  const float m = unweighted<OP>(r, x);
  if (MINMAX && __fmul_rn(m, w) != o) return 0.f;
  return __fmul_rn(m, g);
}

// `width` is the row length in float4s (F / 4).
template <int OP, bool MINMAX>
__global__ void rspmm_dw_kernel(const int64_t* __restrict__ rowptr,
                                const int32_t* __restrict__ col,
                                const int32_t* __restrict__ etype,
                                const int32_t* __restrict__ eid,
                                const float* __restrict__ weight,
                                const float4* __restrict__ rel,
                                const float4* __restrict__ x,
                                const float4* __restrict__ g,
                                const float4* __restrict__ out,
                                float* __restrict__ dw,
                                int64_t width) {
  extern __shared__ float4 rows[];  // g[row], then out[row] for min/max
  const int64_t row = blockIdx.x;
  const int64_t begin = rowptr[row];
  const int64_t end = rowptr[row + 1];
  if (begin == end) return;  // the whole block leaves: no barrier is skipped
  float4* g_row = rows;
  float4* o_row = rows + width;
  for (int64_t j = threadIdx.x; j < width; j += blockDim.x) {
    g_row[j] = __ldg(g + row * width + j);
    if (MINMAX) o_row[j] = __ldg(out + row * width + j);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t e = begin + warp; e < end; e += kWarps) {  // uniform across a warp
    const int64_t id = __ldg(eid + e);
    const float w = __ldg(weight + id);
    float acc = 0.f;
    if (!MINMAX || w != 0.f) {
      const int64_t src = __ldg(col + e);
      const int64_t type = __ldg(etype + e);
      for (int64_t j = lane; j < width; j += 32) {
        const float4 rv = __ldg(rel + type * width + j);
        const float4 xv = __ldg(x + src * width + j);
        const float4 gv = g_row[j];
        const float4 ov = MINMAX ? o_row[j] : gv;
        acc += term<OP, MINMAX>(rv.x, xv.x, gv.x, w, ov.x);
        acc += term<OP, MINMAX>(rv.y, xv.y, gv.y, w, ov.y);
        acc += term<OP, MINMAX>(rv.z, xv.z, gv.z, w, ov.z);
        acc += term<OP, MINMAX>(rv.w, xv.w, gv.w, w, ov.w);
      }
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, offset);
    }
    if (lane == 0) dw[id] = acc;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int OP, bool MINMAX>
void launch(unsigned grid, size_t smem, cudaStream_t s, const int64_t* rp, const int32_t* c,
            const int32_t* t, const int32_t* id, const float* w, const float4* r,
            const float4* xs, const float4* gs, const float4* os, float* d, int64_t width) {
  rspmm_dw_kernel<OP, MINMAX><<<grid, kWarps * 32, smem, s>>>(rp, c, t, id, w, r, xs, gs, os,
                                                               d, width);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rowptr: (num_rows+1) int64 of the destination-major CSR; col (the source),
// etype, eid: (E) int32; weight, dw: f32 indexed by eid (dw zeroed by the
// caller); rel: (R, num_feat) f32; x: (N, num_feat) f32; g: (num_rows,
// num_feat) f32; out: (num_rows, num_feat) f32 for minmax 1, unread (may be
// null) for minmax 0. All contiguous on one device; indices are trusted to be
// in range. num_feat % 4 != 0, a row operand not 16-byte aligned, or rows of
// g (and out) over 48 KB return cudaErrorInvalidValue and launch nothing.
extern "C" int rspmm_dw(const void* rowptr, const void* col, const void* etype,
                        const void* eid, const void* weight, const void* rel, const void* x,
                        const void* g, const void* out, void* dw, long long num_rows,
                        long long num_feat, int mul_op, int minmax, void* stream) {
  if ((mul_op != 0 && mul_op != 1) || (minmax != 0 && minmax != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows <= 0 || num_feat <= 0 || num_feat % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(rel) || !aligned16(x) || !aligned16(g) || (minmax && !aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long width = num_feat / 4;
  const size_t smem = static_cast<size_t>(width) * sizeof(float4) * (minmax ? 2 : 1);
  if (smem > static_cast<size_t>(kSharedLimit)) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(num_rows);
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
  auto* d = static_cast<float*>(dw);
  if (mul_op == 0) {
    if (minmax) launch<0, true>(grid, smem, s, rp, c, t, id, w, r, xs, gs, os, d, width);
    else launch<0, false>(grid, smem, s, rp, c, t, id, w, r, xs, gs, os, d, width);
  } else {
    if (minmax) launch<1, true>(grid, smem, s, rp, c, t, id, w, r, xs, gs, os, d, width);
    else launch<1, false>(grid, smem, s, rp, c, t, id, w, r, xs, gs, os, d, width);
  }
  return static_cast<int>(cudaGetLastError());
}

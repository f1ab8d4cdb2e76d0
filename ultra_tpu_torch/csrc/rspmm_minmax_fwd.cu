// Min/max-aggregation relational SpMM, forward, for Hopper (sm_90a).
//
//   out[v, f] = max (or min) over the live edges e of row v of
//               (rel[type_e, f] op x[src_e, f]) * w[eid_e]
//   op = * (distmult, mul_op 0) or + (transe, mul_op 1); an edge is live when
//   its weight is not 0. A row with no live edge is -inf (max) or +inf (min).
//   f32 rel and x rows, or bf16 ones (one C entry point each), f32 weights,
//   f32 messages, f32 output.
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
// What bounds it on an H100. The floor is bytes, as for B1 (3 operations
// per edge and feature on two gathered 4-byte operands, no dense product,
// no part for the tensor cores): each input read once (x, rel, w, the CSR)
// and out written once. In practice the gathers' latency bounds it, and the
// design is B1's (rspmm_pieces.cuh, rspmm_sum_fwd.cu):
// - every row is cut into pieces of at most ROW_PIECE edges (graph.py),
//   each walked by its own group of threads, so the rows with thousands of
//   edges no longer set the launch's length; a second pass takes the
//   extreme of a long row's partial rows. A min or a max is exact, so the
//   output does not depend on how the row was cut: it equals the plain
//   version value for value, a row whose edges are all masked included;
// - the weights are staged in shared memory with the edges' indices, and
//   the x and rel loads of 4 edges go out before any edge's weight test, so
//   a masked edge (the runtime easy-edge mask zeroes weights of edges that
//   are in the CSR) no longer holds up the next edge's loads: its rows are
//   loaded and left out;
// - the f32 instance: each thread owns 4 contiguous features and loads them
//   as one float4 (F % 4 == 0, every row operand 16-byte aligned);
// - the bf16 instance takes B1's 8-feature walk (Gather8): each thread owns
//   8 features, so a bf16 row is one 16-byte load a thread, kept raw until
//   the fold and widened there, and at F=512 a block walks 4 pieces, not 2.
//   Its sizes are its own (kMinmax8...): 3 edges in flight at 4 blocks an
//   SM (64 registers, no spill), which beat B1's 6 at 3 (80, with spills)
//   and 2-8 edges at 2-4 blocks on the entity graph's and the uniform
//   graph's rows (PERF.md). It needs F % 8 == 0 and 16-byte aligned rows;
//   anything else is refused. Its message is the f32 message of the
//   widened values, each row's extreme taken in the f32 instance's order,
//   so it equals the f32 instance on those values, and the backward kernels
//   recompute it from the same bf16 rows bit for bit.

#include "rspmm_pieces.cuh"

namespace {

template <int OP>
__device__ __forceinline__ float message(float r, float x, float w) {
  return __fmul_rn(OP == 0 ? __fmul_rn(r, x) : __fadd_rn(r, x), w);
}

template <bool IS_MIN>
__device__ __forceinline__ float extreme(float a, float b) {
  return IS_MIN ? fminf(a, b) : fmaxf(a, b);
}

template <int OP, bool IS_MIN>
struct Extreme {
  __device__ static float4 init() {
    const float fill = IS_MIN ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
    return make_float4(fill, fill, fill, fill);
  }
  __device__ static void add(float4& acc, float w, const float4& r, const float4& x) {
    if (w == 0.f) return;
    acc.x = extreme<IS_MIN>(acc.x, message<OP>(r.x, x.x, w));
    acc.y = extreme<IS_MIN>(acc.y, message<OP>(r.y, x.y, w));
    acc.z = extreme<IS_MIN>(acc.z, message<OP>(r.z, x.z, w));
    acc.w = extreme<IS_MIN>(acc.w, message<OP>(r.w, x.w, w));
  }
  __device__ static void merge(float4& acc, const float4& p) {
    acc.x = extreme<IS_MIN>(acc.x, p.x);
    acc.y = extreme<IS_MIN>(acc.y, p.y);
    acc.z = extreme<IS_MIN>(acc.z, p.z);
    acc.w = extreme<IS_MIN>(acc.w, p.w);
  }
};

// The sizes of B3's 8-feature walk (its bf16 instance), timed on an H100
// (PERF.md, scripts/torch_row_piece_sweep.py --walk8): 3 edges in flight at
// 4 blocks an SM, 64 registers a thread.
constexpr int kMinmax8Unroll = 3, kMinmax8MinBlocks = 4;

// The walk of an instance: the 4-feature walk for f32 rows, the 8-feature
// walk with B3's own sizes for bf16 ones.
template <int OP, bool IS_MIN, class R, class X>
using Walk = std::conditional_t<
    std::is_same_v<R, float> && std::is_same_v<X, float>,
    pieces::Gather<Extreme<OP, IS_MIN>, R, X>,
    pieces::Gather8<Extreme<OP, IS_MIN>, R, X, kMinmax8Unroll, kMinmax8MinBlocks>>;

template <class R, class X>
int minmax_fwd(const void* piece_ptr, const void* piece_row, const void* piece_slot,
               const void* piece_order, const void* long_rows, const void* long_slot_ptr,
               const void* col, const void* etype, const void* eid, const void* weight,
               const void* rel, const void* x, void* partial, void* out, long long num_pieces,
               long long num_long, long long num_feat, int mul_op, int is_min, void* stream) {
  if ((mul_op != 0 && mul_op != 1) || (is_min != 0 && is_min != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!pieces::aligned16(rel) || !pieces::aligned16(x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pieces::Table t{
      static_cast<const int64_t*>(piece_ptr), static_cast<const int32_t*>(piece_row),
      static_cast<const int32_t*>(piece_slot), static_cast<const int32_t*>(piece_order),
      static_cast<const int32_t*>(long_rows), static_cast<const int64_t*>(long_slot_ptr),
      static_cast<float4*>(partial), static_cast<float4*>(out), num_pieces, num_long, 0};
  const pieces::GatherArgs<R, X> a{
      static_cast<const int32_t*>(col), static_cast<const int32_t*>(etype),
      static_cast<const int32_t*>(eid), static_cast<const float*>(weight),
      static_cast<const R*>(rel), static_cast<const X*>(x)};
  if (mul_op == 0) {
    return is_min ? pieces::launch<Walk<0, true, R, X>>(t, a, num_feat, stream)
                  : pieces::launch<Walk<0, false, R, X>>(t, a, num_feat, stream);
  }
  return is_min ? pieces::launch<Walk<1, true, R, X>>(t, a, num_feat, stream)
                : pieces::launch<Walk<1, false, R, X>>(t, a, num_feat, stream);
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). The operands are rspmm_sum_fwd's (rspmm_sum_fwd.cu), rel and x
// of the entry point's types; is_min 1 takes the minimum, 0 the maximum.
// num_feat % 4 != 0 (% 8 for rspmm_minmax_fwd_bf16_bf16) or a misaligned
// rel, x, out or partial returns cudaErrorInvalidValue and launches nothing.
PIECES_ENTRIES2(rspmm_minmax_fwd, minmax_fwd,
                (const void* piece_ptr, const void* piece_row, const void* piece_slot,
                 const void* piece_order, const void* long_rows, const void* long_slot_ptr,
                 const void* col, const void* etype, const void* eid, const void* weight,
                 const void* rel, const void* x, void* partial, void* out,
                 long long num_pieces, long long num_long, long long num_feat, int mul_op,
                 int is_min, void* stream),
                (piece_ptr, piece_row, piece_slot, piece_order, long_rows, long_slot_ptr, col,
                 etype, eid, weight, rel, x, partial, out, num_pieces, num_long, num_feat,
                 mul_op, is_min, stream))

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
// What bounds it on an H100. The floor is bytes: per edge and feature it
// does 3 flops on two gathered 4-byte operands and has no dense product, so
// the tensor cores have no part in it, and the least time is each input
// read once (x, rel, w, the CSR) and out written once. What bounds it in
// practice is the latency of the gathers:
// - each edge is a chain of dependent loads (its indices, then its weight,
//   then its x and rel rows), and on a power-law graph a row's edges are
//   many: FB15k-237's shape has rows of up to 3,031 edges against a mean of
//   37. A walk of one row by one block, edge after edge, let those rows set
//   the launch's length. Here every row is cut into pieces of at most
//   ROW_PIECE edges (graph.py) and each piece goes to its own group of
//   threads, the longest pieces first; a second pass adds a long row's
//   partial rows in slot order.
//   The sum within a piece, and over the pieces, runs in edge order, with
//   no atomics, so two runs give the same bits;
// - a group stages its piece's indices and weights in shared memory with
//   coalesced loads, then keeps the x and rel loads of 4 edges in flight
//   per thread, with 4 blocks of 256 threads on each SM (rspmm_pieces.cuh);
// - each thread owns 4 contiguous features and loads float4, so a group
//   reads every gathered row in 16-byte pieces, neighbouring threads on
//   neighbouring addresses, and a group is F/4 threads wide, so at F=64 no
//   lane idles. F must be a multiple of 4 and rel, x, out and the partial
//   rows 16-byte aligned (every width on the serving path is B*64); anything
//   else is refused, never run on a slower path;
// - an x row is still gathered once per incoming edge (E*F*4 bytes in all,
//   from L2 while x fits its 50 MB): the same edges with uniformly drawn
//   destinations, whose rows are all short, are this design's floor.
//   Keeping x resident is later work.

#include "rspmm_pieces.cuh"

namespace {

template <int OP>
__device__ __forceinline__ float op(float r, float x) {
  return OP == 0 ? r * x : r + x;
}

template <int OP>
struct Sum : pieces::Adds {
  __device__ static void add(float4& acc, float w, const float4& r, const float4& x) {
    acc.x += w * op<OP>(r.x, x.x);
    acc.y += w * op<OP>(r.y, x.y);
    acc.z += w * op<OP>(r.z, x.z);
    acc.w += w * op<OP>(r.w, x.w);
  }
};

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). The piece table (piece_ptr (P+1) int64, piece_row, piece_slot and
// piece_order (P) int32, long_rows (L) int32, long_slot_ptr (L+1) int64) is
// graph.py::build_csr's; col, etype, eid: (E) int32; weight: f32 indexed by
// eid; rel: (R, num_feat) f32; x: (N, num_feat) f32; partial: (slots,
// num_feat) f32 scratch; out: (rows, num_feat) f32. All contiguous on one
// device; indices are trusted to be in range. num_feat % 4 != 0 or a
// misaligned rel, x, out or partial returns cudaErrorInvalidValue and
// launches nothing.
extern "C" int rspmm_sum_fwd(const void* piece_ptr, const void* piece_row,
                             const void* piece_slot, const void* piece_order,
                             const void* long_rows,
                             const void* long_slot_ptr, const void* col, const void* etype,
                             const void* eid, const void* weight, const void* rel,
                             const void* x, void* partial, void* out, long long num_pieces,
                             long long num_long, long long num_feat, int mul_op,
                             void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!pieces::aligned16(rel) || !pieces::aligned16(x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pieces::Table t{
      static_cast<const int64_t*>(piece_ptr), static_cast<const int32_t*>(piece_row),
      static_cast<const int32_t*>(piece_slot), static_cast<const int32_t*>(piece_order),
      static_cast<const int32_t*>(long_rows), static_cast<const int64_t*>(long_slot_ptr),
      static_cast<float4*>(partial), static_cast<float4*>(out), num_pieces, num_long, 0};
  const pieces::GatherArgs a{
      static_cast<const int32_t*>(col), static_cast<const int32_t*>(etype),
      static_cast<const int32_t*>(eid), static_cast<const float*>(weight),
      static_cast<const float4*>(rel), static_cast<const float4*>(x)};
  return mul_op == 0 ? pieces::launch<pieces::Gather<Sum<0>>>(t, a, num_feat, stream)
                     : pieces::launch<pieces::Gather<Sum<1>>>(t, a, num_feat, stream);
}

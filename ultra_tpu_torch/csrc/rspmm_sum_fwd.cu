// Sum-aggregation relational SpMM, forward, for Hopper (sm_90a).
//
//   out[v, f] = sum over edges e of row v of  w[eid_e] * op(rel[type_e, f], x[src_e, f])
//   op = * (distmult, mul_op 0) or + (transe, mul_op 1); a row with no edges is 0.
//   f32 or bf16 rel and x rows (one C entry point per pair of types the
//   paths use, see below), f32 weights, f32 accumulation, f32 output.
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
//   coalesced loads, then keeps the x and rel loads of several edges in
//   flight per thread (the f32 instance 4, with 4 blocks of 256 threads on
//   each SM, or 3 where it walks x in slabs, below; the bf16 instances 6,
//   with 3 or 2: rspmm_pieces.cuh);
// - the f32 instance: each thread owns 4 contiguous features and loads
//   float4, so a group reads every gathered row in 16-byte pieces,
//   neighbouring threads on neighbouring addresses, and a group is F/4
//   threads wide, so at F=64 no lane idles. F must be a multiple of 4, out
//   and the partial rows 16-byte aligned and rel and x rows 16-byte aligned
//   (every width on the serving path is B*64); anything else is refused,
//   never run on a slower path;
// - the bf16 instances (compute_dtype: bfloat16) take the 8-feature walk:
//   each thread owns 8 features, so a bf16 row is one 16-byte load a thread
//   and a group is F/8 threads wide, and at F=512 a block walks 4 pieces
//   where the f32 instance walks 2. Halving the bytes buys little on its
//   own here, since x (or its slab, below) sits in L2 and the walk waits on
//   the loads' latency;
//   more edges in flight on an SM for the same registers is what the walk
//   gains, and 6 edges a round (not 4) shorten a piece's chain of rounds,
//   which sets the time on the relation graph, whose 474 rows are one
//   piece each. A bf16 row is kept as its raw 16 bytes until the fold and
//   widened there, one integer instruction a value; the f32 sums and their
//   order are the f32 instance's, so on the same (widened) values it gives
//   the same bits. They need F % 8 == 0 and every row operand 16-byte
//   aligned (every width on the paths is B*64, or B*16 in the tests), and
//   refuse anything else: nothing falls back to the 4-feature walk. The
//   input gradient (this kernel on the source-major CSR) takes bf16 rel rows
//   and the f32 output gradient as x: the (bf16, f32) instance, its x rows
//   two float4 loads a thread;
// - an x row is gathered once per incoming edge (E*F bytes of its type in
//   all). Where x fits a share of the L2 those gathers hit L2. Where it
//   does not (the ranking pass at F = 1,024: 504 MB of x), the walk goes
//   over x in slabs of columns: the caller's `tile` (ops/rspmm_cuda.py::
//   slab_tile) is then 32 units, a warp a group, and the tiles are the
//   grid's slowest dimension, so the blocks resident at once gather from
//   one slab of x (every row, the tile's columns: 63 MB in the ranking
//   pass), most of whose rows stay in L2 while they do; each tile reads the
//   piece table, the indices and the weights again. Narrower tiles, whose
//   slabs fit L2 whole, were slower on an H100 (PERF.md): their groups
//   share warps. A tile changes which threads add a feature, not the order
//   of the sums: the output is the same bits at every tile.

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

// The sizes of the f32 instance's walk in slabs (tiles of a warp; edges in
// flight, blocks an SM), timed on an H100 against 2-4 edges at 3-4 blocks
// (PERF.md, scripts/torch_slab_sweep.py): 3 edges in flight at 4 blocks.
// The walk in whole rows keeps the 4-feature walk's 4 and 4, which B3
// shares; the 8-feature walk keeps its own sizes in both.
constexpr int kSlabUnroll = 3, kSlabMinBlocks = 4;

// The walk of an instance: the 4-feature walk for f32 rows (at the slab
// sizes where SLAB), the 8-feature walk for bf16 ones.
template <int OP, class R, class X, bool SLAB>
using Walk = std::conditional_t<
    std::is_same_v<R, float> && std::is_same_v<X, float>,
    std::conditional_t<SLAB, pieces::Gather<Sum<OP>, R, X, kSlabUnroll, kSlabMinBlocks>,
                       pieces::Gather<Sum<OP>, R, X>>,
    pieces::Gather8<Sum<OP>, R, X>>;

template <int OP, class R, class X>
int launch(const pieces::Table& t, const pieces::GatherArgs<R, X>& a, long long num_feat,
           long long tile, void* stream) {
  using Whole = Walk<OP, R, X, false>;
  // tiles narrower than a whole row: the walk in slabs
  if (tile < pieces::group_size(num_feat / pieces::kFeatures<Whole>)) {
    return pieces::launch<Walk<OP, R, X, true>>(t, a, num_feat, tile, stream);
  }
  return pieces::launch<Whole>(t, a, num_feat, tile, stream);
}

template <class R, class X>
int sum_fwd(const void* piece_ptr, const void* piece_row, const void* piece_slot,
            const void* piece_order, const void* long_rows, const void* long_slot_ptr,
            const void* col, const void* etype, const void* eid, const void* weight,
            const void* rel, const void* x, void* partial, void* out, long long num_pieces,
            long long num_long, long long num_feat, int mul_op, long long tile, void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
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
  return mul_op == 0 ? launch<0>(t, a, num_feat, tile, stream)
                     : launch<1>(t, a, num_feat, tile, stream);
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). The piece table (piece_ptr (P+1) int64, piece_row, piece_slot and
// piece_order (P) int32, long_rows (L) int32, long_slot_ptr (L+1) int64) is
// graph.py::build_csr's; col, etype, eid: (E) int32; weight: f32 indexed by
// eid; rel: (R, num_feat) and x: (N, num_feat) of the entry point's types
// (rspmm_sum_fwd: f32 and f32; rspmm_sum_fwd_bf16_bf16: bf16 and bf16;
// rspmm_sum_fwd_bf16_f32, the input gradient's: bf16 and f32);
// partial: (slots, num_feat) f32 scratch; out: (rows, num_feat) f32. All
// contiguous on one device; indices are trusted to be in range. tile: the
// feature tile in accumulator units (num_feat / 4, or / 8 for the bf16
// instances, is the row's width): 8, 16, 32 or a multiple of 32 up to 256,
// at most the row's width rounded up as rspmm_pieces.cuh::group_size rounds
// it. num_feat % 4 != 0 (% 8 for the bf16 instances), another tile, or a
// misaligned rel, x, out or partial returns cudaErrorInvalidValue and
// launches nothing.
#define SUM_FWD_PARAMS                                                                   \
  (const void* piece_ptr, const void* piece_row, const void* piece_slot,                   \
   const void* piece_order, const void* long_rows, const void* long_slot_ptr,              \
   const void* col, const void* etype, const void* eid, const void* weight, const void* rel, \
   const void* x, void* partial, void* out, long long num_pieces, long long num_long,      \
   long long num_feat, int mul_op, long long tile, void* stream)
#define SUM_FWD_ARGS                                                                      \
  (piece_ptr, piece_row, piece_slot, piece_order, long_rows, long_slot_ptr, col, etype, eid, \
   weight, rel, x, partial, out, num_pieces, num_long, num_feat, mul_op, tile, stream)
PIECES_ENTRIES2(rspmm_sum_fwd, sum_fwd, SUM_FWD_PARAMS, SUM_FWD_ARGS)
PIECES_ENTRY(rspmm_sum_fwd_bf16_f32, sum_fwd, SUM_FWD_PARAMS, SUM_FWD_ARGS, pieces::bf16, float)

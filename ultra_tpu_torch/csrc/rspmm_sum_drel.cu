// Sum-aggregation relational SpMM, relation gradient, for Hopper (sm_90a).
//
//   d_rel[t, f] = sum over edges e of type t of  w[eid_e] * x[src_e, f] * g[dst_e, f]   (mul_op 0)
//   d_rel[t, f] = sum over edges e of type t of  w[eid_e] * g[dst_e, f]                 (mul_op 1)
//   a type with no edges is 0. f32 or bf16 x rows (rspmm_sum_drel and
//   rspmm_sum_drel_bf16), f32 g and weights, f32 accumulation, f32 output.
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
// written once. In practice the gathers' latency bounds it: each edge is a
// chain of dependent loads (its indices, then its weight and its x and g
// rows). The design is B1's walk (rspmm_pieces.cuh) with the type as the row:
// - the edges are sorted by type on the host (graph.py::build_segments) and
//   each type's run is cut into pieces of a length chosen from the graph's
//   edge and type counts (graph.py::segment_piece). The types are few and
//   skewed (4 on the relation graph, each a quarter of its edges; 474 on the
//   entity graph, the largest 23,200 of 544,230 edges), so one block per
//   type would leave most of the 132 SMs idle and let the largest type set
//   the launch's length;
// - pass 1: a group of threads per piece, the longest first, stages the
//   piece's weights, destinations and (mul) sources in shared memory with
//   coalesced loads and keeps the x and g loads of several edges in flight
//   per thread, adding the edges in order;
// - pass 2 combines each long type's partial rows in a fixed order: on the
//   relation graph a type has hundreds of pieces, so several groups share a
//   type, each adding every split-th partial, and the first adds their sums
//   in group order. No atomics anywhere, so two runs give the same bits;
// - the f32 instance: each thread owns 4 contiguous features and loads
//   float4, so a group reads every gathered row in whole pieces,
//   neighbouring threads on neighbouring addresses. F must be a multiple of
//   4, and x, g, partial and out 16-byte aligned; anything else is refused,
//   never run on a slower path. Within a type the edges keep destination
//   order, so the g rows of neighbouring edges repeat and hit L1/L2;
// - the bf16 instance (bf16 x, f32 g) takes the 8-feature walk
//   (rspmm_pieces.cuh, Drel8 below): each thread owns 8 features, an x row
//   is one 16-byte load a thread kept raw until the fold and a g row two
//   float4 loads, a group is F/8 threads wide, so a block walks twice the
//   pieces, twice the edges in flight on an SM, which is what hides the
//   gathers' latency; halving x's bytes alone bought nothing. The fold is
//   the f32 instance's on each half, and pass 2 splits a type's partials as
//   the f32 instance does, so on the same (widened) values it gives the
//   same bits. It needs F % 8 == 0 and x, g, partial and out 16-byte
//   aligned, and refuses anything else.

#include "rspmm_pieces.cuh"

namespace {

template <class X>
struct DrelArgs {
  const int32_t* src;
  const int32_t* dst;
  const int32_t* eid;
  const float* weight;  // indexed by eid
  const X* x;           // (N, 4 * width), not read for mul_op 1
  const float4* g;      // (V, width)
};

// An edge brings x[src] (mul_op 0) and g[dst]; staged words: the weight,
// dst and (mul_op 0) src.
template <int OP, class X>
struct Drel : pieces::Adds {
  using Args = DrelArgs<X>;
  using Row = pieces::NoRow;
  struct Edge {
    float4 x, g;
  };
  // B1's sizes (4 edges in flight, 4 blocks an SM); pass 2 gives a long
  // type up to 8 groups, fewer were slower on an H100 (PERF.md)
  static constexpr int kWords = OP == 0 ? 3 : 2, kUnroll = 4, kMinBlocks = 4, kSplit = 8;

  __device__ static Row row(const Args&, int64_t, int64_t, int64_t) { return {}; }
  __device__ static void stage(const Args& a, int64_t e, int32_t* s, int i) {
    s[i] = __float_as_int(__ldg(a.weight + __ldg(a.eid + e)));
    s[pieces::kStage + i] = __ldg(a.dst + e);
    if (OP == 0) s[2 * pieces::kStage + i] = __ldg(a.src + e);
  }
  __device__ static Edge load(const Args& a, const int32_t* s, int i, int64_t width,
                              int64_t j) {
    Edge e{};
    e.g = __ldg(a.g + static_cast<int64_t>(s[pieces::kStage + i]) * width + j);
    if (OP == 0) {
      e.x = pieces::load4(a.x, static_cast<int64_t>(s[2 * pieces::kStage + i]) * width + j);
    }
    return e;
  }
  __device__ static void add(float4& acc, const Row&, const int32_t* s, int i,
                             const Edge& e) {
    fold(acc, __int_as_float(s[i]), e.x, e.g);
  }
  // acc += w * x * g (mul_op 0) or w * g (mul_op 1), for 4 features
  __device__ static void fold(float4& acc, float w, const float4& x, const float4& g) {
    if (OP == 0) {
      acc.x += w * (x.x * g.x);
      acc.y += w * (x.y * g.y);
      acc.z += w * (x.z * g.z);
      acc.w += w * (x.w * g.w);
    } else {
      acc.x += w * g.x;
      acc.y += w * g.y;
      acc.z += w * g.z;
      acc.w += w * g.w;
    }
  }
};

// The sizes of B2's 8-feature walk, timed on an H100 (PERF.md,
// scripts/torch_row_piece_sweep.py --walk8): 6 edges in flight at 2 blocks
// an SM, as B1's input gradient, whose edges bring the same registers (a
// bf16 row's 16 bytes and an f32 g row's 32); pass 2 as Drel's.
constexpr int kDrel8Unroll = 6, kDrel8MinBlocks = 2;

// The bf16 instance's walk: Drel's stage, 8 features a thread, an x row
// (mul_op 0) as its raw 16 bytes and a g row as two float4s, each half
// folded in, widened, by Drel's fold.
template <int OP, class X>
struct Drel8 : Drel<OP, X> {
  using Args = DrelArgs<X>;
  using Row = pieces::NoRow;
  using Acc = pieces::f32x8;
  struct Edge {
    typename pieces::Raw8<X>::type x;
    pieces::f32x8 g;
  };
  static constexpr int kUnroll = kDrel8Unroll, kMinBlocks = kDrel8MinBlocks;

  __device__ static Edge load(const Args& a, const int32_t* s, int i, int64_t width,
                              int64_t j) {
    Edge e{};
    e.g = pieces::load8(reinterpret_cast<const float*>(a.g),
                        static_cast<int64_t>(s[pieces::kStage + i]) * width + j);
    if (OP == 0) {
      e.x = pieces::load8(a.x, static_cast<int64_t>(s[2 * pieces::kStage + i]) * width + j);
    }
    return e;
  }
  __device__ static void add(Acc& acc, const Row&, const int32_t* s, int i, const Edge& e) {
    const float w = __int_as_float(s[i]);
    Drel<OP, X>::fold(acc.lo, w, pieces::lo4(e.x), e.g.lo);
    Drel<OP, X>::fold(acc.hi, w, pieces::hi4(e.x), e.g.hi);
  }
  __device__ static Acc init() { return {Drel<OP, X>::init(), Drel<OP, X>::init()}; }
  __device__ static void merge(Acc& acc, const Acc& p) {
    Drel<OP, X>::merge(acc.lo, p.lo);
    Drel<OP, X>::merge(acc.hi, p.hi);
  }
};

// The walk of an instance: Drel for f32 x rows, Drel8 for bf16 ones.
template <int OP, class X>
using Walk = std::conditional_t<std::is_same_v<X, float>, Drel<OP, X>, Drel8<OP, X>>;

template <class X>
int sum_drel(const void* piece_ptr, const void* piece_row, const void* piece_slot,
             const void* piece_order, const void* long_rows, const void* long_slot_ptr,
             const void* src, const void* dst, const void* eid, const void* weight,
             const void* x, const void* g, void* partial, void* out, long long num_pieces,
             long long num_long, long long num_feat, int mul_op, void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!pieces::aligned16(x) || !pieces::aligned16(g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pieces::Table t{
      static_cast<const int64_t*>(piece_ptr), static_cast<const int32_t*>(piece_row),
      static_cast<const int32_t*>(piece_slot), static_cast<const int32_t*>(piece_order),
      static_cast<const int32_t*>(long_rows), static_cast<const int64_t*>(long_slot_ptr),
      static_cast<float4*>(partial), static_cast<float4*>(out), num_pieces, num_long, 0};
  const DrelArgs<X> a{static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
                      static_cast<const int32_t*>(eid), static_cast<const float*>(weight),
                      static_cast<const X*>(x), static_cast<const float4*>(g)};
  return mul_op == 0 ? pieces::launch<Walk<0, X>>(t, a, num_feat, stream)
                     : pieces::launch<Walk<1, X>>(t, a, num_feat, stream);
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). The piece table (piece_ptr (P+1) int64, piece_row (the type),
// piece_slot and piece_order (P) int32, long_rows (L) int32, long_slot_ptr
// (L+1) int64) is graph.py::build_segments'; src, dst, eid: (E) int32 in type
// order; weight: f32 indexed by eid; x: (N, num_feat), f32 (rspmm_sum_drel)
// or bf16 (rspmm_sum_drel_bf16), not read for mul_op 1; g: (V, num_feat)
// f32; partial: (slots, num_feat) f32 scratch (unread without long types);
// out: (num_types, num_feat) f32. All contiguous on one device; indices are
// trusted to be in range. num_feat % 4 != 0 (% 8 for rspmm_sum_drel_bf16)
// or a misaligned x, g, partial or out returns cudaErrorInvalidValue and
// launches nothing.
PIECES_ENTRIES1(rspmm_sum_drel, sum_drel,
                (const void* piece_ptr, const void* piece_row, const void* piece_slot,
                 const void* piece_order, const void* long_rows, const void* long_slot_ptr,
                 const void* src, const void* dst, const void* eid, const void* weight,
                 const void* x, const void* g, void* partial, void* out,
                 long long num_pieces, long long num_long, long long num_feat, int mul_op,
                 void* stream),
                (piece_ptr, piece_row, piece_slot, piece_order, long_rows, long_slot_ptr, src,
                 dst, eid, weight, x, g, partial, out, num_pieces, num_long, num_feat, mul_op,
                 stream))

// Min/max-aggregation relational SpMM, relation gradient, for Hopper (sm_90a).
//
//   d_rel[t, f] = sum over the live edges e of type t that are routed at f of
//                 w[eid_e] * (x[src_e, f] if mul_op 0 else 1) * g[dst_e, f]
//   where e is routed at f when (rel[t, f] op x[src_e, f]) * w[eid_e] equals
//   out[dst_e, f], the forward's saved output; every tying edge is routed. A
//   type with no routed edge is 0. f32 rel and x rows, or bf16 ones (one C
//   entry point each), f32 g, out and weights, f32 messages and
//   accumulation, f32 output.
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
// B2's walk (rspmm_pieces.cuh, rspmm_sum_drel.cu) over the type segments'
// pieces with B4's policy (rspmm_minmax_dx.cu) turned round:
// - the edges are sorted by type on the host and each type's run is cut into
//   pieces of graph.py::segment_piece edges (256 on the entity graph, 32 on
//   the relation graph), a group of threads a piece, the longest first, so
//   the few, skewed types spread over the whole card;
// - a piece's row brings rel[t] once; the group stages the piece's sources,
//   destinations and weights in shared memory, then keeps the x, out and g
//   loads of several edges in flight per thread. The loads go out before the
//   weight and route tests: a weight-0 edge (the runtime easy-edge mask) or
//   one that does not route folds in a selected 0, and nothing waits on a
//   test;
// - pass 2 adds a long type's partial rows in slot order, split over up to
//   8 groups (the relation graph's 4 types have hundreds of pieces each) in
//   a fixed order. No atomics anywhere, so two runs give the same bits;
// - the f32 instance: each thread owns 4 contiguous features and loads
//   float4 (F % 4 == 0, every row operand 16-byte aligned);
// - the bf16 instance walks 8 features a thread (MinMaxDrel8): rel[t] and
//   an edge's x row are one 16-byte load each, kept raw until the fold and
//   widened there, out and g two float4s each (20 registers an edge, as
//   B4's Dx8). It needs F % 8 == 0 and 16-byte aligned rows; anything else
//   is refused. It recomputes the message from the widened rel and x
//   values, as the forward's bf16 instance computed it, so ties route bit
//   for bit, and adds each feature's terms in the f32 instance's order, its
//   partials in pass 2 too: on the widened values it gives the f32
//   instance's bits.
// Within a type the edges keep destination order, so neighbouring edges
// share g and out rows.

#include "rspmm_pieces.cuh"

namespace {

template <int OP>
__device__ __forceinline__ float message(float r, float x, float w) {
  return __fmul_rn(OP == 0 ? __fmul_rn(r, x) : __fadd_rn(r, x), w);
}

// the routed term of one feature: w * (x if mul else 1) * g, or 0 for a
// weight-0 edge or one whose message is not the saved output
template <int OP>
__device__ __forceinline__ float term(float r, float x, float w, float o, float g) {
  const float t = OP == 0 ? __fmul_rn(__fmul_rn(w, x), g) : __fmul_rn(w, g);
  return w != 0.f && message<OP>(r, x, w) == o ? t : 0.f;
}

template <class R, class X>
struct MinMaxDrelArgs {
  const int32_t* src;
  const int32_t* dst;
  const int32_t* eid;
  const float* weight;  // indexed by eid
  const R* rel;         // (R, 4 * width)
  const X* x;           // (N, 4 * width)
  const float4* g;      // (V, width)
  const float4* out;    // (V, width), the forward's output
};

// The f32 instance's walk, 4 features a thread: an edge brings x[src],
// out[dst] and g[dst]; a piece's row brings rel[t].
template <int OP, class R, class X>
struct MinMaxDrel : pieces::Adds {
  using Args = MinMaxDrelArgs<R, X>;
  using Row = float4;
  struct Edge {
    float4 x, out, g;
  };
  // B4's f32 sizes (3 rows an edge, 2 edges in flight at 4 blocks an SM)
  // and B2's pass 2 (up to 8 groups a long type)
  static constexpr int kWords = 3, kUnroll = 2, kMinBlocks = 4, kSplit = 8;

  __device__ static Row row(const Args& a, int64_t t, int64_t width, int64_t j) {
    return pieces::load4(a.rel, t * width + j);
  }
  __device__ static void stage(const Args& a, int64_t e, int32_t* s, int i) {
    s[i] = __ldg(a.src + e);
    s[pieces::kStage + i] = __ldg(a.dst + e);
    s[2 * pieces::kStage + i] = __float_as_int(__ldg(a.weight + __ldg(a.eid + e)));
  }
  __device__ static Edge load(const Args& a, const int32_t* s, int i, int64_t width,
                              int64_t j) {
    const int64_t dst = static_cast<int64_t>(s[pieces::kStage + i]) * width + j;
    return {pieces::load4(a.x, static_cast<int64_t>(s[i]) * width + j), __ldg(a.out + dst),
            __ldg(a.g + dst)};
  }
  __device__ static void add(float4& acc, const Row& r, const int32_t* s, int i,
                             const Edge& e) {
    fold(acc, __int_as_float(s[2 * pieces::kStage + i]), r, e.x, e.out, e.g);
  }
  // acc += the routed terms of one edge, for 4 features
  __device__ static void fold(float4& acc, float w, const float4& r, const float4& x,
                              const float4& o, const float4& g) {
    acc.x += term<OP>(r.x, x.x, w, o.x, g.x);
    acc.y += term<OP>(r.y, x.y, w, o.y, g.y);
    acc.z += term<OP>(r.z, x.z, w, o.z, g.z);
    acc.w += term<OP>(r.w, x.w, w, o.w, g.w);
  }
};

// The sizes of B5's 8-feature walk (its bf16 instance), timed on an H100
// (PERF.md, scripts/torch_row_piece_sweep.py --walk8): 4 edges in flight at
// 2 blocks an SM (128 registers, none spilled) beat B4's 2 at 3 (20 bytes
// spilled) by 7% on the entity graph and 11% on the uniform one; 5 or
// more edges, or 3 or more blocks with more than 2 edges, spill and lose.
constexpr int kMinmaxDrel8Unroll = 4, kMinmaxDrel8MinBlocks = 2;

// The bf16 instance's walk: MinMaxDrel's stage and pass 2, 8 features a
// thread, rel[t] and an edge's x row as their raw 16 bytes, out and g as
// two float4s each (20 registers an edge), each half folded in, widened,
// by MinMaxDrel's fold.
template <int OP, class R, class X>
struct MinMaxDrel8 : MinMaxDrel<OP, R, X> {
  using Args = MinMaxDrelArgs<R, X>;
  using Acc = pieces::f32x8;
  using Row = typename pieces::Raw8<R>::type;
  struct Edge {
    typename pieces::Raw8<X>::type x;
    pieces::f32x8 out, g;
  };
  static constexpr int kUnroll = kMinmaxDrel8Unroll, kMinBlocks = kMinmaxDrel8MinBlocks;

  __device__ static Row row(const Args& a, int64_t t, int64_t width, int64_t j) {
    return pieces::load8(a.rel, t * width + j);
  }
  __device__ static Edge load(const Args& a, const int32_t* s, int i, int64_t width,
                              int64_t j) {
    const int64_t dst = static_cast<int64_t>(s[pieces::kStage + i]) * width + j;
    return {pieces::load8(a.x, static_cast<int64_t>(s[i]) * width + j),
            pieces::load8(reinterpret_cast<const float*>(a.out), dst),
            pieces::load8(reinterpret_cast<const float*>(a.g), dst)};
  }
  __device__ static void add(Acc& acc, const Row& r, const int32_t* s, int i, const Edge& e) {
    const float w = __int_as_float(s[2 * pieces::kStage + i]);
    MinMaxDrel<OP, R, X>::fold(acc.lo, w, pieces::lo4(r), pieces::lo4(e.x), e.out.lo, e.g.lo);
    MinMaxDrel<OP, R, X>::fold(acc.hi, w, pieces::hi4(r), pieces::hi4(e.x), e.out.hi, e.g.hi);
  }
  __device__ static Acc init() { return {pieces::Adds::init(), pieces::Adds::init()}; }
  __device__ static void merge(Acc& acc, const Acc& p) {
    pieces::Adds::merge(acc.lo, p.lo);
    pieces::Adds::merge(acc.hi, p.hi);
  }
};

// The walk of an instance: MinMaxDrel for f32 rows, MinMaxDrel8 for bf16 ones.
template <int OP, class R, class X>
using Walk = std::conditional_t<std::is_same_v<R, float> && std::is_same_v<X, float>,
                                MinMaxDrel<OP, R, X>, MinMaxDrel8<OP, R, X>>;

template <class R, class X>
int minmax_drel(const void* piece_ptr, const void* piece_row, const void* piece_slot,
                const void* piece_order, const void* long_rows, const void* long_slot_ptr,
                const void* src, const void* dst, const void* eid, const void* weight,
                const void* rel, const void* x, const void* g, const void* out, void* partial,
                void* d_rel, long long num_pieces, long long num_long, long long num_feat,
                int mul_op, void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!pieces::aligned16(rel) || !pieces::aligned16(x) || !pieces::aligned16(g) ||
      !pieces::aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pieces::Table t{
      static_cast<const int64_t*>(piece_ptr), static_cast<const int32_t*>(piece_row),
      static_cast<const int32_t*>(piece_slot), static_cast<const int32_t*>(piece_order),
      static_cast<const int32_t*>(long_rows), static_cast<const int64_t*>(long_slot_ptr),
      static_cast<float4*>(partial), static_cast<float4*>(d_rel), num_pieces, num_long, 0};
  const MinMaxDrelArgs<R, X> a{
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(eid), static_cast<const float*>(weight),
      static_cast<const R*>(rel),       static_cast<const X*>(x),
      static_cast<const float4*>(g),    static_cast<const float4*>(out)};
  return mul_op == 0 ? pieces::launch<Walk<0, R, X>>(t, a, num_feat, stream)
                     : pieces::launch<Walk<1, R, X>>(t, a, num_feat, stream);
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). The piece table (piece_ptr (P+1) int64, piece_row (the type),
// piece_slot and piece_order (P) int32, long_rows (L) int32, long_slot_ptr
// (L+1) int64) is graph.py::build_segments'; src, dst, eid: (E) int32 in type
// order; weight: f32 indexed by eid; rel: (num_types, num_feat) and x: (N,
// num_feat) of the entry point's types (rspmm_minmax_drel: f32 and f32;
// rspmm_minmax_drel_bf16_bf16: bf16 and bf16); g, out: (V, num_feat)
// f32; partial: (slots, num_feat) f32 scratch (unread without long types);
// d_rel: (num_types, num_feat) f32. All contiguous on one device; indices
// are trusted to be in range. num_feat % 4 != 0 (% 8 for
// rspmm_minmax_drel_bf16_bf16) or a misaligned row operand returns
// cudaErrorInvalidValue and launches nothing.
PIECES_ENTRIES2(rspmm_minmax_drel, minmax_drel,
                (const void* piece_ptr, const void* piece_row, const void* piece_slot,
                 const void* piece_order, const void* long_rows, const void* long_slot_ptr,
                 const void* src, const void* dst, const void* eid, const void* weight,
                 const void* rel, const void* x, const void* g, const void* out, void* partial,
                 void* d_rel, long long num_pieces, long long num_long, long long num_feat,
                 int mul_op, void* stream),
                (piece_ptr, piece_row, piece_slot, piece_order, long_rows, long_slot_ptr, src,
                 dst, eid, weight, rel, x, g, out, partial, d_rel, num_pieces, num_long,
                 num_feat, mul_op, stream))

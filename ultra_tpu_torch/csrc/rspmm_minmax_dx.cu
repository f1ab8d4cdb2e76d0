// Min/max-aggregation relational SpMM, input gradient, for Hopper (sm_90a).
//
//   d_x[u, f] = sum over the live edges e with src_e = u that are routed at f of
//               w[eid_e] * (rel[type_e, f] if mul_op 0 else 1) * g[dst_e, f]
//   where e is routed at f when (rel[type_e, f] op x[u, f]) * w[eid_e] equals
//   out[dst_e, f], the forward's saved output. Every tying edge is routed and
//   gets the whole gradient, not a share. A source with no routed edge is 0.
//   f32 rel and x rows, or bf16 ones (one C entry point each), f32 g, out
//   and weights, f32 messages and accumulation, f32 output.
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
// card's f32 flops-per-byte balance. In practice the gathers' latency bounds
// it, and the design is B1's walk (rspmm_pieces.cuh) on the source-major CSR:
// - every source row is cut into pieces of at most ROW_PIECE edges
//   (graph.py), each walked by its own group of threads, the longest first,
//   so the hub rows (out-degree in the thousands on FB15k-237's shape, whose
//   inverse edges make out-degree as skewed as in-degree) no longer set the
//   launch's length; a second pass adds a long row's partial rows in slot
//   order. No atomics, so two runs give the same bits;
// - a group stages its piece's destinations, types and weights in shared
//   memory, then keeps the rel, out and g loads of several edges in flight
//   per thread. The loads go out before the edge's weight and route tests:
//   a weight-0 edge (the runtime easy-edge mask zeroes weights of edges
//   that are in the CSR) or one that does not route folds in a selected 0,
//   and nothing waits on a test;
// - x[u]'s tile is loaded once per piece, not once per edge;
// - the f32 instance: each thread owns 4 contiguous features and loads
//   float4 (F % 4 == 0, every row operand 16-byte aligned);
// - the bf16 instance walks 8 features a thread (Dx8): x[u] and an edge's
//   rel row are one 16-byte load each, kept raw until the fold and widened
//   there, out and g two float4s each. Its edges bring 20 registers for 8
//   features where Dx's bring 12 for 4, and the f32 out and g rows are 4 of
//   an edge's 5 KB at F=512, so the wider walk gains little here: 2 edges
//   in flight at 3 blocks an SM (80 registers) beat the 4-feature bf16
//   walk by 2% on the entity graph, where 4-8 edges at 1-2 blocks and 2-4
//   at 4 were slower than it (PERF.md). It needs F % 8 == 0 and 16-byte
//   aligned rows; anything else is refused. It recomputes the message from
//   the widened rel and x values, as the forward's bf16 instance computed
//   it, so ties route bit for bit, and adds each feature's terms in the f32
//   instance's order: on the widened values it gives the f32 instance's
//   bits.

#include "rspmm_pieces.cuh"

namespace {

template <int OP>
__device__ __forceinline__ float message(float r, float x, float w) {
  return __fmul_rn(OP == 0 ? __fmul_rn(r, x) : __fadd_rn(r, x), w);
}

// the routed term of one feature: w * (r if mul else 1) * g, or 0 for a
// weight-0 edge or one whose message is not the saved output
template <int OP>
__device__ __forceinline__ float term(float r, float x, float w, float o, float g) {
  const float t = OP == 0 ? __fmul_rn(__fmul_rn(w, r), g) : __fmul_rn(w, g);
  return w != 0.f && message<OP>(r, x, w) == o ? t : 0.f;
}

template <class R, class X>
struct DxArgs {
  const int32_t* col;  // the destination
  const int32_t* etype;
  const int32_t* eid;
  const float* weight;  // indexed by eid
  const R* rel;         // (R, 4 * width)
  const X* x;           // (N, 4 * width)
  const float4* g;      // (V, width)
  const float4* out;    // (V, width), the forward's output
};

// The f32 instance's walk, 4 features a thread: an edge brings rel[etype],
// out[dst] and g[dst]; a piece's row brings x[u].
template <int OP, class R, class X>
struct Dx : pieces::Adds {
  using Args = DxArgs<R, X>;
  using Row = float4;
  struct Edge {
    float4 rel, out, g;
  };
  // 2 edges (6 rows) in flight at 4 blocks an SM: 3 or 4 edges spill under
  // the 64 registers that 4 blocks allow, and 3 blocks or 2 with more edges
  // in flight were no faster on an H100 (PERF.md)
  static constexpr int kWords = 3, kUnroll = 2, kMinBlocks = 4, kSplit = 1;

  __device__ static Row row(const Args& a, int64_t u, int64_t width, int64_t j) {
    return pieces::load4(a.x, u * width + j);
  }
  __device__ static void stage(const Args& a, int64_t e, int32_t* s, int i) {
    s[i] = __ldg(a.col + e);
    s[pieces::kStage + i] = __ldg(a.etype + e);
    s[2 * pieces::kStage + i] = __float_as_int(__ldg(a.weight + __ldg(a.eid + e)));
  }
  __device__ static Edge load(const Args& a, const int32_t* s, int i, int64_t width,
                              int64_t j) {
    const int64_t dst = static_cast<int64_t>(s[i]) * width + j;
    return {pieces::load4(a.rel, static_cast<int64_t>(s[pieces::kStage + i]) * width + j),
            __ldg(a.out + dst), __ldg(a.g + dst)};
  }
  __device__ static void add(float4& acc, const Row& x, const int32_t* s, int i,
                             const Edge& e) {
    fold(acc, __int_as_float(s[2 * pieces::kStage + i]), e.rel, x, e.out, e.g);
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

// The sizes of B4's 8-feature walk (its bf16 instance), timed on an H100
// (PERF.md, scripts/torch_row_piece_sweep.py --walk8): 2 edges in flight at
// 3 blocks an SM, 80 registers a thread (20 bytes spilled); 3-4 edges at 2
// blocks (116-128 registers, none spilled) were 3-4% slower.
constexpr int kDx8Unroll = 2, kDx8MinBlocks = 3;

// The bf16 instance's walk: Dx's stage, 8 features a thread, x[u] and an
// edge's rel row as their raw 16 bytes, out and g as two float4s each (20
// registers an edge), each half folded in, widened, by Dx's fold.
template <int OP, class R, class X>
struct Dx8 : Dx<OP, R, X> {
  using Args = DxArgs<R, X>;
  using Acc = pieces::f32x8;
  using Row = typename pieces::Raw8<X>::type;
  struct Edge {
    typename pieces::Raw8<R>::type rel;
    pieces::f32x8 out, g;
  };
  static constexpr int kUnroll = kDx8Unroll, kMinBlocks = kDx8MinBlocks;

  __device__ static Row row(const Args& a, int64_t u, int64_t width, int64_t j) {
    return pieces::load8(a.x, u * width + j);
  }
  __device__ static Edge load(const Args& a, const int32_t* s, int i, int64_t width,
                              int64_t j) {
    const int64_t dst = static_cast<int64_t>(s[i]) * width + j;
    return {pieces::load8(a.rel, static_cast<int64_t>(s[pieces::kStage + i]) * width + j),
            pieces::load8(reinterpret_cast<const float*>(a.out), dst),
            pieces::load8(reinterpret_cast<const float*>(a.g), dst)};
  }
  __device__ static void add(Acc& acc, const Row& x, const int32_t* s, int i, const Edge& e) {
    const float w = __int_as_float(s[2 * pieces::kStage + i]);
    Dx<OP, R, X>::fold(acc.lo, w, pieces::lo4(e.rel), pieces::lo4(x), e.out.lo, e.g.lo);
    Dx<OP, R, X>::fold(acc.hi, w, pieces::hi4(e.rel), pieces::hi4(x), e.out.hi, e.g.hi);
  }
  __device__ static Acc init() { return {pieces::Adds::init(), pieces::Adds::init()}; }
  __device__ static void merge(Acc& acc, const Acc& p) {
    pieces::Adds::merge(acc.lo, p.lo);
    pieces::Adds::merge(acc.hi, p.hi);
  }
};

// The walk of an instance: Dx for f32 rows, Dx8 for bf16 ones.
template <int OP, class R, class X>
using Walk = std::conditional_t<std::is_same_v<R, float> && std::is_same_v<X, float>,
                                Dx<OP, R, X>, Dx8<OP, R, X>>;

template <class R, class X>
int minmax_dx(const void* piece_ptr, const void* piece_row, const void* piece_slot,
              const void* piece_order, const void* long_rows, const void* long_slot_ptr,
              const void* col, const void* etype, const void* eid, const void* weight,
              const void* rel, const void* x, const void* g, const void* out, void* partial,
              void* dx, long long num_pieces, long long num_long, long long num_feat,
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
      static_cast<float4*>(partial), static_cast<float4*>(dx), num_pieces, num_long, 0};
  const DxArgs<R, X> a{static_cast<const int32_t*>(col), static_cast<const int32_t*>(etype),
                       static_cast<const int32_t*>(eid), static_cast<const float*>(weight),
                       static_cast<const R*>(rel), static_cast<const X*>(x),
                       static_cast<const float4*>(g), static_cast<const float4*>(out)};
  return mul_op == 0 ? pieces::launch<Walk<0, R, X>>(t, a, num_feat, stream)
                     : pieces::launch<Walk<1, R, X>>(t, a, num_feat, stream);
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). The piece table (piece_ptr (P+1) int64, piece_row, piece_slot
// and piece_order (P) int32, long_rows (L) int32, long_slot_ptr (L+1) int64)
// is graph.py::build_csr's for the source-major CSR; col (the destination),
// etype, eid: (E) int32; weight: f32 indexed by eid; rel: (R, num_feat) and
// x: (N, num_feat) of the entry point's types (rspmm_minmax_dx: f32 and f32;
// rspmm_minmax_dx_bf16_bf16: bf16 and bf16); g, out: (V, num_feat) f32;
// partial: (slots, num_feat) f32 scratch (unread without long rows); dx:
// (N, num_feat) f32. All contiguous on one device; indices are trusted to
// be in range. num_feat % 4 != 0 (% 8 for rspmm_minmax_dx_bf16_bf16) or a
// misaligned row operand returns cudaErrorInvalidValue and launches nothing.
PIECES_ENTRIES2(rspmm_minmax_dx, minmax_dx,
                (const void* piece_ptr, const void* piece_row, const void* piece_slot,
                 const void* piece_order, const void* long_rows, const void* long_slot_ptr,
                 const void* col, const void* etype, const void* eid, const void* weight,
                 const void* rel, const void* x, const void* g, const void* out, void* partial,
                 void* dx, long long num_pieces, long long num_long, long long num_feat,
                 int mul_op, void* stream),
                (piece_ptr, piece_row, piece_slot, piece_order, long_rows, long_slot_ptr, col,
                 etype, eid, weight, rel, x, g, out, partial, dx, num_pieces, num_long,
                 num_feat, mul_op, stream))

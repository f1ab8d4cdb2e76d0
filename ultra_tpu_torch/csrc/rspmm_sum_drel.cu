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
// - each thread owns 4 contiguous features and loads float4 (or, for bf16 x
//   rows, 4 values in 8 bytes widened to f32 in registers), so a group
//   reads every gathered row in whole pieces, neighbouring threads on
//   neighbouring addresses. F must be a multiple of 4, g, partial and out
//   16-byte aligned and x 16-byte (f32) or 8-byte (bf16); anything else is
//   refused, never run on a slower path. Within a type the edges keep
//   destination order, so the g rows of neighbouring edges repeat and hit
//   L1/L2.

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
    const float w = __int_as_float(s[i]);
    if (OP == 0) {
      acc.x += w * (e.x.x * e.g.x);
      acc.y += w * (e.x.y * e.g.y);
      acc.z += w * (e.x.z * e.g.z);
      acc.w += w * (e.x.w * e.g.w);
    } else {
      acc.x += w * e.g.x;
      acc.y += w * e.g.y;
      acc.z += w * e.g.z;
      acc.w += w * e.g.w;
    }
  }
};

template <class X>
int sum_drel(const void* piece_ptr, const void* piece_row, const void* piece_slot,
             const void* piece_order, const void* long_rows, const void* long_slot_ptr,
             const void* src, const void* dst, const void* eid, const void* weight,
             const void* x, const void* g, void* partial, void* out, long long num_pieces,
             long long num_long, long long num_feat, int mul_op, void* stream) {
  if (mul_op != 0 && mul_op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!pieces::aligned_rows<X>(x) || !pieces::aligned16(g)) {
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
  return mul_op == 0 ? pieces::launch<Drel<0, X>>(t, a, num_feat, stream)
                     : pieces::launch<Drel<1, X>>(t, a, num_feat, stream);
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
// trusted to be in range. num_feat % 4 != 0 or a misaligned x, g, partial
// or out returns cudaErrorInvalidValue and launches nothing.
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

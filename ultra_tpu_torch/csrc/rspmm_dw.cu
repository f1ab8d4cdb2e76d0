// Relational SpMM, edge-weight gradient, for Hopper (sm_90a).
//
//   d_w[eid_e] = sum_f route_{e,f} * (rel[type_e, f] op x[src_e, f]) * g[dst_e, f]
//   for every edge e of the destination-major CSR; op = * (distmult, mul_op 0)
//   or + (transe, mul_op 1). Sum aggregation (minmax 0): route is 1, so an
//   edge masked to weight 0 at run time still gets its true derivative. Min
//   and max (minmax 1): route is 1 where the edge is live (weight not 0) and
//   (rel op x) * w equals out[dst_e, f], the forward's saved output, else 0;
//   every tying edge gets its whole term. f32 rel and x rows, or bf16 ones
//   (one C entry point each), f32 g, out and weights, f32 messages and
//   accumulation, f32 output. Slots of the weight vector that are not in the CSR (the padding)
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
// the card's f32 flops-per-byte balance. In practice the gathers' latency
// bounds it, and the design walks the CSR's piece table as B1 does
// (rspmm_pieces.cuh), with a pass of its own, since its output is one value
// an edge and not a row:
// - a group of threads takes one part of a piece of at most ROW_PIECE
//   edges, the longest pieces first, so a hub row (3,031 edges on
//   FB15k-237's shape) spreads over many groups instead of setting the
//   launch's length. The edges' sums are independent, so a piece may be
//   split evenly over `parts` groups, which shortens the longest walk
//   further;
// - the group is at most one warp: each lane holds K float4s of the row
//   (F <= 128 * K), the piece's g row (and out row for min/max) loaded into
//   registers once; a wider row is walked in passes of 128 * K features,
//   each edge's partial sums kept in shared memory between them;
// - the group stages its piece's sources, types, ids and (min/max) weights
//   in shared memory with coalesced loads, then keeps the rel and x loads
//   of several edges in flight per thread before it folds any of them in;
//   the weight and route tests come after the loads, as a selected 0;
// - each edge's sum over the features is reduced across the group by a
//   butterfly of shuffles in a fixed order and written once, to d_w[eid], by
//   the group's first lane. An edge lies in exactly one part of one piece,
//   so there is no second pass and no atomic: two runs give the same bits;
// - the f32 instance loads float4s, neighbouring lanes on neighbouring
//   addresses (F % 4 == 0, every row operand 16-byte aligned);
// - the bf16 instance runs a pass of its own, 8 features a lane
//   (dw8_kernel): an edge's rel and x rows come in as one 16-byte load each,
//   kept raw until the fold and widened there (8 registers an edge for the
//   two rows, where the f32 instance's two float4s take 8 for 4 features),
//   and the piece's g (and out) row as two float4s a lane, once a pass.
//   Its lane l takes the f32 instance's lanes 2l and 2l + 1 (their K
//   float4s each), keeps their two sums apart and runs the f32 instance's
//   butterfly on both, one offset down, then adds them as its offset 1
//   did: float addition commutes, so every edge's sum has the f32
//   instance's bits on the widened values, at every F. A group is half as
//   wide and stages a part's 64 edges and only the words it reads (the sum
//   needs no weight): a block of 256 threads walks 32 parts at F=64 where
//   the f32 instance's walks 16, each in 3/8 of its shared memory (1/2 for
//   min/max). It needs F % 8 == 0 and 16-byte aligned rows; anything else
//   is refused. It recomputes the message from the widened values, as B3's
//   bf16 instance computed it.
// Offsets row*F are 64-bit.

#include "rspmm_pieces.cuh"

namespace {

constexpr int kWords = 4;       // staged per edge: source, type, eid, weight (min/max)
constexpr int kMaxGroups = 16;  // groups a block holds at most (shared memory)

template <int OP>
__device__ __forceinline__ float unweighted(float r, float x) {
  return OP == 0 ? __fmul_rn(r, x) : __fadd_rn(r, x);
}

// the term of one feature: route * m * g
template <int OP, bool MINMAX>
__device__ __forceinline__ float term(float r, float x, float g, float w, float o) {
  const float m = unweighted<OP>(r, x);
  const float t = __fmul_rn(m, g);
  return !MINMAX || (w != 0.f && __fmul_rn(m, w) == o) ? t : 0.f;
}

template <int OP, bool MINMAX>
__device__ __forceinline__ float terms(const float4& r, const float4& x, const float4& g,
                                       float w, const float4& o) {
  return term<OP, MINMAX>(r.x, x.x, g.x, w, o.x) + term<OP, MINMAX>(r.y, x.y, g.y, w, o.y) +
         term<OP, MINMAX>(r.z, x.z, g.z, w, o.z) + term<OP, MINMAX>(r.w, x.w, g.w, w, o.w);
}

template <class R, class X>
struct DwArgs {
  const int32_t* col;  // the source
  const int32_t* etype;
  const int32_t* eid;
  const float* weight;  // indexed by eid
  const R* rel;         // (R, F)
  const X* x;           // (N, F)
  const float4* g;      // (V, F / 4)
  const float4* out;    // (V, F / 4) for min/max, else unread
  float* dw;            // indexed by eid
};

// One group of `group` lanes (8, 16 or 32) a part of a piece (`parts` parts
// a piece, of as near equal lengths as may be); lane l holds features
// base + l + k * group, k < K, of the pass over the row that starts at base.
// Shared memory per group: kWords * kStage staged words, then, where the
// row takes more than one pass, kStage partial sums.
template <int OP, bool MINMAX, int K, class R, class X>
__global__ void __launch_bounds__(pieces::kBlock, K == 1 ? 4 : 2)
    dw_kernel(const pieces::Table t, const DwArgs<R, X> a, int group, int parts, int passes) {
  constexpr int kStage = pieces::kStage;
  constexpr int kUnroll = 4 / K;  // edges whose loads a thread keeps in flight
  extern __shared__ int32_t staged[];
  const int groups = blockDim.x / group;
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * groups + g;
  if (k >= t.num_pieces * parts) return;  // the whole group leaves: no barrier is skipped
  const int64_t piece = t.piece_order[k / parts];
  const int64_t first = t.piece_ptr[piece];
  const int64_t span = (t.piece_ptr[piece + 1] - first + parts - 1) / parts;
  const int64_t begin = first + (k % parts) * span;
  const int64_t end = begin + span < t.piece_ptr[piece + 1] ? begin + span : t.piece_ptr[piece + 1];
  const int64_t len = end - begin;
  if (len <= 0) return;
  int32_t* s = staged + kWords * kStage * g;
  float* sums = reinterpret_cast<float*>(staged + kWords * kStage * groups) + kStage * g;
  const unsigned lanes = (group == 32 ? 0xffffffffu : (1u << group) - 1)
                         << ((threadIdx.x & 31) & ~(group - 1));
  const int64_t row = static_cast<int64_t>(t.piece_row[piece]) * t.width;
  for (int64_t base = 0; base < len; base += kStage) {
    const int n = len - base < kStage ? static_cast<int>(len - base) : kStage;
    pieces::group_sync(g, group);  // the group is done with the last stage
    for (int i = lane; i < n; i += group) {
      const int64_t e = begin + base + i;
      const int32_t id = __ldg(a.eid + e);
      s[i] = __ldg(a.col + e);
      s[kStage + i] = __ldg(a.etype + e);
      s[2 * kStage + i] = id;
      if (MINMAX) s[3 * kStage + i] = __float_as_int(__ldg(a.weight + id));
    }
    pieces::group_sync(g, group);
    for (int pass = 0; pass < passes; ++pass) {
      int64_t j[K];
      float4 g_row[K], o_row[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        j[c] = static_cast<int64_t>(pass * K + c) * group + lane;
        if (j[c] < t.width) {
          g_row[c] = __ldg(a.g + row + j[c]);
          if (MINMAX) o_row[c] = __ldg(a.out + row + j[c]);
        }
      }
      for (int i = 0; i < n; i += kUnroll) {
        float4 rv[kUnroll][K], xv[kUnroll][K];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u >= n) continue;
          const int64_t r = static_cast<int64_t>(s[kStage + i + u]) * t.width;
          const int64_t src = static_cast<int64_t>(s[i + u]) * t.width;
#pragma unroll
          for (int c = 0; c < K; ++c) {
            if (j[c] < t.width) {
              rv[u][c] = pieces::load4(a.rel, r + j[c]);
              xv[u][c] = pieces::load4(a.x, src + j[c]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u >= n) continue;  // the same for every lane of the group
          const float w = MINMAX ? __int_as_float(s[3 * kStage + i + u]) : 0.f;
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < K; ++c) {
            if (j[c] < t.width) {
              acc += terms<OP, MINMAX>(rv[u][c], xv[u][c], g_row[c], w,
                                       MINMAX ? o_row[c] : g_row[c]);
            }
          }
          for (int offset = group / 2; offset > 0; offset >>= 1) {
            acc += __shfl_xor_sync(lanes, acc, offset);
          }
          if (lane == 0) {
            const float sum = pass == 0 ? acc : sums[i + u] + acc;
            if (pass == passes - 1) {
              a.dw[s[2 * kStage + i + u]] = sum;
            } else {
              sums[i + u] = sum;
            }
          }
        }
      }
    }
  }
}

// The sizes of B6's 8-feature pass (its bf16 instance; edges whose row
// loads a lane keeps in flight where it holds one unit of the row, blocks
// of 256 threads an SM must hold), timed on an H100 (PERF.md,
// scripts/torch_row_piece_sweep.py --walk8): 4 edges at 3 blocks (78
// registers for the sum) beat the f32 instance's 4 at 4 (which spill here)
// by 12% on the entity graph; 3-4 edges at 2-3 blocks were within 1.5% of
// it, 5-6 edges 6-7% slower, 2 edges or 4-5 blocks 9-42%. Staging 4 edges
// a lane at once, its loads issued together, was no faster. A wider row, K
// units a lane, keeps kDw8Unroll / K edges in flight at 2 blocks, as the
// f32 instance.
constexpr int kDw8Unroll = 4, kDw8MinBlocks = 3;
constexpr int kStage8 = 64;  // edges staged at once: a part of a piece (DW_PARTS 2)

// dw_kernel's pass for bf16 rows: lane l of a group of `group` lanes (half
// the f32 instance's) holds units base + l + k * group, k < K, of 8
// features each, where the f32 instance's lanes 2l and 2l + 1 hold the
// same features 4 apiece; `t.width` counts units of 8. Shared memory per
// group: kWords8 * kStage8 staged words, then, where the row takes more
// than one pass, kStage8 partial sums.
template <int OP, bool MINMAX, int K, class R, class X>
__global__ void __launch_bounds__(pieces::kBlock, K == 1 ? kDw8MinBlocks : 2)
    dw8_kernel(const pieces::Table t, const DwArgs<R, X> a, int group, int parts, int passes) {
  constexpr int kWords8 = MINMAX ? 4 : 3;  // source, type, eid, and the weight for min/max
  constexpr int kUnroll = kDw8Unroll / K > 0 ? kDw8Unroll / K : 1;
  extern __shared__ int32_t staged[];
  const int groups = blockDim.x / group;
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * groups + g;
  if (k >= t.num_pieces * parts) return;  // the whole group leaves: no barrier is skipped
  const int64_t piece = t.piece_order[k / parts];
  const int64_t first = t.piece_ptr[piece];
  const int64_t span = (t.piece_ptr[piece + 1] - first + parts - 1) / parts;
  const int64_t begin = first + (k % parts) * span;
  const int64_t end = begin + span < t.piece_ptr[piece + 1] ? begin + span : t.piece_ptr[piece + 1];
  const int64_t len = end - begin;
  if (len <= 0) return;
  int32_t* s = staged + kWords8 * kStage8 * g;
  float* sums = reinterpret_cast<float*>(staged + kWords8 * kStage8 * groups) + kStage8 * g;
  const unsigned lanes = (group == 32 ? 0xffffffffu : (1u << group) - 1)
                         << ((threadIdx.x & 31) & ~(group - 1));
  const int64_t row = static_cast<int64_t>(t.piece_row[piece]) * t.width;
  const float* g_rows = reinterpret_cast<const float*>(a.g);
  const float* out_rows = reinterpret_cast<const float*>(a.out);
  for (int64_t base = 0; base < len; base += kStage8) {
    const int n = len - base < kStage8 ? static_cast<int>(len - base) : kStage8;
    pieces::group_sync(g, group);  // the group is done with the last stage
    for (int i = lane; i < n; i += group) {
      const int64_t e = begin + base + i;
      const int32_t id = __ldg(a.eid + e);
      s[i] = __ldg(a.col + e);
      s[kStage8 + i] = __ldg(a.etype + e);
      s[2 * kStage8 + i] = id;
      if (MINMAX) s[3 * kStage8 + i] = __float_as_int(__ldg(a.weight + id));
    }
    pieces::group_sync(g, group);
    for (int pass = 0; pass < passes; ++pass) {
      int64_t j[K];
      pieces::f32x8 g_row[K], o_row[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        j[c] = static_cast<int64_t>(pass * K + c) * group + lane;
        if (j[c] < t.width) {
          g_row[c] = pieces::load8(g_rows, row + j[c]);
          if (MINMAX) o_row[c] = pieces::load8(out_rows, row + j[c]);
        }
      }
      for (int i = 0; i < n; i += kUnroll) {
        typename pieces::Raw8<R>::type rv[kUnroll][K];
        typename pieces::Raw8<X>::type xv[kUnroll][K];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u >= n) continue;
          const int64_t r = static_cast<int64_t>(s[kStage8 + i + u]) * t.width;
          const int64_t src = static_cast<int64_t>(s[i + u]) * t.width;
#pragma unroll
          for (int c = 0; c < K; ++c) {
            if (j[c] < t.width) {
              rv[u][c] = pieces::load8(a.rel, r + j[c]);
              xv[u][c] = pieces::load8(a.x, src + j[c]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u >= n) continue;  // the same for every lane of the group
          const float w = MINMAX ? __int_as_float(s[3 * kStage8 + i + u]) : 0.f;
          float lo = 0.f, hi = 0.f;  // the f32 instance's lanes 2l and 2l + 1
#pragma unroll
          for (int c = 0; c < K; ++c) {
            if (j[c] < t.width) {
              lo += terms<OP, MINMAX>(pieces::lo4(rv[u][c]), pieces::lo4(xv[u][c]), g_row[c].lo,
                                      w, MINMAX ? o_row[c].lo : g_row[c].lo);
              hi += terms<OP, MINMAX>(pieces::hi4(rv[u][c]), pieces::hi4(xv[u][c]), g_row[c].hi,
                                      w, MINMAX ? o_row[c].hi : g_row[c].hi);
            }
          }
          // the f32 instance's offsets group ... 2, each at half of it here;
          // lo + hi below is its offset 1
          for (int offset = group / 2; offset > 0; offset >>= 1) {
            lo += __shfl_xor_sync(lanes, lo, offset);
            hi += __shfl_xor_sync(lanes, hi, offset);
          }
          if (lane == 0) {
            const float acc = lo + hi;
            const float sum = pass == 0 ? acc : sums[i + u] + acc;
            if (pass == passes - 1) {
              a.dw[s[2 * kStage8 + i + u]] = sum;
            } else {
              sums[i + u] = sum;
            }
          }
        }
      }
    }
  }
}

template <int OP, bool MINMAX, int K, class R, class X>
int launch_lanes(pieces::Table t, const DwArgs<R, X>& a, int group, int parts,
                 cudaStream_t stream) {
  const int passes = static_cast<int>((t.width + K * group - 1) / (K * group));
  if constexpr (std::is_same_v<R, float> && std::is_same_v<X, float>) {
    const int groups = pieces::kBlock / group < kMaxGroups ? pieces::kBlock / group : kMaxGroups;
    const size_t words = kWords * pieces::kStage + (passes > 1 ? pieces::kStage : 0);
    const dim3 grid(static_cast<unsigned>((t.num_pieces * parts + groups - 1) / groups));
    dw_kernel<OP, MINMAX, K, R, X>
        <<<grid, groups * group, sizeof(int32_t) * words * groups, stream>>>(t, a, group, parts,
                                                                            passes);
  } else {
    // half the lanes, each on 8 features; at most 32 groups a block, so
    // that its stage stays within 48 KB of shared memory
    const int group8 = group / 2;
    const int groups = pieces::kBlock / group8 < 32 ? pieces::kBlock / group8 : 32;
    const size_t words = (MINMAX ? 4 : 3) * kStage8 + (passes > 1 ? kStage8 : 0);
    const dim3 grid(static_cast<unsigned>((t.num_pieces * parts + groups - 1) / groups));
    t.width /= 2;
    dw8_kernel<OP, MINMAX, K, R, X>
        <<<grid, groups * group8, sizeof(int32_t) * words * groups, stream>>>(t, a, group8,
                                                                             parts, passes);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int OP, bool MINMAX, class R, class X>
int launch(const pieces::Table& t, const DwArgs<R, X>& a, int parts, cudaStream_t stream) {
  // a group of at most one warp, as many lanes as float4s up to 32; a wider
  // row puts 2 or 4 float4s on a lane, and one wider still takes passes (the
  // bf16 instance's lanes each take two of these lanes)
  const int group = t.width > 32 ? 32 : pieces::group_size(t.width);
  if (t.width <= group) return launch_lanes<OP, MINMAX, 1>(t, a, group, parts, stream);
  if (t.width <= 2 * group) return launch_lanes<OP, MINMAX, 2>(t, a, group, parts, stream);
  return launch_lanes<OP, MINMAX, 4>(t, a, group, parts, stream);
}


template <class R, class X>
int dw(const void* piece_ptr, const void* piece_row, const void* piece_order, const void* col,
       const void* etype, const void* eid, const void* weight, const void* rel, const void* x,
       const void* g, const void* out, void* d_w, long long num_pieces, long long num_feat,
       int mul_op, int minmax, int parts, void* stream) {
  if ((mul_op != 0 && mul_op != 1) || (minmax != 0 && minmax != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (parts < 1 || parts > pieces::kStage) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int feat = std::is_same_v<R, float> && std::is_same_v<X, float> ? 4 : 8;
  if (num_pieces <= 0 || num_feat <= 0 || num_feat % feat != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!pieces::aligned16(rel) || !pieces::aligned16(x) || !pieces::aligned16(g) ||
      (minmax && !pieces::aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const pieces::Table t{static_cast<const int64_t*>(piece_ptr),
                        static_cast<const int32_t*>(piece_row),
                        nullptr,
                        static_cast<const int32_t*>(piece_order),
                        nullptr,
                        nullptr,
                        nullptr,
                        nullptr,
                        num_pieces,
                        0,
                        num_feat / 4};
  const DwArgs<R, X> a{static_cast<const int32_t*>(col),  static_cast<const int32_t*>(etype),
                       static_cast<const int32_t*>(eid),  static_cast<const float*>(weight),
                       static_cast<const R*>(rel),        static_cast<const X*>(x),
                       static_cast<const float4*>(g),     static_cast<const float4*>(out),
                       static_cast<float*>(d_w)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (mul_op == 0) {
    return minmax ? launch<0, true>(t, a, parts, s) : launch<0, false>(t, a, parts, s);
  }
  return minmax ? launch<1, true>(t, a, parts, s) : launch<1, false>(t, a, parts, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// piece table (piece_ptr (P+1) int64, piece_row and piece_order (P) int32)
// is graph.py::build_csr's for the destination-major CSR; col (the source),
// etype, eid: (E) int32; weight, dw: f32 indexed by eid (dw zeroed by the
// caller); rel: (R, num_feat) and x: (N, num_feat) of the entry point's types
// (rspmm_dw: f32 and f32; rspmm_dw_bf16_bf16: bf16 and bf16); g: (rows,
// num_feat) f32; out: (rows, num_feat) f32 for minmax 1, unread (may be
// null) for minmax 0. All contiguous on one device; indices are trusted to be
// in range. Each piece is walked by `parts` groups (1 to kStage). num_feat %
// 4 != 0 (% 8 for rspmm_dw_bf16_bf16), no piece, parts out of range or a
// misaligned row operand returns cudaErrorInvalidValue and launches nothing.
PIECES_ENTRIES2(rspmm_dw, dw,
                (const void* piece_ptr, const void* piece_row, const void* piece_order,
                 const void* col, const void* etype, const void* eid, const void* weight,
                 const void* rel, const void* x, const void* g, const void* out, void* d_w,
                 long long num_pieces, long long num_feat, int mul_op, int minmax, int parts,
                 void* stream),
                (piece_ptr, piece_row, piece_order, col, etype, eid, weight, rel, x, g, out,
                 d_w, num_pieces, num_feat, mul_op, minmax, parts, stream))

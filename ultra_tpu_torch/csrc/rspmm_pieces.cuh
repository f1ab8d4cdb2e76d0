// The walk over a piece table that the rspmm kernels B1 (rspmm_sum_fwd.cu),
// B2 (rspmm_sum_drel.cu), B3 (rspmm_minmax_fwd.cu), B4 (rspmm_minmax_dx.cu)
// and B5 (rspmm_minmax_drel.cu) share. B6 (rspmm_dw.cu), whose output is
// one value an edge, walks a CSR's table with a pass of its own built from
// the same parts (the table, group_size, group_sync, the staging).
//
// graph.py cuts every row of a layout into pieces of at most a fixed number
// of edges, in edge order: the rows of a CSR (ROW_PIECE edges; a row is a
// destination for B1, B3 and B6, a source for B4) or the types of the type
// segments (B2 and B5, a length chosen from the graph's edge and type
// counts). A
// piece of a one-piece row writes that row of `out`; the pieces of a longer
// row write consecutive partial rows (their slots) of a scratch buffer, which
// a second pass combines in slot order. Both passes are launched here, on one
// stream, with no atomics: the result is the same bits on every run.
//
// What bounds the walks on an H100 is the latency of the gathered row loads,
// not their bytes: the x rows sit in L2, and a piece's edges are a chain of
// rounds of loads. What hides that latency is edges in flight on each SM:
// pieces in flight (groups) times edges in flight per thread (W::kUnroll).
//
// Pass 1. A group of threads takes one piece and one tile of the row, the
// pieces longest first (piece_order), so that the longest start in the
// first wave and the groups that share a warp or a block walk pieces of
// about one length; a thread per unit of the row (4 features, or 8: see Row
// operands), the group as many threads as the row has units (a power of two
// from 8 up to 32, else a multiple of 32 up to 256, the last lanes idle
// where the row has fewer), a block of 256 threads holding 256 / group of
// them. So at F=64 a 4-feature walk's block walks 16 pieces and no lane
// idles; a row of more than 256 units takes several feature tiles (grid.y).
// - The group first stages up to kStage edges of its piece in shared memory:
//   the 32-bit words the walk's policy asks for (indices, the weight), read
//   with coalesced loads, one round trip for the stage instead of dependent
//   loads per edge. Its barriers are the group's own, so a group that is
//   done with a short piece does not wait for the block's longest.
// - It then walks the staged edges W::kUnroll at a time: every thread issues
//   the row loads of W::kUnroll edges before it folds any of them in, so
//   that many edges' loads per thread are in flight at once, and then folds
//   them in edge order.
// - The sizes were timed on an H100 (PERF.md): a stage of 128 edges (a whole
//   piece at ROW_PIECE 128); for B1 and B3, 4 edges in flight with
//   registers capped so that 4 blocks fit an SM beat 8 in flight at 2
//   blocks and 2 at 8: what hides the gathers' latency is warps in flight
//   as much as loads per warp. The 8-feature walk's sizes are each
//   kernel's own, chosen from 2-16 edges at 1-8 blocks over each instance's
//   rows on the paths: B1 and B2 keep 6 edges in flight at 3 or 2 blocks
//   (Gather8, Drel8: their registers decide), B3 3 at 4 (Gather8 at
//   rspmm_minmax_fwd.cu's sizes), B4 2 at 3 and B5 4 at 2 (Dx8,
//   MinMaxDrel8, whose edges bring the most registers: a bf16 row and f32
//   out and g rows).
// Pass 2. A group per (long row, tile) adds the row's partials in slot order
// and writes the row of `out` (long_row_kernel: B1, B3, B4). A walk whose
// long rows have hundreds of partials (B2 and B5 on the relation graph's 4
// types) gives a row `split` groups of one block instead (split_row_kernel):
// each adds every split-th partial from its own first slot on, in slot
// order, and the first folds the others' sums in, in group order, so that
// no single group's chain of loads sets the pass's length. The split is the
// 4-feature walk's at the same F in every instance, so the order of the sums
// is too.
//
// What an edge brings is the walk's policy W:
//   W::Args                     the kernel's own operands
//   W::Acc                      the accumulator of a thread (AccOf: float4,
//                               4 features, where W names none; f32x8, 8)
//   W::kWords                   32-bit words staged per edge: word k of staged
//                               edge i is s[k * kStage + i]
//   W::kUnroll                  edges whose row loads a thread keeps in flight
//   W::kMinBlocks               blocks of pass 1 an SM must hold (caps registers)
//   W::kSplit                   the groups of pass 2 a long row may take (1:
//                               long_row_kernel)
//   W::Row row(a, r, width, j)  loaded once for the piece's row r (B4: x[r],
//                               B5: rel[r])
//   W::stage(a, e, s, i)        stages edge e's words as edge i
//   W::Edge load(a, s, i, width, j)   issues staged edge i's row loads
//   W::add(acc, row, s, i, edge)      folds staged edge i in
//   W::init()                   an empty row's value
//   W::merge(acc, partial)      folds a partial in (both pieces::Adds for the
//                               walks that add)
// Offsets row*F are 64-bit; `width` counts accumulator units (F/4 or F/8).
//
// Row operands. Each kernel is a template on the element types of its row
// operands (its relation and x rows; the output gradient and the forward's
// saved output are f32), instantiated once per C entry point; the
// accumulators, the partial rows and the output are f32 in every instance,
// so a bf16 instance computes the f32 instance's arithmetic on bf16-rounded
// operands and moves half of their bytes.
// - The 4-feature walk (every f32 instance): a thread owns 4 contiguous
//   features of every row, and `load4` brings them in as one float4.
// - The 8-feature walk (every bf16 instance: B1 and B3, Gather8; B2, Drel8;
//   B4, Dx8; B5, MinMaxDrel8; and B6's own 8-feature pass): a thread owns 8
//   contiguous features, so that a bf16 row is read 16 bytes a thread, as
//   Hopper loads fastest, and a group is half as wide: at F=512 a block
//   walks 4 pieces instead of 2, twice the edges in flight on an SM for the
//   same registers. `load8` brings a bf16 row in as its raw bits (a uint4: 8
//   values in 4 registers, so 4 edges of two bf16 rows take the 32
//   registers that 4 edges of two f32 float4s take) and an f32 row as two
//   float4s; a value is widened only at the fold, where it is added in
//   (lo4, hi4: one integer instruction a value, exact). The fold is the
//   4-feature walk's (the same Agg::add, or the kernel's term, on each
//   half), in the same order, so a bf16 instance gives the f32 instance's
//   bits on the widened values. It needs F % 8 == 0.
// Every row operand of every walk starts 16-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace pieces {

using bf16 = __nv_bfloat16;

// Features 4i..4i+3 of an f32 row operand that starts at p (the 4-feature walk).
__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

// Features 8i..8i+7 of a row operand for the 8-feature walk: a bf16 row's
// raw bits as one 16-byte load (Raw8<bf16>: uint4), an f32 row's values as
// two (Raw8<float>: f32x8, also the walk's accumulator); lo4 and hi4 give
// features 0-3 and 4-7 as f32. bf16 is the high half of an f32, so widening
// a value is one shift or one mask, and exact.
struct f32x8 {
  float4 lo, hi;
};
template <class T>
struct Raw8;
template <>
struct Raw8<float> {
  using type = f32x8;
};
template <>
struct Raw8<bf16> {
  using type = uint4;
};
__device__ __forceinline__ uint4 load8(const bf16* p, int64_t i) {
  return __ldg(reinterpret_cast<const uint4*>(p) + i);
}
__device__ __forceinline__ f32x8 load8(const float* p, int64_t i) {
  const float4* q = reinterpret_cast<const float4*>(p) + 2 * i;
  return {__ldg(q), __ldg(q + 1)};
}
__device__ __forceinline__ float4 widen(uint32_t a, uint32_t b) {
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}
__device__ __forceinline__ float4 lo4(const uint4& r) { return widen(r.x, r.y); }
__device__ __forceinline__ float4 hi4(const uint4& r) { return widen(r.z, r.w); }
__device__ __forceinline__ float4 lo4(const f32x8& r) { return r.lo; }
__device__ __forceinline__ float4 hi4(const f32x8& r) { return r.hi; }

// The accumulator of walk W: W::Acc, else a float4 (the 4-feature walk).
template <class W, class = void>
struct AccOf {
  using type = float4;
};
template <class W>
struct AccOf<W, std::void_t<typename W::Acc>> {
  using type = typename W::Acc;
};
template <class W>
using Acc = typename AccOf<W>::type;

constexpr int kBlock = 256;      // threads of a pass-1 block
constexpr int kStage = 128;      // edges of a piece staged in shared memory at once
constexpr int kMaxThreads = 1024;  // threads of a pass-2 block at most

// The piece table and the output, what every walk has.
struct Table {
  const int64_t* piece_ptr;      // (P+1) first edge of each piece
  const int32_t* piece_row;      // (P) its row
  const int32_t* piece_slot;     // (P) its partial row, -1 for a one-piece row
  const int32_t* piece_order;    // (P) the pieces, longest first
  const int32_t* long_rows;      // (L) rows of more than one piece
  const int64_t* long_slot_ptr;  // (L+1) their slot ranges
  float4* partial;               // (slots, width) scratch
  float4* out;                   // (rows, width)
  int64_t num_pieces;
  int64_t num_long;
  int64_t width;                 // row length in accumulator units (F / 4 or F / 8)
};

struct NoRow {};

// init and merge of the walks that add (B1, B2, B4, B5): an empty row is 0.
struct Adds {
  __device__ static float4 init() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void merge(float4& acc, const float4& p) {
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
};

// Threads of a group for a row of `width` accumulator units.
inline int group_size(long long width) {
  if (width > 32) return width >= kBlock ? kBlock : static_cast<int>((width + 31) / 32 * 32);
  int group = 8;
  while (group < width) group *= 2;
  return group;
}

// A barrier for the threads of group g alone, so that a group never waits
// for another group's longer piece: a group of at most 32 threads (a power
// of two) lies in one warp and syncs its lanes; a wider one (a multiple of
// 32, at most 4 in a block) takes named barrier g + 1.
__device__ __forceinline__ void group_sync(int g, int group) {
  if (group <= 32) {
    const unsigned lanes = group == 32 ? 0xffffffffu : (1u << group) - 1;
    __syncwarp(lanes << ((threadIdx.x & 31) & ~(group - 1)));
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(group) : "memory");
  }
}

template <class W>
__global__ void __launch_bounds__(kBlock, W::kMinBlocks)
    piece_kernel(const Table t, const typename W::Args a, int group) {
  extern __shared__ int32_t staged[];  // per group: kWords * kStage words
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * (blockDim.x / group) + g;
  const int64_t piece = k >= t.num_pieces ? t.num_pieces : t.piece_order[k];
  const int64_t j = static_cast<int64_t>(blockIdx.y) * group + lane;
  const bool mine = j < t.width;
  int32_t* s = staged + W::kWords * kStage * g;
  int64_t begin = 0, len = 0;
  if (piece < t.num_pieces) {
    begin = t.piece_ptr[piece];
    len = t.piece_ptr[piece + 1] - begin;
  }
  Acc<W> acc = W::init();
  typename W::Row row{};
  if (len > 0 && mine) row = W::row(a, t.piece_row[piece], t.width, j);
  for (int64_t base = 0; base < len; base += kStage) {
    const int n = len - base < kStage ? static_cast<int>(len - base) : kStage;
    group_sync(g, group);  // the group is done with the last stage
    for (int i = lane; i < n; i += group) W::stage(a, begin + base + i, s, i);
    group_sync(g, group);
    if (!mine) continue;
    for (int i = 0; i < n; i += W::kUnroll) {
      typename W::Edge ev[W::kUnroll];
#pragma unroll
      for (int u = 0; u < W::kUnroll; ++u) {
        if (i + u < n) ev[u] = W::load(a, s, i + u, t.width, j);
      }
#pragma unroll
      for (int u = 0; u < W::kUnroll; ++u) {
        if (i + u < n) W::add(acc, row, s, i + u, ev[u]);
      }
    }
  }
  if (piece < t.num_pieces && mine) {
    const int32_t slot = t.piece_slot[piece];
    Acc<W>* const out = reinterpret_cast<Acc<W>*>(t.out);
    Acc<W>* const partial = reinterpret_cast<Acc<W>*>(t.partial);
    Acc<W>* dst = slot < 0 ? out + static_cast<int64_t>(t.piece_row[piece]) * t.width
                           : partial + static_cast<int64_t>(slot) * t.width;
    dst[j] = acc;
  }
}

// Pass 2 with one group a long row: a block of kBlock threads combines
// kBlock / group long rows.
template <class W>
__global__ void __launch_bounds__(kBlock) long_row_kernel(const Table t, int group) {
  const int g = threadIdx.x / group;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x / group) + g;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * group + (threadIdx.x - g * group);
  if (i >= t.num_long || j >= t.width) return;
  const Acc<W>* partial = reinterpret_cast<const Acc<W>*>(t.partial);
  const int64_t first = t.long_slot_ptr[i];
  const int64_t end = t.long_slot_ptr[i + 1];
  Acc<W> acc = partial[first * t.width + j];
#pragma unroll 4
  for (int64_t s = first + 1; s < end; ++s) W::merge(acc, partial[s * t.width + j]);
  reinterpret_cast<Acc<W>*>(t.out)[static_cast<int64_t>(t.long_rows[i]) * t.width + j] = acc;
}

// Pass 2 with `split` groups a long row: a block holds blockDim.x / (split *
// group) long rows, and the groups of a row combine through shared memory.
template <class W>
__global__ void __launch_bounds__(kMaxThreads) split_row_kernel(const Table t, int group,
                                                                 int split) {
  extern __shared__ float4 shared[];  // per group after a row's first: group accumulators
  Acc<W>* sums = reinterpret_cast<Acc<W>*>(shared);
  const Acc<W>* partial = reinterpret_cast<const Acc<W>*>(t.partial);
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  const int part = g % split;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x / (group * split)) + g / split;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * group + lane;
  const bool mine = i < t.num_long && j < t.width;
  Acc<W> acc = W::init();
  if (mine) {
    const int64_t first = t.long_slot_ptr[i] + part;
    const int64_t end = t.long_slot_ptr[i + 1];
    if (first < end) acc = partial[first * t.width + j];
#pragma unroll 4
    for (int64_t s = first + split; s < end; s += split) W::merge(acc, partial[s * t.width + j]);
  }
  if (part > 0) sums[(g - g / split - 1) * group + lane] = acc;
  __syncthreads();
  if (part > 0 || !mine) return;
  for (int p = 1; p < split; ++p) W::merge(acc, sums[(g - g / split + p - 1) * group + lane]);
  reinterpret_cast<Acc<W>*>(t.out)[static_cast<int64_t>(t.long_rows[i]) * t.width + j] = acc;
}

// Whether p is 16-byte aligned: where every walk's row operands must start
// (one float4, or 8 bf16 values, a load).
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Features a thread of walk W owns: 4, or 8 for the 8-feature walk.
template <class W>
constexpr int kFeatures = static_cast<int>(sizeof(Acc<W>) / sizeof(float));

// Checks what the walk needs, launches both passes on `stream` and returns
// cudaGetLastError() (0 on success). num_feat not a multiple of the walk's
// features a thread (4 or 8), no piece, or an out (or, with long rows,
// partial) not 16-byte aligned returns cudaErrorInvalidValue and launches
// nothing; the caller checks its own row operands' alignment.
template <class W>
int launch(Table t, const typename W::Args& a, long long num_feat, void* stream) {
  if (t.num_pieces <= 0 || t.num_long < 0 || num_feat <= 0 || num_feat % kFeatures<W> != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(t.out) || (t.num_long > 0 && !aligned16(t.partial))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t.width = num_feat / kFeatures<W>;
  const int group = group_size(t.width);
  const int groups = kBlock / group;
  const unsigned tiles = static_cast<unsigned>((t.width + group - 1) / group);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int32_t) * W::kWords * kStage * groups;
  const dim3 grid(static_cast<unsigned>((t.num_pieces + groups - 1) / groups), tiles);
  piece_kernel<W><<<grid, groups * group, smem, s>>>(t, a, group);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0 || t.num_long == 0) return status;
  // the split of the 4-feature walk's group, which is at least as wide
  const int group4 = group_size(num_feat / 4);
  int split = 1;
  while (split * 2 <= W::kSplit && split * 2 * group4 <= kMaxThreads) split *= 2;
  if constexpr (W::kSplit > 1) {
    if (split > 1) {
      const int threads = split * group > kBlock ? split * group : kBlock;
      const int rows = threads / (split * group);  // long rows a block combines
      const size_t smem2 = sizeof(Acc<W>) * (split - 1) * group * rows;
      const dim3 grid2(static_cast<unsigned>((t.num_long + rows - 1) / rows), tiles);
      split_row_kernel<W><<<grid2, threads, smem2, s>>>(t, group, split);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const dim3 grid2(static_cast<unsigned>((t.num_long + groups - 1) / groups), tiles);
  long_row_kernel<W><<<grid2, groups * group, 0, s>>>(t, group);
  return static_cast<int>(cudaGetLastError());
}

// The operands of the forward walk, which the aggregations share; R and X
// are the element types of the relation and x rows (float or bf16).
template <class R, class X>
struct GatherArgs {
  const int32_t* col;
  const int32_t* etype;
  const int32_t* eid;
  const float* weight;  // indexed by eid
  const R* rel;         // (R, F)
  const X* x;           // (N, F)
};

// The forward walk of B1 and B3: an edge brings x[col] and rel[etype],
// widened to f32, and Agg folds it in (Agg::add(acc, w, rel, x)).
template <class Agg, class R, class X>
struct Gather {
  using Args = GatherArgs<R, X>;
  struct Edge {
    float4 x, rel;
  };
  using Row = NoRow;
  static constexpr int kWords = 3, kUnroll = 4, kMinBlocks = 4, kSplit = 1;

  __device__ static Row row(const Args&, int64_t, int64_t, int64_t) { return {}; }
  __device__ static void stage(const Args& a, int64_t e, int32_t* s, int i) {
    s[i] = __ldg(a.col + e);
    s[kStage + i] = __ldg(a.etype + e);
    s[2 * kStage + i] = __float_as_int(__ldg(a.weight + __ldg(a.eid + e)));
  }
  __device__ static Edge load(const Args& a, const int32_t* s, int i, int64_t width,
                              int64_t j) {
    return {load4(a.x, static_cast<int64_t>(s[i]) * width + j),
            load4(a.rel, static_cast<int64_t>(s[kStage + i]) * width + j)};
  }
  __device__ static void add(float4& acc, const Row&, const int32_t* s, int i,
                             const Edge& e) {
    Agg::add(acc, __int_as_float(s[2 * kStage + i]), e.rel, e.x);
  }
  __device__ static float4 init() { return Agg::init(); }
  __device__ static void merge(float4& acc, const float4& p) { Agg::merge(acc, p); }
};

// The sizes of B1's 8-feature walk (edges whose loads a thread keeps in
// flight, blocks an SM must hold), timed on an H100 (PERF.md,
// scripts/torch_row_piece_sweep.py --walk8): 6 edges in flight, and as
// many blocks as their registers let in: 3 for bf16 x rows (the forward, 8
// registers of raw rows an edge; 80 registers a thread), 2 for f32 x rows
// (the input gradient's g, 12 an edge). 4 edges at 4 blocks, the 4-feature
// walk's sizes, spill the f32 x rows' instance and leave a relation-graph
// row's chain of rounds long (32 rounds for a piece of 128 edges).
constexpr int kGather8Unroll = 6, kGather8MinBlocks = 3;
constexpr int kGather8F32Unroll = 6, kGather8F32MinBlocks = 2;

// The forward walk of B1 and B3 on the 8-feature walk (their bf16
// instances): an edge brings x[col] and rel[etype] as their raw loads, and
// Agg folds each half in at the fold, widened, as Gather folds its float4.
// kU and kB are the walk's sizes (edges in flight, blocks an SM): B1's
// above unless the kernel names its own (B3: rspmm_minmax_fwd.cu).
template <class Agg, class R, class X,
          int kU = std::is_same_v<X, float> ? kGather8F32Unroll : kGather8Unroll,
          int kB = std::is_same_v<X, float> ? kGather8F32MinBlocks : kGather8MinBlocks>
struct Gather8 {
  using Args = GatherArgs<R, X>;
  using Acc = f32x8;
  struct Edge {
    typename Raw8<X>::type x;
    typename Raw8<R>::type rel;
  };
  using Row = NoRow;
  static constexpr int kWords = 3, kSplit = 1, kUnroll = kU, kMinBlocks = kB;

  __device__ static Row row(const Args&, int64_t, int64_t, int64_t) { return {}; }
  __device__ static void stage(const Args& a, int64_t e, int32_t* s, int i) {
    Gather<Agg, R, X>::stage(a, e, s, i);
  }
  __device__ static Edge load(const Args& a, const int32_t* s, int i, int64_t width,
                              int64_t j) {
    return {load8(a.x, static_cast<int64_t>(s[i]) * width + j),
            load8(a.rel, static_cast<int64_t>(s[kStage + i]) * width + j)};
  }
  __device__ static void add(f32x8& acc, const Row&, const int32_t* s, int i, const Edge& e) {
    const float w = __int_as_float(s[2 * kStage + i]);
    Agg::add(acc.lo, w, lo4(e.rel), lo4(e.x));
    Agg::add(acc.hi, w, hi4(e.rel), hi4(e.x));
  }
  __device__ static f32x8 init() { return {Agg::init(), Agg::init()}; }
  __device__ static void merge(f32x8& acc, const f32x8& p) {
    Agg::merge(acc.lo, p.lo);
    Agg::merge(acc.hi, p.hi);
  }
};

}  // namespace pieces

// The C entry points of a kernel: NAME (f32 rows) and NAME_<types> for a
// bf16 instance, each a thin call of FN<row types>. PARAMS is the entry
// points' parameter list and ARGS the same names as arguments. A kernel
// with relation and x rows has the instances (rel, x) = (f32, f32) and
// (bf16, bf16) (PIECES_ENTRIES2; B1 adds (bf16, f32), its input gradient),
// one with x rows alone f32 and bf16 (PIECES_ENTRIES1).
#define PIECES_ENTRY(NAME, FN, PARAMS, ARGS, ...) \
  extern "C" int NAME PARAMS { return FN<__VA_ARGS__> ARGS; }
#define PIECES_ENTRIES2(NAME, FN, PARAMS, ARGS)      \
  PIECES_ENTRY(NAME, FN, PARAMS, ARGS, float, float) \
  PIECES_ENTRY(NAME##_bf16_bf16, FN, PARAMS, ARGS, pieces::bf16, pieces::bf16)
#define PIECES_ENTRIES1(NAME, FN, PARAMS, ARGS) \
  PIECES_ENTRY(NAME, FN, PARAMS, ARGS, float)   \
  PIECES_ENTRY(NAME##_bf16, FN, PARAMS, ARGS, pieces::bf16)

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
// Pass 1. A group of threads takes one piece and one tile of the row, the
// pieces longest first (piece_order), so that the longest start in the
// first wave and the groups that share a warp or a block walk pieces of
// about one length; a thread per float4 of the row, the group F/4 threads
// wide (a power of two from 8 up to 32, else a multiple of 32 up to 256, the
// last lanes idle where F/4 is not), a block of 256 threads holding
// 256 / group of them. So at F=64 a block walks 16 pieces and no lane idles;
// F > 1024 takes several feature tiles (grid.y).
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
//   as much as loads per warp.
// Pass 2. A group per (long row, tile) adds the row's partials in slot order
// and writes the row of `out` (long_row_kernel: B1, B3, B4). A walk whose
// long rows have hundreds of partials (B2 and B5 on the relation graph's 4
// types) gives a row `split` groups of one block instead (split_row_kernel):
// each adds every split-th partial from its own first slot on, in slot
// order, and the first folds the others' sums in, in group order, so that
// no single group's chain of loads sets the pass's length.
//
// What an edge brings is the walk's policy W:
//   W::Args                     the kernel's own operands
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
// Offsets row*F are 64-bit.
//
// Row operands. A thread owns 4 contiguous features of every row, and
// `load4` brings them in as a float4 whatever the operand's element type:
// an f32 row as one 16-byte load, a bf16 row as one 8-byte load widened to
// f32 in registers (exact). Each kernel is a template on the element types
// of its row operands (its relation and x rows; the output gradient and the
// forward's saved output are f32), instantiated once per C entry point;
// the accumulators, the partial rows and the output are f32 in every
// instance, so a bf16 instance computes the f32 instance's arithmetic on
// bf16-rounded operands and moves half of their bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pieces {

using bf16 = __nv_bfloat16;

// Features 4i..4i+3 of a row operand that starts at p, as f32.
__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}
__device__ __forceinline__ float bf16_at(uint32_t word, int half) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(word >> (16 * half))));
}
__device__ __forceinline__ float4 load4(const bf16* p, int64_t i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
  return make_float4(bf16_at(u.x, 0), bf16_at(u.x, 1), bf16_at(u.y, 0), bf16_at(u.y, 1));
}

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
  int64_t width;                 // row length in float4s (F / 4)
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

// Threads of a group for a row of `width` float4s.
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
  float4 acc = W::init();
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
    float4* dst = slot < 0 ? t.out + static_cast<int64_t>(t.piece_row[piece]) * t.width
                           : t.partial + static_cast<int64_t>(slot) * t.width;
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
  const int64_t first = t.long_slot_ptr[i];
  const int64_t end = t.long_slot_ptr[i + 1];
  float4 acc = t.partial[first * t.width + j];
#pragma unroll 4
  for (int64_t s = first + 1; s < end; ++s) W::merge(acc, t.partial[s * t.width + j]);
  t.out[static_cast<int64_t>(t.long_rows[i]) * t.width + j] = acc;
}

// Pass 2 with `split` groups a long row: a block holds blockDim.x / (split *
// group) long rows, and the groups of a row combine through shared memory.
template <class W>
__global__ void __launch_bounds__(kMaxThreads) split_row_kernel(const Table t, int group,
                                                                 int split) {
  extern __shared__ float4 sums[];  // per group after a row's first: group float4s
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  const int part = g % split;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x / (group * split)) + g / split;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * group + lane;
  const bool mine = i < t.num_long && j < t.width;
  float4 acc = W::init();
  if (mine) {
    const int64_t first = t.long_slot_ptr[i] + part;
    const int64_t end = t.long_slot_ptr[i + 1];
    if (first < end) acc = t.partial[first * t.width + j];
#pragma unroll 4
    for (int64_t s = first + split; s < end; s += split) {
      W::merge(acc, t.partial[s * t.width + j]);
    }
  }
  if (part > 0) sums[(g - g / split - 1) * group + lane] = acc;
  __syncthreads();
  if (part > 0 || !mine) return;
  for (int p = 1; p < split; ++p) W::merge(acc, sums[(g - g / split + p - 1) * group + lane]);
  t.out[static_cast<int64_t>(t.long_rows[i]) * t.width + j] = acc;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Whether a row operand of element type T starts where load4 can read it:
// 16-byte aligned for f32, 8-byte for bf16.
template <class T>
inline bool aligned_rows(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T))) == 0;
}

// Checks what the walk needs, launches both passes on `stream` and returns
// cudaGetLastError() (0 on success). num_feat % 4 != 0, no piece, or an out
// (or, with long rows, partial) not 16-byte aligned returns
// cudaErrorInvalidValue and launches nothing; the caller checks its own
// row operands' alignment.
template <class W>
int launch(Table t, const typename W::Args& a, long long num_feat, void* stream) {
  if (t.num_pieces <= 0 || t.num_long < 0 || num_feat <= 0 || num_feat % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(t.out) || (t.num_long > 0 && !aligned16(t.partial))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t.width = num_feat / 4;
  const int group = group_size(t.width);
  const int groups = kBlock / group;
  const unsigned tiles = static_cast<unsigned>((t.width + group - 1) / group);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int32_t) * W::kWords * kStage * groups;
  const dim3 grid(static_cast<unsigned>((t.num_pieces + groups - 1) / groups), tiles);
  piece_kernel<W><<<grid, groups * group, smem, s>>>(t, a, group);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0 || t.num_long == 0) return status;
  int split = 1;
  while (split * 2 <= W::kSplit && split * 2 * group <= kMaxThreads) split *= 2;
  if constexpr (W::kSplit > 1) {
    if (split > 1) {
      const int threads = split * group > kBlock ? split * group : kBlock;
      const int rows = threads / (split * group);  // long rows a block combines
      const size_t smem2 = sizeof(float4) * (split - 1) * group * rows;
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
  const R* rel;         // (R, 4 * width)
  const X* x;           // (N, 4 * width)
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

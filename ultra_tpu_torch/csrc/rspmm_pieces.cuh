// The walk over a CSR's piece table that the sum forward B1
// (rspmm_sum_fwd.cu) and the min/max forward B3 (rspmm_minmax_fwd.cu) share.
//
// graph.py::build_csr cuts every CSR row into pieces of at most ROW_PIECE
// edges, in edge order. A piece of a one-piece row writes that row of `out`;
// the pieces of a longer row write consecutive partial rows (their slots) of
// a scratch buffer, which a second pass combines in slot order. Both passes
// are launched here, on one stream, with no atomics: the result is the same
// bits on every run.
//
// Pass 1. A group of threads takes one piece and one tile of the row, the
// pieces longest first (piece_order), so that the longest start in the
// first wave and the groups that share a warp or a block walk pieces of
// about one length; a
// thread per float4 of the row, the group F/4 threads wide (a power of two
// from 8 up to 32, else a multiple of 32 up to 256, the last lanes idle
// where F/4 is not), a block of 256 threads holding 256 / group of them. So
// at F=64 a block walks 16 pieces and no lane idles; F > 1024 takes several
// feature tiles (grid.y).
// - The group first stages up to kStage edges of its piece in shared memory:
//   `col`, `etype` and `weight[eid]`, read with coalesced loads, one round
//   trip for the stage instead of three dependent loads per edge. Its
//   barriers are the group's own, so a group that is done with a short
//   piece does not wait for the block's longest.
// - It then walks the staged edges kUnroll at a time: every thread issues
//   the x and rel float4 loads of kUnroll edges before it combines any of
//   them, so kUnroll row loads per thread are in flight at once, and then
//   combines them in edge order (Agg::add).
// - The sizes were timed on an H100 (PERF.md): a stage of 128 edges
//   (a whole piece at ROW_PIECE 128), 4 edges in flight and registers
//   capped so that 4 blocks fit an SM beat 8 in flight at 2 blocks and 2 at
//   8: what hides the gathers' latency is warps in flight as much as loads
//   per warp.
// Pass 2. A group per (long row, tile) combines the row's partials in slot
// order (Agg::merge) and writes the row of `out`.
//
// The aggregation is a policy: Agg::init() is an empty row's value,
// Agg::add(acc, w, rel, x) folds one edge in, Agg::merge(acc, partial)
// folds a partial in. Offsets row*F are 64-bit.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pieces {

constexpr int kBlock = 256;    // threads a block
constexpr int kStage = 128;    // edges of a piece staged in shared memory at once
constexpr int kUnroll = 4;     // edges whose row loads a thread keeps in flight
constexpr int kMinBlocks = 4;  // blocks an SM must hold (caps registers at 64 a thread)

struct Operands {
  const int64_t* piece_ptr;      // (P+1) first edge of each piece
  const int32_t* piece_row;      // (P) its row
  const int32_t* piece_slot;     // (P) its partial row, -1 for a one-piece row
  const int32_t* piece_order;    // (P) the pieces, longest first
  const int32_t* long_rows;      // (L) rows of more than one piece
  const int64_t* long_slot_ptr;  // (L+1) their slot ranges
  const int32_t* col;            // (E) the CSR
  const int32_t* etype;
  const int32_t* eid;
  const float* weight;           // indexed by eid
  const float4* rel;             // (R, width)
  const float4* x;               // (N, width)
  float4* partial;               // (slots, width) scratch
  float4* out;                   // (rows, width)
  int64_t num_pieces;
  int64_t num_long;
  int64_t width;                 // row length in float4s (F / 4)
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

template <class Agg>
__global__ void __launch_bounds__(kBlock, kMinBlocks) piece_kernel(const Operands a, int group) {
  extern __shared__ int32_t staged[];  // per group: kStage cols, types, weights
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * (blockDim.x / group) + g;
  const int64_t piece = k >= a.num_pieces ? a.num_pieces : a.piece_order[k];
  const int64_t j = static_cast<int64_t>(blockIdx.y) * group + lane;
  const bool mine = j < a.width;
  int32_t* s_col = staged + 3 * kStage * g;
  int32_t* s_type = s_col + kStage;
  float* s_w = reinterpret_cast<float*>(s_type + kStage);
  int64_t begin = 0, len = 0;
  if (piece < a.num_pieces) {
    begin = a.piece_ptr[piece];
    len = a.piece_ptr[piece + 1] - begin;
  }
  float4 acc = Agg::init();
  for (int64_t base = 0; base < len; base += kStage) {
    const int n = len - base < kStage ? static_cast<int>(len - base) : kStage;
    group_sync(g, group);  // the group is done with the last stage
    for (int i = lane; i < n; i += group) {
      const int64_t e = begin + base + i;
      s_col[i] = __ldg(a.col + e);
      s_type[i] = __ldg(a.etype + e);
      s_w[i] = __ldg(a.weight + __ldg(a.eid + e));
    }
    group_sync(g, group);
    if (!mine) continue;
    for (int i = 0; i < n; i += kUnroll) {
      float4 xv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u < n) {
          xv[u] = __ldg(a.x + static_cast<int64_t>(s_col[i + u]) * a.width + j);
          rv[u] = __ldg(a.rel + static_cast<int64_t>(s_type[i + u]) * a.width + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u < n) Agg::add(acc, s_w[i + u], rv[u], xv[u]);
      }
    }
  }
  if (piece < a.num_pieces && mine) {
    const int32_t slot = a.piece_slot[piece];
    float4* row = slot < 0 ? a.out + static_cast<int64_t>(a.piece_row[piece]) * a.width
                           : a.partial + static_cast<int64_t>(slot) * a.width;
    row[j] = acc;
  }
}

template <class Agg>
__global__ void __launch_bounds__(kBlock) long_row_kernel(const Operands a, int group) {
  const int g = threadIdx.x / group;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x / group) + g;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * group + (threadIdx.x - g * group);
  if (i >= a.num_long || j >= a.width) return;
  const int64_t first = a.long_slot_ptr[i];
  const int64_t end = a.long_slot_ptr[i + 1];
  float4 acc = a.partial[first * a.width + j];
#pragma unroll 4
  for (int64_t s = first + 1; s < end; ++s) Agg::merge(acc, a.partial[s * a.width + j]);
  a.out[static_cast<int64_t>(a.long_rows[i]) * a.width + j] = acc;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Checks what the walk needs, launches both passes on `stream` and returns
// cudaGetLastError() (0 on success). num_feat % 4 != 0, no piece, or a rel,
// x, out (or, with long rows, partial) not 16-byte aligned returns
// cudaErrorInvalidValue and launches nothing.
template <class Agg>
int launch(Operands a, long long num_feat, void* stream) {
  if (a.num_pieces <= 0 || a.num_long < 0 || num_feat <= 0 || num_feat % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(a.rel) || !aligned16(a.x) || !aligned16(a.out) ||
      (a.num_long > 0 && !aligned16(a.partial))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.width = num_feat / 4;
  const int group = group_size(a.width);
  const int groups = kBlock / group;
  const unsigned tiles = static_cast<unsigned>((a.width + group - 1) / group);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int32_t) * 3 * kStage * groups;
  const dim3 grid(static_cast<unsigned>((a.num_pieces + groups - 1) / groups), tiles);
  piece_kernel<Agg><<<grid, groups * group, smem, s>>>(a, group);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0 || a.num_long == 0) return status;
  const dim3 grid2(static_cast<unsigned>((a.num_long + groups - 1) / groups), tiles);
  long_row_kernel<Agg><<<grid2, groups * group, 0, s>>>(a, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pieces

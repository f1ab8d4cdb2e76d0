// The scorer for Hopper (sm_90a), S1: the entity model's scoring MLP over
// every node of a pass, in one pass over its last hidden state.
//
//   logit[m] = w2 . relu(h[m, :] @ W1[:, :64].T + qh[m % B, :]) + b2
//   qh[b, :] = q[b, :] @ W1[:, 64:].T + b1
//
// h (M, 64) f32 is the last conv's output viewed as (V * B, 64), node-major,
// so row m = v * B + b belongs to query b; q (B, 64) is the queries' relation
// states; W1 (128, 128) and b1 (128,) the MLP's first linear over
// [hidden | query], w2 (1, 128) and b2 (1,) its last. The query half of the
// first linear is the same for every node of a column, so it is computed
// once a block (B x 128 dots) and not once a row.
//
// It replaces no TPU kernel: the JAX package leaves the concatenation, both
// linears and the ReLU to XLA (ultra_tpu/models/nbfnet.py), which fuses them.
// On the card they were torch.cat (1 GB of [hidden | query] written at the
// ranking cell's 1,970,912 rows), a cuBLAS f32 GEMM that reads it back, the
// ReLU (1 GB read and written) and a gemv that reads it again.
//
// What bounds it on an H100: operations. A row is 2 * 64 * 128 f32
// operations (FFMA: no tensor cores, whose TF32 would round the operands),
// plus 2 * 128 for the ReLU and w2, against 260 bytes moved (its row of h
// read, its logit written): about 64 operations a byte, three times the
// card's f32 rate over its memory rate. So the design keeps the FFMA loop
// fed from shared memory, as E2's (conv_tail.cu), which runs the same 8,192
// FFMA a row:
// - persistent blocks, as many as fill the SMs at the occupancy that shared
//   memory allows for B, each staging W1's hidden half (transposed, k-major:
//   32 KB) and w2 in shared memory once, then computing qh into shared memory
//   (B x 128 f32), then walking tiles of BM = 64 rows. For qh each thread
//   holds one row of W1's query half in registers: read as the dots went,
//   the lanes' rows 512 bytes apart cost the L1 32 cycles a load, B times,
//   and the prologue took 0.15 ms at B = 32;
// - a ring of S = 2 stages a block, each tile's rows arriving by cp.async
//   (16 bytes a thread, past the L1), the ragged last tile zero-filled. At
//   B = 16 three blocks of 76 KB still fit an SM, and the second stage hides
//   the load behind the product (0.904 -> 0.850 ms at the ranking cell's
//   shape); at B = 32 it costs the third block, and one stage or two take
//   about the same time (0.228-0.238 ms);
// - each thread owns TR rows and 16 of the 128 columns of the first layer's
//   output (columns 4c..4c+3 + 32j, j = 0..3, of its lane's column group c):
//   for each 4 values of k it reads TR float4 of the staged rows and 16
//   float4 of W1, for 64 * TR FFMA. The loop over k is not unrolled further:
//   168 registers either way, and unrolled twice it was 1% slower;
// - no bank conflicts in the loop: a staged row is 64 floats and 4 of
//   padding, so the 4 rows a warp reads at once fall in 4 different groups of
//   4 banks; the 8 lanes of a row read 128 contiguous bytes of W1, which the
//   warp's 4 rows share;
// - the rest in registers: each thread adds qh of its rows' queries to its
//   16 values, applies the ReLU and sums their products with w2; the 8 lanes
//   of a row reduce that with 3 __shfl_xor_sync, and one lane writes the
//   row's logit, plus b2, once. Nothing of the (M, 128) hidden layer leaves
//   the registers.
// The products sum over k in order, the hidden half first, then qh is
// added: the association of the plain split form h @ W1h.T + (q @ W1q.T +
// b1), where the composed ops sum the 128 products of [h | q] in cuBLAS's
// order (tests/test_torch_mlp_score.py holds both within 1e-5).
//
// MLP_SCORE_SIZES (BM, TR, S) and the product's unrolling are a sweep's to
// edit. At 168 registers a thread, tiles of 128 rows (256 threads) hold one
// block an SM and were slower at the cells' shapes (1.00 ms); thread tiles
// of 2 rows (99 registers, four blocks) read W1 twice as often (1.24 ms).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#define MLP_SCORE_SIZES 64, 4, 2

namespace {

constexpr int kD = 64;        // the hidden state's width, and the query's
constexpr int kN = 128;       // the first linear's outputs
constexpr int kIn = 2 * kD;   // its inputs: [hidden | query]
constexpr int kRow = kD + 4;  // a staged row of h: 64 floats and 4 of padding
// the largest B whose qh a block holds (ops/mlp_score_cuda.py MAX_BATCH)
constexpr int kMaxBatch = 64;
constexpr int kMaxDevices = 64;  // the cards whose grids max_blocks keeps

template <int BM, int TR, int S>
struct Tile {
  static constexpr int kBM = BM;
  static constexpr int kThreads = BM * 8 / TR;  // 8 lanes a row
  static constexpr int kGroups = BM / TR;       // thread rows: a thread's rows lie this far apart
  static constexpr int kStage = BM * kRow;      // floats of a stage
  static constexpr int kChunks = BM * kD / 4;   // float4 of a stage's rows
  // W1's hidden half transposed, w2, the stages; qh (B x 128) after them
  static constexpr int kFixedBytes = (kD * kN + kN + S * kStage) * 4;
  static_assert(BM % TR == 0 && kThreads % 32 == 0 && kThreads <= 1024,
                "BM / TR thread rows of 8 lanes, whole warps");
  static_assert(kChunks % kThreads == 0 && S >= 1, "a stage's chunks over the threads");
  static_assert(kThreads % kN == 0, "whole rows of qh a pass of the block's threads");
};

template <int BM, int TR, int S>
constexpr int smem_bytes(int batch) {
  return Tile<BM, TR, S>::kFixedBytes + batch * kN * 4;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile `tile`'s rows of h into `stage`, a row past the end zero-filled.
template <int BM, int TR, int S>
__device__ __forceinline__ void load_tile(float* stage, const float* h, long long tile,
                                          long long rows) {
  using T = Tile<BM, TR, S>;
#pragma unroll
  for (int j = 0; j < T::kChunks / T::kThreads; ++j) {
    const int c = threadIdx.x + j * T::kThreads;
    const int r = c / (kD / 4), q = c % (kD / 4);
    const long long row = tile * BM + r;
    const bool live = row < rows;
    cp_async16(stage + r * kRow + q * 4, h + (live ? row * kD + q * 4 : 0), live);
  }
}

// acc[i][4j..4j+3] += a's row (group + kGroups * i) over k = 0..63 times
// w's rows k (128 floats each) at columns 4col + 32j.
template <int BM, int TR>
__device__ __forceinline__ void multiply(float (&acc)[TR][16], const float* a, const float* w,
                                         int group, int col) {
  constexpr int kGroups = BM / TR;
#pragma unroll 1
  for (int k0 = 0; k0 < kD; k0 += 4) {
    float4 av[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (group + kGroups * i) * kRow + k0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wv[j] = *reinterpret_cast<const float4*>(w + (k0 + kk) * kN + 32 * j + 4 * col);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float s = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][4 * j + 0] = fmaf(s, wv[j].x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(s, wv[j].y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(s, wv[j].z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(s, wv[j].w, acc[i][4 * j + 3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float row_sum(float v) {  // over the 8 lanes of a row
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

__device__ __forceinline__ float relu(float v) {
  return v < 0.0f ? 0.0f : v;  // a NaN passes, as F.relu passes it
}

template <int BM, int TR, int S>
__global__ void __launch_bounds__(Tile<BM, TR, S>::kThreads)
    mlp_score_kernel(const float* __restrict__ h, const float* __restrict__ q,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     float* __restrict__ out, long long rows, int batch) {
  using T = Tile<BM, TR, S>;
  extern __shared__ float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);  // (64, 128): wt[k * 128 + n] = w1[n * 128 + k]
  float* w2s = wt + kD * kN;
  float* stages = w2s + kN;
  float* qh = stages + S * T::kStage;  // (B, 128)
  const long long tiles = (rows + BM - 1) / BM;

  // the first tiles' loads go out before the weights are staged
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    const long long tile = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (tile < tiles) load_tile<BM, TR, S>(stages + s * T::kStage, h, tile, rows);
    cp_async_commit();
  }
  // W1's hidden half transposed: a warp's lanes take 32 consecutive n at one
  // quad of k, so that their stores fall in 32 banks
  for (int i = threadIdx.x; i < kN * kD / 4; i += T::kThreads) {
    const int n = i % kN, kq = i / kN;
    const float4 v = __ldg(reinterpret_cast<const float4*>(w1 + n * kIn) + kq);
    wt[(4 * kq + 0) * kN + n] = v.x;
    wt[(4 * kq + 1) * kN + n] = v.y;
    wt[(4 * kq + 2) * kN + n] = v.z;
    wt[(4 * kq + 3) * kN + n] = v.w;
  }
  for (int i = threadIdx.x; i < kN; i += T::kThreads) w2s[i] = __ldg(w2 + i);
  // the query half: qh[b, n] = q[b, :] . w1[n, 64:] + b1[n], k in order. A
  // thread keeps its n's row of w1 in registers (read once: the lanes' rows
  // lie 512 bytes apart, so a warp's load costs 32 of the L1's cycles) and
  // takes every (kThreads / 128)-th query, two at a time; a warp's lanes
  // share b, so q's reads are broadcast
  {
    const int n = threadIdx.x % kN, step = T::kThreads / kN;
    float4 wq[kD / 4];
#pragma unroll
    for (int k = 0; k < kD / 4; ++k) {
      wq[k] = __ldg(reinterpret_cast<const float4*>(w1 + n * kIn + kD) + k);
    }
    const float bn = __ldg(b1 + n);
    for (int b = threadIdx.x / kN; b < batch; b += 2 * step) {
      const int b2nd = b + step < batch ? b + step : b;
      const float4* q0 = reinterpret_cast<const float4*>(q + b * kD);
      const float4* q1 = reinterpret_cast<const float4*>(q + b2nd * kD);
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
      for (int k = 0; k < kD / 4; ++k) {
        const float4 u = __ldg(q0 + k), v = __ldg(q1 + k);
        acc0 = fmaf(u.x, wq[k].x, acc0);
        acc1 = fmaf(v.x, wq[k].x, acc1);
        acc0 = fmaf(u.y, wq[k].y, acc0);
        acc1 = fmaf(v.y, wq[k].y, acc1);
        acc0 = fmaf(u.z, wq[k].z, acc0);
        acc1 = fmaf(v.z, wq[k].z, acc1);
        acc0 = fmaf(u.w, wq[k].w, acc0);
        acc1 = fmaf(v.w, wq[k].w, acc1);
      }
      qh[b * kN + n] = acc0 + bn;
      qh[b2nd * kN + n] = acc1 + bn;  // b itself where b has no second
    }
  }
  const float bias2 = __ldg(b2);
  __syncthreads();

  const int col = threadIdx.x & 7;     // columns 4col..4col+3 + 32j
  const int group = threadIdx.x >> 3;  // rows group + kGroups * i of the tile
  const float4* w24 = reinterpret_cast<const float4*>(w2s);
  const float4 v0 = w24[col], v1 = w24[8 + col], v2 = w24[16 + col], v3 = w24[24 + col];
  const float wo[16] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                        v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};

  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const long long next = tile + static_cast<long long>(S - 1) * gridDim.x;
    if (next < tiles) {
      load_tile<BM, TR, S>(stages + ((it + S - 1) % S) * T::kStage, h, next, rows);
    }
    cp_async_commit();
    cp_async_wait<S - 1>();  // this tile's group has landed
    __syncthreads();

    float acc[TR][16];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;
    }
    multiply<BM, TR>(acc, stages + (it % S) * T::kStage, wt, group, col);

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const long long row = tile * BM + group + T::kGroups * i;
      const float4* qr = reinterpret_cast<const float4*>(qh + (row % batch) * kN);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 qv = qr[8 * j + col];
        s = fmaf(wo[4 * j + 0], relu(acc[i][4 * j + 0] + qv.x), s);
        s = fmaf(wo[4 * j + 1], relu(acc[i][4 * j + 1] + qv.y), s);
        s = fmaf(wo[4 * j + 2], relu(acc[i][4 * j + 2] + qv.z), s);
        s = fmaf(wo[4 * j + 3], relu(acc[i][4 * j + 3] + qv.w), s);
      }
      s = row_sum(s);
      if (col == 0 && row < rows) out[row] = s + bias2;
    }
    __syncthreads();  // the stage is free for the next tile's load
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The grid that fills the current card at the kernel's occupancy for
// `batch`, found once a card and batch (0 where the card refuses it). The
// shared-memory attribute it sets first is the card's own, so a card that
// has not been asked yet sets it before its first launch.
template <int BM, int TR, int S>
long long max_blocks(int batch) {
  static std::atomic<long long> found[kMaxDevices][kMaxBatch + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  long long blocks = found[dev][batch].load(std::memory_order_relaxed);
  if (blocks == 0) {
    using T = Tile<BM, TR, S>;
    const auto kernel = mlp_score_kernel<BM, TR, S>;
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<BM, TR, S>(kMaxBatch)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, T::kThreads, smem_bytes<BM, TR, S>(batch)) != cudaSuccess) {
      return 0;
    }
    blocks = static_cast<long long>(sms) * per_sm;
    found[dev][batch].store(blocks, std::memory_order_relaxed);
  }
  return blocks;
}

// As many blocks as fill the card, or one a tile where there are fewer tiles.
template <int BM, int TR, int S>
int launch(const float* h, const float* q, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, long long rows, int batch, cudaStream_t stream) {
  using T = Tile<BM, TR, S>;
  const long long cap = max_blocks<BM, TR, S>(batch);
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (rows + BM - 1) / BM;
  mlp_score_kernel<BM, TR, S>
      <<<static_cast<unsigned>(tiles < cap ? tiles : cap), T::kThreads,
         smem_bytes<BM, TR, S>(batch), stream>>>(h, q, w1, b1, w2, b2, out, rows, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// h: (rows, 64) f32, row v * batch + b of query b; q: (batch, 64) f32;
// w1: (128, 128) f32, the first linear's weight over [hidden | query]; b1:
// (128,) f32; w2: (1, 128) f32 and b2: (1,) f32, the last linear; out:
// (rows,) f32, a buffer of its own. Contiguous on one device; h, q and w1
// 16-byte aligned. rows < 1, a batch outside 1..64, rows not a multiple of
// batch or an unaligned pointer returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int mlp_score(const void* h, const void* q, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, long long rows, int batch,
                         void* stream) {
  if (rows < 1 || batch < 1 || batch > kMaxBatch || rows % batch != 0 || !aligned16(h) ||
      !aligned16(q) || !aligned16(w1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<MLP_SCORE_SIZES>(
      static_cast<const float*>(h), static_cast<const float*>(q), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), rows, batch,
      static_cast<cudaStream_t>(stream));
}

// The grid mlp_score launches at `batch` where the rows fill it: the card's
// SMs times the blocks an SM holds, which shared memory and registers bound
// (0 where the card refuses the kernel, or batch is outside 1..64). Launches
// nothing; the stream is not used.
extern "C" int mlp_score_blocks(int batch, void*) {
  if (batch < 1 || batch > kMaxBatch) return 0;
  return static_cast<int>(max_blocks<MLP_SCORE_SIZES>(batch));
}

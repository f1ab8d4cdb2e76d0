// The conv's tail for Hopper (sm_90a), E2: everything a 64 -> 64 conv layer
// does at inference after its aggregation, in one pass over its rows.
//
//   out[m, :] = act(layer_norm(x[m, :] @ W[:, :64].T + u[m, :] @ W[:, 64:].T + bias))
//               + (x[m, :] where the short cut is on)
//
// x (M, 64) f32 is the layer's input, u (M, 64) its aggregated update with
// the boundary added, W (64, 128) and bias (64,) the layer's linear; the
// layer norm is nn.LayerNorm(64)'s (mean and biased variance of the row, eps
// inside the square root, then gamma and beta), act ReLU or the identity.
// The short cut's input is x itself (models/nbfnet.py's bellmanford), so the
// short cut reads nothing more. The order is the composed one's: the
// product and the bias, normalise, activate, then add the short cut.
//
// It replaces no TPU kernel: the JAX package leaves the concatenation, the
// linear, the layer norm and the short cut to XLA (ultra_tpu/models/
// layers.py), which fuses them. On the card they were torch.cat, a cuBLAS
// f32 GEMM that streams the cat's copy again, and E1 (conv_epilogue.cu):
// 5 GB moved at the ranking cell's 1,970,912 rows, where one pass needs 1.5.
//
// What bounds it on an H100: operations and bytes together. A row is
// 2 * 128 * 64 f32 operations (FFMA: no tensor cores, whose TF32 would round
// the operands) against 768 bytes moved, about 21 operations a byte, where
// the card's f32 rate over its memory rate is 20. So the loads stay in
// flight under the FFMA loop, and the loop runs at the FFMA rate:
// - persistent blocks, as many as fill the SMs at the instance's occupancy
//   (three of 128 threads an SM, which shared memory bounds), each staging W
//   (transposed, k-major: 32 KB), the bias, gamma and beta in shared memory
//   once, then walking tiles of BM = 64 rows;
// - a ring of S stages a block, each tile's x and u arriving by cp.async (16
//   bytes a thread, past the L1), the ragged last tile zero-filled. The
//   sweep found one stage fastest: while a block waits for its tile, the
//   SM's other two compute, and a second stage would cost the third block;
// - each thread owns TR rows and 8 columns of the tile's output (columns
//   4c..4c+3 and 32+4c..32+4c+3 of its lane's column group c): for each 4
//   values of k it reads TR float4 of the staged rows and 8 float4 of W,
//   for 32 * TR FFMA;
// - no bank conflicts: a staged row is 64 floats and 4 of padding, so the 4
//   rows a warp reads at once fall in 4 different groups of 4 banks; the 8
//   lanes of a row read 128 contiguous bytes of W, which the warp's 4 rows
//   share;
// - the epilogue in registers: a row's 64 outputs lie on its 8 lanes, so the
//   mean and then the sum of squared deviations are reduced with 3
//   __shfl_xor_sync each (two passes, as E1); gamma, beta, ReLU and the short
//   cut (x from the stage) follow, and each row is written once, in 16-byte
//   stores.
// - the bf16-x instance (ROUND_X; compute_dtype: bfloat16) takes the same f32
//   x, whose linear half the JAX package computes on x rounded to bf16 and
//   widened back (the rspmm's operand, promoted by the concatenation), while
//   its short cut adds x itself. Once a tile has landed, each thread reads
//   the TR x 8 values of x that its short cut adds, keeps them in registers
//   and writes them back rounded to bf16 (round to nearest even); the
//   threads' values partition the tile, so one barrier follows. BM * 64
//   conversions a tile, where rounding inside the product would repeat each
//   on the 8 lanes of its row. No extra shared memory, so the occupancy
//   stays three blocks an SM; the f32 instance's code is as it was.
// Without the loads it runs about as fast (the sweep's probe `noload`): the
// FFMA loop bounds it, at about 37 TFLOP/s, where cuBLAS's f32 GEMM reaches
// 36 on this shape and 52 on large square ones. A small M runs on one block
// a tile: a smaller tile, which spreads such a batch over more SMs, lost to
// the fixed cost of each block's staging of W (4,736 rows: 0.0114 ms in
// tiles of 32, 0.0100 in tiles of 64).
//
// CONV_TAIL_SIZES (BM, TR, S) and the product's unrolling are the sweep's to
// edit (scripts/torch_conv_tail_sweep.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#define CONV_TAIL_SIZES 64, 4, 1

namespace {

constexpr int kN = 64;         // the layer's width, in and out
constexpr int kK = 2 * kN;     // [x | u]
constexpr int kRow = kN + 4;   // a staged row of x or u: 64 floats and 4 of padding
constexpr int kMaxDevices = 64;  // the cards whose grids max_blocks keeps

template <int BM, int TR, int S>
struct Tile {
  static constexpr int kBM = BM;
  static constexpr int kThreads = BM * 8 / TR;   // 8 lanes a row
  static constexpr int kGroups = BM / TR;        // thread rows: a thread's rows lie this far apart
  static constexpr int kStage = 2 * BM * kRow;   // floats of a stage: x's rows, then u's
  static constexpr int kChunks = 2 * BM * kN / 4;  // float4 of a stage's rows
  static constexpr int kSmemBytes = (kK * kN + 3 * kN + S * kStage) * 4;
  static_assert(BM % TR == 0 && kThreads % 32 == 0 && kThreads <= 1024,
                "BM / TR thread rows of 8 lanes, whole warps");
  static_assert(kChunks % kThreads == 0 && S >= 1, "a stage's chunks over the threads");
};

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

// Tile `tile`'s rows of x and u into `stage`, a row past the end zero-filled.
template <int BM, int TR, int S>
__device__ __forceinline__ void load_tile(float* stage, const float* x, const float* u,
                                          long long tile, long long rows) {
  using T = Tile<BM, TR, S>;
#pragma unroll
  for (int j = 0; j < T::kChunks / T::kThreads; ++j) {
    const int c = threadIdx.x + j * T::kThreads;
    const int part = c / (BM * kN / 4);  // 0: x, 1: u
    const int r = (c / (kN / 4)) % BM, q = c % (kN / 4);
    const long long row = tile * BM + r;
    const bool live = row < rows;
    const float* src = (part ? u : x) + (live ? row * kN + q * 4 : 0);
    cp_async16(stage + part * BM * kRow + r * kRow + q * 4, src, live);
  }
}

// Rounds a float4 of x to bf16 (round to nearest even) and widens it back.
__device__ __forceinline__ float4 round_bf16(float4 v) {
  const float2 lo = __bfloat1622float2(__float22bfloat162_rn(make_float2(v.x, v.y)));
  const float2 hi = __bfloat1622float2(__float22bfloat162_rn(make_float2(v.z, v.w)));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// acc[i][:] += a's row (group + kGroups * i) over k = 0..63 times w's rows
// k (64 floats each: the thread's 8 columns).
template <int BM, int TR>
__device__ __forceinline__ void multiply(float (&acc)[TR][8], const float* a, const float* w,
                                         int group, int col) {
  constexpr int kGroups = BM / TR;
#pragma unroll 4
  for (int k0 = 0; k0 < kN; k0 += 4) {
    float4 av[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (group + kGroups * i) * kRow + k0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(w + (k0 + kk) * kN + 4 * col);
      const float4 w1 = *reinterpret_cast<const float4*>(w + (k0 + kk) * kN + 32 + 4 * col);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float s = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
        acc[i][0] = fmaf(s, w0.x, acc[i][0]);
        acc[i][1] = fmaf(s, w0.y, acc[i][1]);
        acc[i][2] = fmaf(s, w0.z, acc[i][2]);
        acc[i][3] = fmaf(s, w0.w, acc[i][3]);
        acc[i][4] = fmaf(s, w1.x, acc[i][4]);
        acc[i][5] = fmaf(s, w1.y, acc[i][5]);
        acc[i][6] = fmaf(s, w1.z, acc[i][6]);
        acc[i][7] = fmaf(s, w1.w, acc[i][7]);
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

template <bool RELU>
__device__ __forceinline__ float act(float v) {
  if constexpr (RELU) {
    return v < 0.0f ? 0.0f : v;  // a NaN passes, as F.relu passes it
  } else {
    return v;
  }
}

template <int BM, int TR, int S, bool RELU, bool RESIDUAL, bool ROUND_X>
__global__ void __launch_bounds__(Tile<BM, TR, S>::kThreads)
    conv_tail_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     float* __restrict__ out, long long rows, float eps) {
  using T = Tile<BM, TR, S>;
  extern __shared__ float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);  // (128, 64): wt[k * 64 + n] = w[n * 128 + k]
  float* params = wt + kK * kN;                 // bias, gamma, beta
  float* stages = params + 3 * kN;
  const long long tiles = (rows + BM - 1) / BM;

  // the first tiles' loads go out before W is staged
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    const long long tile = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (tile < tiles) load_tile<BM, TR, S>(stages + s * T::kStage, x, u, tile, rows);
    cp_async_commit();
  }
  // W transposed: a warp's lanes take 32 consecutive n at one quad of k, so
  // that their stores fall in 32 banks
  for (int i = threadIdx.x; i < kN * kK / 4; i += T::kThreads) {
    const int n = i % kN, kq = i / kN;
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + n * kK) + kq);
    wt[(4 * kq + 0) * kN + n] = v.x;
    wt[(4 * kq + 1) * kN + n] = v.y;
    wt[(4 * kq + 2) * kN + n] = v.z;
    wt[(4 * kq + 3) * kN + n] = v.w;
  }
  for (int i = threadIdx.x; i < 3 * kN; i += T::kThreads) {
    params[i] = i < kN ? __ldg(bias + i) : i < 2 * kN ? __ldg(gamma + i - kN)
                                                       : __ldg(beta + i - 2 * kN);
  }
  __syncthreads();

  const int col = threadIdx.x & 7;     // columns 4col..4col+3 and 32+4col..32+4col+3
  const int group = threadIdx.x >> 3;  // rows group + kGroups * i of the tile

  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const long long next = tile + static_cast<long long>(S - 1) * gridDim.x;
    if (next < tiles) {
      load_tile<BM, TR, S>(stages + ((it + S - 1) % S) * T::kStage, x, u, next, rows);
    }
    cp_async_commit();
    cp_async_wait<S - 1>();  // this tile's group has landed
    __syncthreads();

    float* xs = stages + (it % S) * T::kStage;
    // ROUND_X: the thread's own TR x 8 values of x, the ones its short cut
    // adds, kept unrounded in registers and rounded in place in the stage.
    // The threads' values partition the tile's x, so no value is rounded
    // twice or read by its owner after another thread rounded it.
    float shortcut[ROUND_X ? TR : 1][8];
    if constexpr (ROUND_X) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float4* row = reinterpret_cast<float4*>(xs + (group + T::kGroups * i) * kRow);
        const float4 r0 = row[col], r1 = row[8 + col];
        shortcut[i][0] = r0.x;
        shortcut[i][1] = r0.y;
        shortcut[i][2] = r0.z;
        shortcut[i][3] = r0.w;
        shortcut[i][4] = r1.x;
        shortcut[i][5] = r1.y;
        shortcut[i][6] = r1.z;
        shortcut[i][7] = r1.w;
        row[col] = round_bf16(r0);
        row[8 + col] = round_bf16(r1);
      }
      __syncthreads();  // the whole tile's x rounded before the product reads it
    }
    float acc[TR][8];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    multiply<BM, TR>(acc, xs, wt, group, col);
    multiply<BM, TR>(acc, xs + BM * kRow, wt + kN * kN, group, col);

    const float4* p4 = reinterpret_cast<const float4*>(params);
    const float4 b0 = p4[col], b1 = p4[8 + col];  // bias, gamma, beta: 16 float4 each
    const float4 g0 = p4[16 + col], g1 = p4[24 + col];
    const float4 e0 = p4[32 + col], e1 = p4[40 + col];
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float be[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = group + T::kGroups * i;
      float v[8], sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = acc[i][j] + b[j];
        sum += v[j];
      }
      const float mean = row_sum(sum) / static_cast<float>(kN);
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] -= mean;
        sq += v[j] * v[j];
      }
      const float rstd = rsqrtf(row_sum(sq) / static_cast<float>(kN) + eps);
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = act<RELU>(v[j] * rstd * g[j] + be[j]);
      if constexpr (RESIDUAL && ROUND_X) {
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] += shortcut[i][j];
      } else if constexpr (RESIDUAL) {
        const float4 r0 = *reinterpret_cast<const float4*>(xs + r * kRow + 4 * col);
        const float4 r1 = *reinterpret_cast<const float4*>(xs + r * kRow + 32 + 4 * col);
        o[0] += r0.x;
        o[1] += r0.y;
        o[2] += r0.z;
        o[3] += r0.w;
        o[4] += r1.x;
        o[5] += r1.y;
        o[6] += r1.z;
        o[7] += r1.w;
      }
      const long long row = tile * BM + r;
      if (row < rows) {
        float4* dst = reinterpret_cast<float4*>(out + row * kN);
        dst[col] = make_float4(o[0], o[1], o[2], o[3]);
        dst[8 + col] = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
    __syncthreads();  // the stage is free for the load the next tile issues
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The grid that fills the current card at the instance's occupancy, found
// once a card (0 where the card refuses the instance). The shared-memory
// attribute it sets first is the card's own, so a card that has not been
// asked yet sets it before its first launch.
template <int BM, int TR, int S, bool RELU, bool RESIDUAL, bool ROUND_X>
long long max_blocks() {
  static std::atomic<long long> found[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  long long blocks = found[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    using T = Tile<BM, TR, S>;
    const auto kernel = conv_tail_kernel<BM, TR, S, RELU, RESIDUAL, ROUND_X>;
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmemBytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::kThreads,
                                                      T::kSmemBytes) != cudaSuccess) {
      return 0;
    }
    blocks = static_cast<long long>(sms) * per_sm;
    found[dev].store(blocks, std::memory_order_relaxed);
  }
  return blocks;
}

struct Args {
  const float *x, *u, *w, *bias, *gamma, *beta;
  float* out;
  long long rows;
  float eps;
};

template <int BM, int TR, int S, bool RELU, bool RESIDUAL, bool ROUND_X>
int launch(const Args& a, long long blocks, cudaStream_t stream) {
  using T = Tile<BM, TR, S>;
  conv_tail_kernel<BM, TR, S, RELU, RESIDUAL, ROUND_X>
      <<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes, stream>>>(
          a.x, a.u, a.w, a.bias, a.gamma, a.beta, a.out, a.rows, a.eps);
  return static_cast<int>(cudaGetLastError());
}

// As many blocks as fill the card, or one a tile where there are fewer tiles.
template <bool RELU, bool RESIDUAL, bool ROUND_X>
int launch_act(const Args& a, cudaStream_t stream) {
  const long long cap = max_blocks<CONV_TAIL_SIZES, RELU, RESIDUAL, ROUND_X>();
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr long long kBM = Tile<CONV_TAIL_SIZES>::kBM;
  const long long tiles = (a.rows + kBM - 1) / kBM;
  return launch<CONV_TAIL_SIZES, RELU, RESIDUAL, ROUND_X>(a, tiles < cap ? tiles : cap, stream);
}

template <bool ROUND_X>
int launch_instance(const void* x, const void* u, const void* w, const void* bias,
                    const void* gamma, const void* beta, void* out, long long rows, float eps,
                    int relu, int residual, void* stream) {
  if (rows < 1 || !aligned16(x) || !aligned16(u) || !aligned16(w) || !aligned16(bias) ||
      !aligned16(gamma) || !aligned16(beta) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x),     static_cast<const float*>(u),
               static_cast<const float*>(w),     static_cast<const float*>(bias),
               static_cast<const float*>(gamma), static_cast<const float*>(beta),
               static_cast<float*>(out),         rows,
               eps};
  const auto s = static_cast<cudaStream_t>(stream);
  if (relu) {
    return residual ? launch_act<true, true, ROUND_X>(a, s)
                    : launch_act<true, false, ROUND_X>(a, s);
  }
  return residual ? launch_act<false, true, ROUND_X>(a, s)
                  : launch_act<false, false, ROUND_X>(a, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x, u, out: (rows, 64) f32; w: (64, 128) f32, the linear's weight over
// [x | u]; bias, gamma, beta: (64,) f32; relu: 1 for ReLU, 0 for none;
// residual: 1 to add x after the activation, 0 for no short cut.
// Contiguous on one device, 16-byte aligned; out a buffer of its own (not x
// or u). rows < 1 or an unaligned pointer returns cudaErrorInvalidValue and
// launches nothing.
extern "C" int conv_tail(const void* x, const void* u, const void* w, const void* bias,
                         const void* gamma, const void* beta, void* out, long long rows,
                         float eps, int relu, int residual, void* stream) {
  return launch_instance<false>(x, u, w, bias, gamma, beta, out, rows, eps, relu, residual,
                                stream);
}

// The bf16-x instance: the same arguments; the linear reads x rounded to
// bf16 (round to nearest even) and widened back, the short cut adds x as
// it is.
extern "C" int conv_tail_bf16_x(const void* x, const void* u, const void* w, const void* bias,
                                const void* gamma, const void* beta, void* out,
                                long long rows, float eps, int relu, int residual,
                                void* stream) {
  return launch_instance<true>(x, u, w, bias, gamma, beta, out, rows, eps, relu, residual,
                               stream);
}

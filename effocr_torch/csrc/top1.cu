// Fused masked top-1 inner-product retrieval: for each query row q_n,
// (max_c <q_n, p_c>, argmax_c) over the unmasked prototype rows, without
// storing the [N, C] similarity matrix.
//
// Replaces the TPU kernel effocr_tpu/kernels/pallas_retrieval.py
// (pallas_top1 -> _top1_kernel).  Contract (that of pallas_top1 and of
// effocr_torch/kernels/retrieval.py top1_plain): queries [N, D] float32
// (already L2-normalized), prototypes [C, D] float32, row mask [C]
// (0 = blacklisted); masked and padded rows score -1e30; ties go to the
// lowest index; a query whose every row is masked gets (-1e30, 0).
//
// What bounds it.  On the main path (Japanese vertical config: N = 4096
// crop slots = min(crop_batch, line_batch * max_det), C = 11,051 rows,
// D = 320) the work is 2*N*C*D = 2.90e10 float32 operations, 0.43 ms at
// the H100's 67 TFLOP/s of float32 SIMT; the bytes (queries and
// prototypes read once, 4096 scores and indices written) are 19.4 MB,
// 5.8 us at 3.35 TB/s.  So it is bound by float32 arithmetic.  Hopper's
// tensor cores have no float32 mode (TF32 keeps 10 mantissa bits and
// would move retrieval margins), so the product runs on the FMA units.
//
// Design.  A register-blocked float32 GEMM tile with the argmax fused
// into its epilogue:
//   - a block owns 128 queries and walks a contiguous range of
//     128-prototype tiles in index order (the loop that takes the place
//     of the TPU kernel's sequential grid axis over prototype tiles);
//   - for each prototype tile, 16-deep slices of the query tile and the
//     prototype tile are staged in shared memory (double-buffered through
//     registers, one barrier per slice) and each of the 256 threads
//     accumulates an 8x8 block of dot products with FFMA: 16 shared-memory
//     float4 loads per 64 FMAs per slice.  Holding the whole 128 x 320
//     query tile in shared memory instead would take 160 KB and leave one
//     block per SM; the slices are re-read from L2, which holds both
//     operands (19.4 MB < 50 MB);
//   - the epilogue masks each column, takes each row's best of the
//     thread's 8 columns, reduces across the 16 threads that share the
//     row with a butterfly of shuffles (higher score, else lower index:
//     the lowest index wins a tie inside a tile), and moves the running
//     (score, index) kept in registers only on a strict '>' (tiles come
//     in increasing index order, so a tie keeps the earlier tile);
//   - occupancy: N = 4096 gives only 32 query tiles for 132 SMs, so the
//     prototype tiles are split over a second grid axis.  top1_splits
//     picks the split count that minimises waves x tiles per split for
//     this card's SM count and this kernel's occupancy, as the runtime
//     reports it (at 129 registers a thread, one 256-thread block per SM:
//     4 splits of 22 tiles, 128 blocks, one wave on the main path).  Each
//     split writes a partial (score, index) per query; a second, small
//     kernel folds the splits in index order with a strict '>', so the
//     lower split keeps a tie.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // queries per block
constexpr int kBN = 128;  // prototypes per tile
constexpr int kBK = 16;   // depth of one shared-memory slice
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// Column (or row) j of a thread's 8: j < 4 -> g*4 + j, else 64 + g*4 + j-4.
__device__ __forceinline__ int lane_offset(int g, int j) {
  return (j < 4 ? 0 : 64 - 4) + g * 4 + j;
}

__global__ void __launch_bounds__(kThreads)
top1_partial_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const uint8_t* __restrict__ mask, int n, int c, int d,
                    int tiles_per_split, float* __restrict__ part_score,
                    int* __restrict__ part_idx) {
  __shared__ __align__(16) float as[2][kBK][kBM];
  __shared__ __align__(16) float bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group of the 8x8 block
  const int ty = tid >> 4;  // row group
  const int q0 = blockIdx.x * kBM;
  const int n_ctiles = (c + kBN - 1) / kBN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_ctiles);
  const int nk = (d + kBK - 1) / kBK;
  // loader: thread -> rows lrow and lrow + 64, depth lk..lk+3 (one float4)
  const int lrow = tid >> 2;
  const int lk = (tid & 3) * 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float best_s[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_s[i] = kNegInf;
    best_i[i] = 0;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * kBN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float4 qa[2], pb[2];
    auto load = [&](int k0) {
      const int k = k0 + lk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gq = q0 + lrow + h * 64;
        const int gp = c0 + lrow + h * 64;
        qa[h] = (gq < n && k < d)
                    ? *reinterpret_cast<const float4*>(q + (size_t)gq * d + k)
                    : zero;
        pb[h] = (gp < c && k < d)
                    ? *reinterpret_cast<const float4*>(p + (size_t)gp * d + k)
                    : zero;
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lrow + h * 64;
        as[buf][lk + 0][r] = qa[h].x;
        as[buf][lk + 1][r] = qa[h].y;
        as[buf][lk + 2][r] = qa[h].z;
        as[buf][lk + 3][r] = qa[h].w;
        bs[buf][lk + 0][r] = pb[h].x;
        bs[buf][lk + 1][r] = pb[h].y;
        bs[buf][lk + 2][r] = pb[h].z;
        bs[buf][lk + 3][r] = pb[h].w;
      }
    };

    load(0);
    store(0);
    __syncthreads();
    int cur = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const bool more = kt + 1 < nk;
      if (more) load((kt + 1) * kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      // the other buffer was last read before the previous barrier
      if (more) store(cur ^ 1);
      __syncthreads();
      cur ^= 1;
    }

    // epilogue: mask, per-row best of this tile, running best
    bool keep[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + lane_offset(tx, j);
      keep[j] = col < c && mask[col] != 0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float s = keep[0] ? acc[i][0] : kNegInf;
      int idx = c0 + lane_offset(tx, 0);
#pragma unroll
      for (int j = 1; j < 8; ++j) {  // columns in increasing index order
        const float v = keep[j] ? acc[i][j] : kNegInf;
        if (v > s) {
          s = v;
          idx = c0 + lane_offset(tx, j);
        }
      }
      // the 16 threads of a row group are 16 adjacent lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
        if (s2 > s || (s2 == s && i2 < idx)) {
          s = s2;
          idx = i2;
        }
      }
      if (s > best_s[i]) {
        best_s[i] = s;
        best_i[i] = idx;
      }
    }
  }

  if (tx == 0) {
    float* out_s = part_score + (size_t)blockIdx.y * n;
    int* out_i = part_idx + (size_t)blockIdx.y * n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + lane_offset(ty, i);
      if (row < n) {
        out_s[row] = best_s[i];
        out_i[row] = best_i[i];
      }
    }
  }
}

// Fold the per-split partials in split (= index) order; strict '>' keeps
// the lower split on a tie.
__global__ void top1_combine_kernel(const float* __restrict__ part_score,
                                    const int* __restrict__ part_idx, int n,
                                    int splits, float* __restrict__ score,
                                    int* __restrict__ idx) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float s = part_score[r];
  int i = part_idx[r];
  for (int k = 1; k < splits; ++k) {
    const float s2 = part_score[(size_t)k * n + r];
    if (s2 > s) {
      s = s2;
      i = part_idx[(size_t)k * n + r];
    }
  }
  score[r] = s;
  idx[r] = i;
}

}  // namespace

extern "C" {

// Number of prototype splits (grid.y) for n queries and c prototypes on
// the current device: the count that minimises waves x tiles per split,
// the fewest splits among equals.  Returns a negative cudaError_t on
// failure.
int top1_splits(int n, int c) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, top1_partial_kernel, kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long q_tiles = (n + kBM - 1) / kBM;
  const int c_tiles = (c + kBN - 1) / kBN;
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= c_tiles; ++s) {
    const int per = (c_tiles + s - 1) / s;
    const int used = (c_tiles + per - 1) / per;  // splits that get tiles
    if (used != s) continue;
    const long waves = (q_tiles * s + slots - 1) / slots;
    const long cost = waves * per;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

// queries [n, d], prototypes [c, d] float32 row-major with d % 4 == 0 and
// 16-byte aligned rows; mask [c] uint8/bool; score [n] float32, idx [n]
// int32; part_score/part_idx [splits, n] scratch (unused when splits is 1).
// Launches on `stream`; returns the cudaError_t of the launches.
int top1_launch(const void* queries, const void* prototypes,
                const void* mask, int n, int c, int d, int splits,
                void* part_score, void* part_idx, void* score, void* idx,
                void* stream) {
  if (n == 0) return 0;
  const int c_tiles = (c + kBN - 1) / kBN;
  const int per = (c_tiles + splits - 1) / splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = splits == 1 ? static_cast<float*>(score)
                          : static_cast<float*>(part_score);
  int* pi = splits == 1 ? static_cast<int*>(idx) : static_cast<int*>(part_idx);
  dim3 grid((n + kBM - 1) / kBM, splits);
  top1_partial_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(prototypes),
      static_cast<const uint8_t*>(mask), n, c, d, per, ps, pi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  top1_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      ps, pi, n, splits, static_cast<float*>(score), static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

const char* top1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

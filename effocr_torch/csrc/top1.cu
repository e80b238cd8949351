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
// Design (an earlier one staged 16-deep slices through registers with
// one barrier per slice, transposing stores with 4-way bank conflicts,
// one 129-register block per SM).  A register-blocked float32
// GEMM tile with the argmax fused into its epilogue:
//   - a block owns 128 queries and walks a contiguous range of
//     128-prototype tiles in index order (the loop that takes the place
//     of the TPU kernel's sequential grid axis over prototype tiles);
//   - operands reach shared memory by cp.async (16 bytes a thread, no
//     register staging) in a 3-stage ring of 32-deep slices, rows kept in
//     global order ([row][k]) with 4 floats of padding: one barrier per
//     32-deep slice (10 per tile at D = 320), and the loads of the next
//     two slices in flight while one is consumed.  The ring runs across
//     tile boundaries, so it never drains inside a block;
//   - thread (tx, ty) of 16 x 16 accumulates queries ty + 16 i and
//     prototypes tx + 16 j (i, j < 8) with FFMA; a warp holds 4 values of
//     ty and 8 of tx, so for each 4-deep step a shared float4 load reads
//     4 distinct query rows or 8 distinct prototype rows (36 floats apart:
//     disjoint 4-bank groups, no conflict), 16 loads per 256 FMAs;
//   - the epilogue masks each column, takes each row's best of the
//     thread's 8 columns (increasing index), reduces across the 8 lanes
//     that share the row in its warp with a butterfly of shuffles (higher
//     score, else lower index: the lowest index wins a tie inside a tile),
//     and lane lx = 0 moves that half-row's running (score, index), kept
//     in shared memory, only on a strict '>' (tiles come in increasing
//     index order, so a tie keeps the earlier tile); at the end the two
//     halves of each row fold the same way;
//   - __launch_bounds__(256, 2): 128 registers, 110 KB of shared memory a
//     block, so two blocks (16 warps) per SM.  At that cap ptxas spills
//     32 bytes of loop bookkeeping (a few local loads and stores per
//     32-deep slice of 2,048 FMAs a thread); an 8 x 4 thread tile with a
//     4-stage ring has no spills but ran slower on the main path's shape.
//     N = 4096 gives only 32 query tiles, so the prototype tiles are split
//     over a second grid axis: top1_splits picks the split count that
//     minimises waves x tiles per split for this card's SM count and this
//     kernel's occupancy, as the runtime reports it (8 splits of 11
//     tiles, 256 blocks, one wave on the main path).  Each split writes a
//     partial (score, index) per query; a second, small kernel folds the
//     splits in index order with a strict '>', so the lower split keeps a
//     tie.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;    // queries per block
constexpr int kBN = 128;    // prototypes per tile
constexpr int kBK = 32;     // depth of one ring stage
constexpr int kLd = kBK + 4;  // floats per shared row (padding: no conflicts)
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageFloats = (kBM + kBN) * kLd;
constexpr size_t kSmemBytes =
    (size_t)kStages * kStageFloats * sizeof(float) +
    2 * kBM * (sizeof(float) + sizeof(int));
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = full ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads, 2)
top1_partial_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const uint8_t* __restrict__ mask, int n, int c, int d,
                    int tiles_per_split, float* __restrict__ part_score,
                    int* __restrict__ part_idx) {
  extern __shared__ __align__(16) float smem[];
  // running best per row and per half of the columns: [2][kBM] each
  float* best_s = smem + kStages * kStageFloats;
  int* best_i = reinterpret_cast<int*>(best_s + 2 * kBM);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = warp & 1;        // which 8 of the 16 column threads
  const int lx = lane & 7;
  const int tx = half * 8 + lx;     // prototype columns tx + 16 j
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // query rows ty + 16 i
  const int q0 = blockIdx.x * kBM;
  const int n_ctiles = (c + kBN - 1) / kBN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_ctiles);
  const int nk = (d + kBK - 1) / kBK;
  const int steps = (t_end - t_begin) * nk;

  if (lx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best_s[half * kBM + ty + 16 * i] = kNegInf;
      best_i[half * kBM + ty + 16 * i] = 0;
    }
  }

  // loader: ring stage `stage` <- slice `step` (tile t_begin + step / nk,
  // depth (step % nk) * kBK): rows lrow + 32 h of each operand,
  // floats kc..kc+3 of the slice; 8 consecutive threads per 128-byte row
  // segment
  const int lrow = tid >> 3;
  const int kc = (tid & 7) * 4;
  const float* qrow = q + (size_t)(q0 + lrow) * d + kc;
  auto load = [&](int step, int stage) {
    const int c0 = (t_begin + step / nk) * kBN;
    const int k0 = (step % nk) * kBK;
    const bool kin = k0 + kc < d;
    const float* prow = p + (size_t)(c0 + lrow) * d + kc + k0;
    float* sa = smem + stage * kStageFloats + lrow * kLd + kc;
    float* sb = sa + kBM * kLd;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const bool qin = kin && q0 + lrow + 32 * h < n;
      const bool pin = kin && c0 + lrow + 32 * h < c;
      cp_async16(sa + 32 * h * kLd, qin ? qrow + k0 + (size_t)32 * h * d : q,
                 qin);
      cp_async16(sb + 32 * h * kLd, pin ? prow + (size_t)32 * h * d : p, pin);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // slice `step` has landed
    __syncthreads();               // ... for every thread; and the stage
                                   // read at step - 1 is free again
    if (step + kStages - 1 < steps)
      load(step + kStages - 1, (step + kStages - 1) % kStages);
    cp_async_commit();
    const float* sa = smem + (step % kStages) * kStageFloats + ty * kLd;
    const float* sb = smem + (step % kStages) * kStageFloats +
                      (kBM + tx) * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(sa + 16 * i * kLd + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(sb + 16 * j * kLd + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = dot4(a[i], b, acc[i][j]);
      }
    }

    if ((step + 1) % nk == 0) {
      // epilogue of tile t: mask, per-row best, running best
      const int c0 = (t_begin + step / nk) * kBN;
      unsigned keep = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < c && mask[col] != 0) keep |= 1u << j;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float s = (keep & 1u) ? acc[i][0] : kNegInf;
        int idx = c0 + tx;
#pragma unroll
        for (int j = 1; j < 8; ++j) {  // columns in increasing index order
          const float v = (keep >> j) & 1u ? acc[i][j] : kNegInf;
          if (v > s) {
            s = v;
            idx = c0 + tx + 16 * j;
          }
        }
        // the 8 threads of a row in this half are 8 adjacent lanes
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {
          const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
          const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
          if (s2 > s || (s2 == s && i2 < idx)) {
            s = s2;
            idx = i2;
          }
        }
        const int r = half * kBM + ty + 16 * i;
        if (lx == 0 && s > best_s[r]) {
          best_s[r] = s;
          best_i[r] = idx;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // fold the two column halves of each row: higher score, else lower index
  if (tx == 0) {
    float* out_s = part_score + (size_t)blockIdx.y * n;
    int* out_i = part_idx + (size_t)blockIdx.y * n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      float s = best_s[r];
      int idx = best_i[r];
      const float s2 = best_s[kBM + r];
      const int i2 = best_i[kBM + r];
      if (s2 > s || (s2 == s && i2 < idx)) {
        s = s2;
        idx = i2;
      }
      if (q0 + r < n) {
        out_s[q0 + r] = s;
        out_i[q0 + r] = idx;
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

// Lets the partial kernel take its dynamic shared memory (over the
// 48 KB default) on the current device, with the carveout at its most.
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      top1_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(top1_partial_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              100);
}

}  // namespace

extern "C" {

// Number of prototype splits (grid.y) for n queries and c prototypes on
// the current device: the count, up to one wave's worth, that minimises
// waves x tiles per split, the fewest splits among equals.  Returns a
// negative cudaError_t on failure.
int top1_splits(int n, int c) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = prepare();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, top1_partial_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long q_tiles = (n + kBM - 1) / kBM;
  const int c_tiles = (c + kBN - 1) / kBN;
  // no more splits than one wave of blocks holds: past that, each split
  // adds a partial per query to write and fold and takes no waves off
  const long max_splits = (slots + q_tiles - 1) / q_tiles;
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= c_tiles && s <= max_splits; ++s) {
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
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBM - 1) / kBM, splits);
  top1_partial_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(prototypes),
      static_cast<const uint8_t*>(mask), n, c, d, per, ps, pi);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  top1_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      ps, pi, n, splits, static_cast<float*>(score), static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

const char* top1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

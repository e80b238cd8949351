// Greedy-NMS keep mask for score-presorted boxes: a triangular
// suppression bitmask built by one kernel and scanned block-wise by a
// second.
//
// Replaces the TPU kernel effocr_tpu/kernels/pallas_nms.py
// (pallas_nms_mask -> _nms_kernel): keep[b, j] = 1 iff box j is valid
// and no kept, higher-ranked (lower-index) valid box i has
// IoU(i, j) = inter / (union + 1e-7) > thr, in float32.  The result is
// bit-identical to effocr_torch/kernels/nms.py nms_mask(presorted=True)
// and to the JAX reference.
//
// What bounds it.  The IoU tests: n_v^2 / 2 per image of n_v valid boxes
// (2.7e8 on the English path, B = 512, N = 1024, nearly all valid), 14
// float32 operations each and none of them an FMA, so about 0.11 ms at
// the H100's 33.5 T non-FMA float32 operations/s; the build issues more
// than those (the division-free test's products and compares, bit
// assembly, moves) and is bound by instruction issue.  The bytes (boxes
// and flags in, keep out) are 9 MB.  The greedy order adds a dependent
// chain per image that no amount of parallelism removes: its length is
// what the scan is designed around.
//
// Layout.  An image's boxes fall in W = ceil(N / 64) blocks of 64.  The
// mask holds, for each pair of blocks r <= w (an "item"; W(W+1)/2 of
// them, row-major by r), one 64-bit word per row i = 64r + b: bit c is
// set iff j = 64w + c > i, both valid, and IoU(i, j) > thr.  That is 70
// KB per image at N = 1024 (36 MB on the English path, which L2 holds)
// and lives in a scratch tensor the wrapper allocates, so N is not capped
// by shared memory (an earlier design held the full square mask of an
// image in one CTA's shared memory and refused N > 1,280).
//
// 1. nms_build_kernel: one warp per item, every item of every image in
//    one grid, so work follows the valid boxes and no image's size sets
//    the launch's tail.  Lane l owns rows 64r + l and 64r + 32 + l in
//    registers and walks the item's 64 columns, staged once in the warp's
//    shared memory and read as broadcasts; it sets its own words' bits
//    (the division-free test below, branch-free, then the division on
//    the few pairs it leaves open), so no ballot and no shared store of
//    the mask, and the warp stores its 64 words in two coalesced 256-byte
//    stores.  An item whose rows are all invalid is never read and is
//    skipped; one whose columns are all invalid stores zeros.  Diagonal
//    items record each block's valid bits for the scan.  59 registers and
//    10 KB of shared memory per 8-warp CTA: 4 CTAs (32 warps) per SM.
// 2. nms_scan_kernel: one warp per image.  For each block r below the
//    last valid one: the 64 diagonal words (prefetched during the previous
//    block) are put in shared memory and every lane resolves the block's
//    greedy order in registers, a 64-step chain of bit tests and ORs on one
//    64-bit word; then the block's kept rows are ORed into the "removed"
//    words of the later blocks, rows on lanes, combined with
//    __reduce_or_sync, 8 words' loads in flight.  Its length grows with the
//    number of 64-box blocks (and the loads with the kept rows), not one
//    dependent step per box.
//
// Bit-identity: every float operation is an explicitly rounded
// intrinsic in the reference's order (pallas_nms.py:74-85, nms.py
// pairwise_iou), and the build passes -fmad=false.  The division is
// skipped only where its outcome is proven.  Let d = RN(RN(area_i +
// area_j) - inter) + 1e-7, as the reference computes it: inter <= both
// areas (rounding is monotone), so d >= 1e-7; and d < 1e30 when both
// areas are below 1e29.  Let lo and hi be the threshold moved down and up
// by 2^-17 of itself, rounded to float (at least 2^-18 away), with 2^-60
// <= thr <= 4, so neither RN(lo d) nor RN(hi d) under- or overflows:
//   inter >  RN(hi d)  =>  inter / d > thr (1 + 2^-18)(1 - 2^-24), more
//     than half an ulp above thr, so RN(inter / d) > thr;
//   inter <= RN(lo d)  =>  inter / d <= thr (1 - 2^-18)(1 + 2^-24) < thr,
//     so RN(inter / d) <= thr.
// Anything else (near the threshold, thr = 0 or out of that range, a box
// of area 1e29 or more) takes __fdiv_rn.  The wrapper computes lo, hi and
// the flag (kernels/cuda_nms.py fast_test_bounds); the CPU tests emulate
// the test and check it against the division on every pair.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBuildWarps = 8;   // items per build CTA
constexpr int kScanWarps = 4;    // images per scan CTA
constexpr unsigned kFull = 0xffffffffu;
using u64 = unsigned long long;

struct Thresh {
  float thr, lo, hi;
  int fast;
};

__device__ __forceinline__ float area_of(float4 a) {
  return __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.0f),
                   fmaxf(__fsub_rn(a.w, a.y), 0.0f));
}

// inter and d = union + 1e-7 of boxes a and b, in the reference's order
__device__ __forceinline__ void overlap(float4 a, float area_a, float4 b,
                                        float area_b, float& inter,
                                        float& d) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  inter = __fmul_rn(iw, ih);
  d = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
}

// IoU > thr by the division, as the reference decides it
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float thr) {
  float inter, d;
  overlap(a, area_a, b, area_b, inter, d);
  return __fdiv_rn(inter, d) > thr;
}

// ~0u where a > b, else 0 (PTX set: one instruction, no predicate)
__device__ __forceinline__ unsigned gt_mask(float a, float b) {
  unsigned r;
  asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(r) : "f"(a), "f"(b));
  return r;
}

// The division-free test of one pair (d < 1e30: see the note above),
// shifted in as the next lower bit: `above_hi` gets inter > RN(hi d),
// which proves IoU > thr, and `above_lo` gets inter > RN(lo d); inter <=
// RN(lo d) proves IoU <= thr, so only the pairs in above_lo & ~above_hi
// stay open.
__device__ __forceinline__ void fast_test(float4 a, float area_a, float4 b,
                                          float area_b, const Thresh& t,
                                          unsigned& above_hi,
                                          unsigned& above_lo) {
  float inter, d;
  overlap(a, area_a, b, area_b, inter, d);
  above_hi = (above_hi << 1) + (gt_mask(inter, __fmul_rn(t.hi, d)) >> 31);
  above_lo = (above_lo << 1) + (gt_mask(inter, __fmul_rn(t.lo, d)) >> 31);
}

// bits of columns c > b of a 64-column word
__device__ __forceinline__ u64 above(int b) {
  return b >= 63 ? 0ull : ~0ull << (b + 1);
}

__global__ void __launch_bounds__(kBuildWarps * 32)
nms_build_kernel(const float4* __restrict__ boxes,
                 const uint8_t* __restrict__ valid, u64* __restrict__ mask,
                 u64* __restrict__ vbits, int n, int words, int items,
                 int ctas_per_img, Thresh t) {
  __shared__ float4 sbox[kBuildWarps][64];
  __shared__ float sarea[kBuildWarps][64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int img = blockIdx.x / ctas_per_img;
  const int item = (blockIdx.x - img * ctas_per_img) * kBuildWarps + warp;
  if (item >= items) return;  // warp-uniform; the kernel has no CTA barrier
  int r = 0, rest = item;     // item -> (row block r, column block w)
  while (rest >= words - r) {
    rest -= words - r;
    ++r;
  }
  const int w = r + rest;
  const float4* gbox = boxes + (size_t)img * n;
  const uint8_t* gval = valid + (size_t)img * n;

  const int i0 = 64 * r + lane, i1 = i0 + 32;
  const bool vi0 = i0 < n && gval[i0] != 0;
  const bool vi1 = i1 < n && gval[i1] != 0;
  const u64 rowbits = (u64)__ballot_sync(kFull, vi1) << 32 |
                      __ballot_sync(kFull, vi0);
  if (w == r && lane == 0) vbits[(size_t)img * words + r] = rowbits;
  if (rowbits == 0) return;  // no valid row: the scan never reads the item

  const int j0 = 64 * w + lane, j1 = j0 + 32;
  const bool vj0 = j0 < n && gval[j0] != 0;
  const bool vj1 = j1 < n && gval[j1] != 0;
  const u64 colbits = (u64)__ballot_sync(kFull, vj1) << 32 |
                      __ballot_sync(kFull, vj0);
  u64 m0 = 0, m1 = 0;
  if (colbits != 0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 c0 = j0 < n ? gbox[j0] : zero;
    const float4 c1 = j1 < n ? gbox[j1] : zero;
    sbox[warp][lane] = c0;
    sbox[warp][lane + 32] = c1;
    sarea[warp][lane] = area_of(c0);
    sarea[warp][lane + 32] = area_of(c1);
    const float4 a0 = i0 < n ? gbox[i0] : zero;
    const float4 a1 = i1 < n ? gbox[i1] : zero;
    const float aa0 = area_of(a0), aa1 = area_of(a1);
    __syncwarp();
    // columns c and c + 32 per step: bit c of the low and high halves.
    // The division-free test runs branch-free on every pair; the pairs it
    // leaves open (near the threshold: rare) take the division after.  It
    // needs d < 1e30, which holds on every pair of the item when every box
    // of it has an area below 1e29 (warp-uniform); else every pair is open.
    const bool small = __all_sync(kFull, aa0 < 1e29f && aa1 < 1e29f &&
                                             sarea[warp][lane] < 1e29f &&
                                             sarea[warp][lane + 32] < 1e29f);
    unsigned lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;  // above hi: IoU > thr
    unsigned ulo0 = ~0u, uhi0 = ~0u, ulo1 = ~0u, uhi1 = ~0u;  // above lo
    if (t.fast && small) {
      ulo0 = uhi0 = ulo1 = uhi1 = 0;
      // columns from the last: after 32 shifts, bit c is column c
#pragma unroll 8
      for (int c = 31; c >= 0; --c) {
        const float4 bl = sbox[warp][c], bh = sbox[warp][c + 32];
        const float al = sarea[warp][c], ah = sarea[warp][c + 32];
        fast_test(a0, aa0, bl, al, t, lo0, ulo0);
        fast_test(a0, aa0, bh, ah, t, hi0, uhi0);
        fast_test(a1, aa1, bl, al, t, lo1, ulo1);
        fast_test(a1, aa1, bh, ah, t, hi1, uhi1);
      }
    }
    // the bits the item keeps: valid rows, valid columns, j > i
    const u64 live0 = vi0 ? colbits & (w == r ? above(lane) : ~0ull) : 0;
    const u64 live1 = vi1 ? colbits & (w == r ? above(lane + 32) : ~0ull) : 0;
    m0 = (u64)hi0 << 32 | lo0;
    m1 = (u64)hi1 << 32 | lo1;
    u64 open0 = ((u64)uhi0 << 32 | ulo0) & ~m0 & live0;
    u64 open1 = ((u64)uhi1 << 32 | ulo1) & ~m1 & live1;
    for (; open0; open0 &= open0 - 1) {
      const int c = __ffsll(open0) - 1;
      if (suppresses(a0, aa0, sbox[warp][c], sarea[warp][c], t.thr))
        m0 |= 1ull << c;
    }
    for (; open1; open1 &= open1 - 1) {
      const int c = __ffsll(open1) - 1;
      if (suppresses(a1, aa1, sbox[warp][c], sarea[warp][c], t.thr))
        m1 |= 1ull << c;
    }
    m0 &= live0;
    m1 &= live1;
  }
  u64* out = mask + ((size_t)img * items + item) * 64;
  out[lane] = m0;
  out[lane + 32] = m1;
}

__global__ void __launch_bounds__(kScanWarps * 32)
nms_scan_kernel(const u64* __restrict__ mask, const u64* __restrict__ vbits,
                uint8_t* __restrict__ keep, int b, int n, int words,
                int items) {
  extern __shared__ u64 smem[];  // per warp: valid[words], removed[words],
                                 // diag[64]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int img = blockIdx.x * kScanWarps + warp;
  if (img >= b) return;  // warp-uniform; the kernel has no CTA barrier
  u64* sval = smem + (size_t)warp * (2 * words + 64);
  u64* removed = sval + words;
  u64* diag = removed + words;
  const u64* gmask = mask + (size_t)img * items * 64;
  uint8_t* gkeep = keep + (size_t)img * n;

  int last = 0;  // 1 + the last block holding a valid box
  for (int r = lane; r < words; r += 32) {
    const u64 v = vbits[(size_t)img * words + r];
    sval[r] = v;
    removed[r] = 0;
    if (v) last = r + 1;
  }
  const int w_eff = __reduce_max_sync(kFull, (unsigned)last);
  __syncwarp();

  // item (r, w) starts at item_base(r) + (w - r)
  auto item_base = [&](int r) { return r * words - r * (r - 1) / 2; };
  u64 d0 = 0, d1 = 0;
  if (w_eff > 0) {
    d0 = gmask[lane];
    d1 = gmask[lane + 32];
  }
  for (int r = 0; r < w_eff; ++r) {
    const int base = item_base(r);
    diag[lane] = d0;
    diag[lane + 32] = d1;
    __syncwarp();
    if (r + 1 < w_eff) {  // prefetch the next block's diagonal item
      const u64* nd = gmask + (size_t)item_base(r + 1) * 64;
      d0 = nd[lane];
      d1 = nd[lane + 32];
    }
    // the block's greedy order: a box is kept iff valid and not removed
    // by a kept box of an earlier block or an earlier row of this one.
    // Branch-free on 32-bit halves: row c < 32 tests and extends the low
    // half (its diagonal word also reaches the high half); row c >= 32
    // only the high half.
    const u64 rem = removed[r] | ~sval[r];
    unsigned rlo = (unsigned)rem, rhi = (unsigned)(rem >> 32);
    unsigned klo = 0, khi = 0;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const unsigned take = ((rlo >> c) & 1u) - 1u;  // ~0 iff row c is kept
      klo |= take & (1u << c);
      rlo |= take & (unsigned)diag[c];
      rhi |= take & (unsigned)(diag[c] >> 32);
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const unsigned take = ((rhi >> c) & 1u) - 1u;
      khi |= take & (1u << c);
      rhi |= take & (unsigned)(diag[c + 32] >> 32);
    }
    const u64 kept = (u64)khi << 32 | klo;
    const int i0 = 64 * r + lane, i1 = i0 + 32;
    const bool k0 = (klo >> lane) & 1u;
    const bool k1 = (khi >> lane) & 1u;
    if (i0 < n) gkeep[i0] = k0;
    if (i1 < n) gkeep[i1] = k1;
    // the kept rows remove what they overlap in the later blocks: rows on
    // lanes, 8 words' loads in flight at a time
    if (kept != 0) {
      for (int w0 = r + 1; w0 < w_eff; w0 += 8) {
        u64 x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const u64* it = gmask + (size_t)(base + w0 + k - r) * 64;
          const bool in = w0 + k < w_eff;
          x[k] = (in && k0 ? it[lane] : 0ull) | (in && k1 ? it[lane + 32] : 0ull);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const unsigned lo = __reduce_or_sync(kFull, (unsigned)x[k]);
          const unsigned hi = __reduce_or_sync(kFull, (unsigned)(x[k] >> 32));
          if (lane == 0 && w0 + k < w_eff) removed[w0 + k] |= (u64)hi << 32 | lo;
        }
      }
    }
    __syncwarp();
  }
  for (int j = 64 * w_eff + lane; j < n; j += 32) gkeep[j] = 0;
}

}  // namespace

extern "C" {

// boxes [b, n, 4] float32, valid [b, n] uint8/bool, keep [b, n] uint8/bool,
// scratch: b * items * 64 + b * words 64-bit words (items = words * (words
// + 1) / 2, words = ceil(n / 64)); all contiguous on the current device.
// lo, hi, fast: the proven division-free test (see the note above).
// Launches both kernels on `stream`; returns the cudaError_t of the
// launches (0 = success).
int nms_mask_launch(const void* boxes, const void* valid, void* keep,
                    void* scratch, int b, int n, float thr, float lo,
                    float hi, int fast, void* stream) {
  if (b == 0 || n == 0) return 0;
  const int words = (n + 63) / 64;
  const int items = words * (words + 1) / 2;
  const int ctas_per_img = (items + kBuildWarps - 1) / kBuildWarps;
  u64* mask = static_cast<u64*>(scratch);
  u64* vbits = mask + (size_t)b * items * 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Thresh t{thr, lo, hi, fast};
  nms_build_kernel<<<(unsigned)((size_t)b * ctas_per_img), kBuildWarps * 32,
                     0, st>>>(static_cast<const float4*>(boxes),
                              static_cast<const uint8_t*>(valid), mask,
                              vbits, n, words, items, ctas_per_img, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kScanWarps * (2 * words + 64) * sizeof(u64);
  nms_scan_kernel<<<(b + kScanWarps - 1) / kScanWarps, kScanWarps * 32, smem,
                    st>>>(mask, vbits, static_cast<uint8_t*>(keep), b, n,
                          words, items);
  return (int)cudaGetLastError();
}

const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

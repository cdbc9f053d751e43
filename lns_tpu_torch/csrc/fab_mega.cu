// The FAB core's apply pair recomputed in each of two passes, so that the
// head-major values bb never reach device memory: a statistics pass (per
// sample and head, the Gram matrix and the column sums of the rounded apply
// pair) and an apply pass (the apply pair again, its product with a per-head
// c x o matrix, summed over the heads); and the interior dot, their second
// apply, on its own.
//
// Replaces benchmarks/probe_fab_mega.py: stats_pass (_stats_kernel),
// apply_pass (_apply_kernel), and the forms of `piece` that are an interior
// dot (A, and B2: the same function with the same output memory).
//
// Shapes: h = w = 32, c = 64, bf16 (the probe's; lns_fab_mega_limit and
// lns_interior_dot_limit state them), any batch b and heads n:
//   u_t [b, w, h, c] (u with h and w swapped), kx [b, n, h, h], ky [b, n, w, w]
//   a  = bf16(ky . u_t)    [l, h, c]   contracts w, f32 sums
//   bb = kx . a            [i, l, c]   contracts h, f32 sums
//   b2 = bf16(bb)          [(i l), c]
//   statistics: G = b2^T b2 [c, c] and s = the column sums of b2 [c], f32,
//               per (b, n);
//   apply:      out[b] = bf16(sum_n b2_n . m[b, n] - bias[b])  [(i l), o],
//               f32 sums;
//   interior dot: kx [i, h] . a [l, h, c] -> bf16 [i, l, c], f32 sums.
//
// What bounds them on an H100: operations. Per (b, n) 16.8 MFLOP (two
// applies of 4.2 and the Gram or the c -> o product of 8.4) against 128 KB of
// u that a sample's heads share: about 130 FLOP per byte of u read once per
// head, 1,000 per byte of u read once per sample. A block keeps its sample's
// u [32 w, 2048 (h c)] in shared memory (cp.async, rows padded to 2,056
// elements so ldmatrix finds eight distinct banks) and walks l in tiles of 8
// rows, all products on mma.sync m16n8k16 (f32 accumulators):
//   1. a for the tile, transposed: a^T [(h c), l] = u^T . ky^T, M = 2048
//      (256 rows a warp), N = 8, K = 32; rounded and stored [l][h][c];
//   2. warp w takes l = l0 + w: bb [32 i, 64 c] = kx . a[l] (M 32, N 64,
//      K 32), rounded to bf16 in registers;
//   3. statistics: b2's 256 rows of the tile go to shared memory; each warp
//      adds a 16 x 32 piece of G (K = 256) kept in registers across the
//      tiles, and 4 threads a column add the column sums.
//      apply: the m16n8 accumulator layout of two neighbouring n-tiles is the
//      m16k16 A-fragment layout, so b2 . m takes b2 from registers; the
//      block's [256, 64] f32 sum lives in registers across the heads, a
//      fixed order with no atomics.
// Grids: statistics (n, b), one block per sample and head (928 at b116 n8);
// apply (4 l-tiles, b), each block loops over the heads with u loaded once;
// interior dot ceil(l / 8). One block per SM (shared memory) in the passes.

#include <cstdio>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kS = 32;             // h = w
constexpr int kC = 64;             // c (and o)
constexpr int kHC = kS * kC;       // a row of u_t: (h c)
constexpr int kUP = kHC + 8;       // u's row stride in shared memory (elements)
constexpr int kKP = kS + 8;        // kx, ky row stride
constexpr int kCP = kC + 8;        // a, b2, m row stride
constexpr int kLT = 8;             // l rows per tile (one per warp)
constexpr int kAL = kS * kCP;      // a's stride between l rows
constexpr int kThreads = 256;
constexpr int kRows = kS * kLT;    // b2 rows per tile
static_assert(kThreads / 32 == kLT, "one warp per l row of a tile");

using bf16 = __nv_bfloat16;

constexpr size_t kUBytes = sizeof(bf16) * kS * kUP;
constexpr size_t kKBytes = sizeof(bf16) * 2 * kS * kKP;
constexpr size_t kABytes = sizeof(bf16) * kLT * kAL;
constexpr size_t kStatsSmem = kUBytes + kKBytes + kABytes + sizeof(bf16) * kRows * kCP +
                              sizeof(float) * 4 * kC;
constexpr size_t kApplySmem = kUBytes + kKBytes + kABytes + sizeof(bf16) * kC * kCP;
constexpr size_t kDotSmem = sizeof(bf16) * kS * kKP + kABytes;
static_assert(kStatsSmem <= lns::kMaxDynamicSmem && kApplySmem <= lns::kMaxDynamicSmem,
              "one block per SM");

// rows x cols bf16 (cols a multiple of 8) from global (row stride src_ld) to
// shared memory (row stride dst_ld) by 16-byte cp.async, all threads
__device__ __forceinline__ void load_rows(bf16* dst, int dst_ld, const bf16* src, int src_ld,
                                          int rows, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c8 = (e % per_row) * 8;
    lns::cp_async16(dst + r * dst_ld + c8, src + static_cast<size_t>(r) * src_ld + c8, true);
  }
}

// Step 1: a[l0 .. l0 + 7] = bf16(ky[l0 ..] . u_t) into a_s [l][h][c]; warp w
// computes the (h c) rows w * 256 .. w * 256 + 255 of a^T.
__device__ __forceinline__ void apply_ky(const bf16* u_s, const bf16* ky_s, bf16* a_s, int l0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t bk[2][2];  // ky^T [w, l], stored [l][w]: k16 x n8 for each half of w
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t r[2];
    lns::ldsm_x2(r, ky_s + lns::bt_addr(lane, l0, ks * 16, kKP));
    bk[ks][0] = r[0];
    bk[ks][1] = r[1];
  }
#pragma unroll 4
  for (int mt = 0; mt < kHC / 16 / kLT; ++mt) {
    const int m0 = warp * (kHC / kLT) + mt * 16;
    float acc[4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4];
      lns::ldsm_x4_trans(af, u_s + lns::at_addr(lane, ks * 16, m0, kUP));
      lns::mma_bf16(acc, af, bk[ks][0], bk[ks][1]);
    }
    // C fragment: (m = m0 + g (+ 8), n = l = 2t, 2t + 1); m = h * 64 + c
    bf16* p = a_s + (m0 / kC) * kCP + m0 % kC + g;
    p[(2 * t) * kAL] = __float2bfloat16(acc[0]);
    p[(2 * t + 1) * kAL] = __float2bfloat16(acc[1]);
    p[(2 * t) * kAL + 8] = __float2bfloat16(acc[2]);
    p[(2 * t + 1) * kAL + 8] = __float2bfloat16(acc[3]);
  }
}

// Step 2: this warp's bb [32 i, 64 c] = kx . a_l (a_l [h][c], stride kCP),
// f32 accumulators acc[i-tile][c-tile][4].
__device__ __forceinline__ void apply_kx(const bf16* kx_s, const bf16* a_l,
                                         float (&acc)[2][8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t af[2][4], bfr[4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      lns::ldsm_x4(af[mt], kx_s + lns::a_addr(lane, mt * 16, ks * 16, kKP));
#pragma unroll
    for (int np = 0; np < 4; ++np)
      lns::ldsm_x4_trans(bfr[np], a_l + lns::b_addr(lane, ks * 16, np * 16, kCP));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        lns::mma_bf16(acc[mt][nt], af[mt], bfr[nt / 2][nt % 2 * 2], bfr[nt / 2][nt % 2 * 2 + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fab_mega_stats_kernel(const bf16* __restrict__ u_t, const bf16* __restrict__ kx,
                      const bf16* __restrict__ ky, float* __restrict__ g_out,
                      float* __restrict__ s_out, int n) {
  extern __shared__ uint4 smem_stats[];
  bf16* u_s = reinterpret_cast<bf16*>(smem_stats);
  bf16* kx_s = u_s + kS * kUP;
  bf16* ky_s = kx_s + kS * kKP;
  bf16* a_s = ky_s + kS * kKP;
  bf16* b2_s = a_s + kLT * kAL;  // [kRows][kCP]
  float* red = reinterpret_cast<float*>(b2_s + kRows * kCP);  // [4][kC]
  const int hn = blockIdx.x, b = blockIdx.y;
  const size_t bn = static_cast<size_t>(b) * n + hn;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;

  load_rows(u_s, kUP, u_t + static_cast<size_t>(b) * kS * kHC, kHC, kS, kHC);
  load_rows(kx_s, kKP, kx + bn * kS * kS, kS, kS, kS);
  load_rows(ky_s, kKP, ky + bn * kS * kS, kS, kS, kS);
  lns::cp_async_commit();
  lns::cp_async_wait<0>();
  __syncthreads();

  const int gm = (warp % 4) * 16, gn = (warp / 4) * 32;  // this warp's piece of G
  float gacc[4][4] = {};
  float csum = 0.f;
  const int col = threadIdx.x % kC, q0 = threadIdx.x / kC;  // column-sum rows q0, q0 + 4, ...
  for (int l0 = 0; l0 < kS; l0 += kLT) {
    apply_ky(u_s, ky_s, a_s, l0);
    __syncthreads();  // a's tile is whole; the last tile's b2 is consumed
    float acc[2][8][4];
    apply_kx(kx_s, a_s + warp * kAL, acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        bf16* p = b2_s + (warp * kS + mt * 16 + g) * kCP + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = lns::pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * kCP) =
            lns::pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncthreads();  // b2's tile is whole; a's tile is consumed
#pragma unroll 4
    for (int ks = 0; ks < kRows / 16; ++ks) {
      uint32_t af[4], bfr[2][4];
      lns::ldsm_x4_trans(af, b2_s + lns::at_addr(lane, ks * 16, gm, kCP));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        lns::ldsm_x4_trans(bfr[np], b2_s + lns::b_addr(lane, ks * 16, gn + np * 16, kCP));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        lns::mma_bf16(gacc[nt], af, bfr[nt / 2][nt % 2 * 2], bfr[nt / 2][nt % 2 * 2 + 1]);
    }
    for (int r = q0; r < kRows; r += kThreads / kC) csum += __bfloat162float(b2_s[r * kCP + col]);
  }
  float* gp = g_out + bn * kC * kC;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int r = gm + g, e = gn + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(gp + r * kC + e) = make_float2(gacc[nt][0], gacc[nt][1]);
    *reinterpret_cast<float2*>(gp + (r + 8) * kC + e) = make_float2(gacc[nt][2], gacc[nt][3]);
  }
  red[q0 * kC + col] = csum;
  __syncthreads();
  if (threadIdx.x < kC) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kThreads / kC; ++q) v += red[q * kC + threadIdx.x];
    s_out[bn * kC + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fab_mega_apply_kernel(const bf16* __restrict__ u_t, const bf16* __restrict__ kx,
                      const bf16* __restrict__ ky, const bf16* __restrict__ m,
                      const bf16* __restrict__ bias, bf16* __restrict__ out, int n) {
  extern __shared__ uint4 smem_apply[];
  bf16* u_s = reinterpret_cast<bf16*>(smem_apply);
  bf16* kx_s = u_s + kS * kUP;
  bf16* ky_s = kx_s + kS * kKP;
  bf16* a_s = ky_s + kS * kKP;
  bf16* m_s = a_s + kLT * kAL;  // [kC][kCP]
  const int l0 = blockIdx.x * kLT, b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;

  load_rows(u_s, kUP, u_t + static_cast<size_t>(b) * kS * kHC, kHC, kS, kHC);
  float out_acc[2][8][4] = {};  // rows (i, l0 + warp), columns o
  for (int hn = 0; hn < n; ++hn) {
    const size_t bn = static_cast<size_t>(b) * n + hn;
    load_rows(kx_s, kKP, kx + bn * kS * kS, kS, kS, kS);
    load_rows(ky_s, kKP, ky + bn * kS * kS, kS, kS, kS);
    load_rows(m_s, kCP, m + bn * kC * kC, kC, kC, kC);
    lns::cp_async_commit();
    lns::cp_async_wait<0>();
    __syncthreads();
    apply_ky(u_s, ky_s, a_s, l0);
    __syncthreads();
    float acc[2][8][4];
    apply_kx(kx_s, a_s + warp * kAL, acc);
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) {
      uint32_t bfr[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        lns::ldsm_x4_trans(bfr[np], m_s + lns::b_addr(lane, ks * 16, np * 16, kCP));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // b2's A fragment for rows mt * 16 .., columns ks * 16 .. (C tiles 2ks, 2ks + 1)
        const uint32_t af[4] = {lns::pack_bf16(acc[mt][2 * ks][0], acc[mt][2 * ks][1]),
                                lns::pack_bf16(acc[mt][2 * ks][2], acc[mt][2 * ks][3]),
                                lns::pack_bf16(acc[mt][2 * ks + 1][0], acc[mt][2 * ks + 1][1]),
                                lns::pack_bf16(acc[mt][2 * ks + 1][2], acc[mt][2 * ks + 1][3])};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          lns::mma_bf16(out_acc[mt][nt], af, bfr[nt / 2][nt % 2 * 2],
                        bfr[nt / 2][nt % 2 * 2 + 1]);
      }
    }
    __syncthreads();  // kx, ky, m and a are consumed before the next head's loads
  }
  const bf16* bp = bias + static_cast<size_t>(b) * kC;
  const int l = l0 + warp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = mt * 16 + g, o = nt * 8 + 2 * t;
      const float b0 = __bfloat162float(bp[o]), b1 = __bfloat162float(bp[o + 1]);
      bf16* p = out + ((static_cast<size_t>(b) * kS + i) * kS + l) * kC + o;
      *reinterpret_cast<uint32_t*>(p) =
          lns::pack_bf16(out_acc[mt][nt][0] - b0, out_acc[mt][nt][1] - b1);
      *reinterpret_cast<uint32_t*>(p + 8 * kS * kC) =
          lns::pack_bf16(out_acc[mt][nt][2] - b0, out_acc[mt][nt][3] - b1);
    }
}

__global__ void __launch_bounds__(kThreads)
interior_dot_kernel(const bf16* __restrict__ kx, const bf16* __restrict__ a,
                    bf16* __restrict__ out, int l_dim) {
  extern __shared__ uint4 smem_dot[];
  bf16* kx_s = reinterpret_cast<bf16*>(smem_dot);
  bf16* a_s = kx_s + kS * kKP;
  const int l0 = blockIdx.x * kLT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int rows = l_dim - l0 < kLT ? l_dim - l0 : kLT;
  load_rows(kx_s, kKP, kx, kS, kS, kS);
  for (int r = 0; r < rows; ++r)
    load_rows(a_s + r * kAL, kCP, a + static_cast<size_t>(l0 + r) * kS * kC, kC, kS, kC);
  lns::cp_async_commit();
  lns::cp_async_wait<0>();
  __syncthreads();
  if (warp >= rows) return;
  float acc[2][8][4];
  apply_kx(kx_s, a_s + warp * kAL, acc);
  const int l = l0 + warp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = mt * 16 + g, c = nt * 8 + 2 * t;
      bf16* p = out + (static_cast<size_t>(i) * l_dim + l) * kC + c;
      *reinterpret_cast<uint32_t*>(p) = lns::pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<uint32_t*>(p + static_cast<size_t>(8) * l_dim * kC) =
          lns::pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// dtype bf16, the [32, 32] x c 64 shape (`dims` names the two sides), and
// `count` (the blocks' count: the batch b or the rows l) in [1, most]
const char* shape_limit(const char* dims, int dtype, int h, int w, int c, const char* count_name,
                        int count, int most) {
  static thread_local char msg[200];
  if (dtype != 1) {
    snprintf(msg, sizeof msg, "bf16 (the probe's dtype), got dtype code %d", dtype);
  } else if (h != kS || w != kS || c != kC) {
    snprintf(msg, sizeof msg, "%s %d, %d and c %d (the probe's shape), got %d, %d, c %d", dims,
             kS, kS, kC, h, w, c);
  } else if (count < 1 || count > most) {
    snprintf(msg, sizeof msg, "%s in [1, %d], got %d", count_name, most, count);
  } else {
    return nullptr;
  }
  return msg;
}

}  // namespace

// The limits of the statistics and apply passes (the one statement of
// them): nullptr when they take the shape, else the limit it breaks.
extern "C" const char* lns_fab_mega_limit(int dtype, int b, int h, int w, int c) {
  return shape_limit("h, w", dtype, h, w, c, "b (the grid's y)", b, 65535);
}

// The interior dot's: kx [i, k] . a [l, k, c].
extern "C" const char* lns_interior_dot_limit(int dtype, int l, int i, int k, int c) {
  return shape_limit("i, k", dtype, i, k, c, "l", l, 2147483647);
}

extern "C" int lns_fab_mega_stats(const void* u_t, const void* kx, const void* ky, void* g,
                                  void* s, int b, int n, void* stream) {
  if (lns_fab_mega_limit(1, b, kS, kS, kC) || n < 1) return cudaErrorInvalidValue;
  cudaError_t e = lns::allow_smem(fab_mega_stats_kernel, kStatsSmem);
  if (e != cudaSuccess) return e;
  fab_mega_stats_kernel<<<dim3(n, b), kThreads, kStatsSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(u_t), static_cast<const bf16*>(kx), static_cast<const bf16*>(ky),
      static_cast<float*>(g), static_cast<float*>(s), n);
  return cudaGetLastError();
}

extern "C" int lns_fab_mega_apply(const void* u_t, const void* kx, const void* ky, const void* m,
                                  const void* bias, void* out, int b, int n, void* stream) {
  if (lns_fab_mega_limit(1, b, kS, kS, kC) || n < 1) return cudaErrorInvalidValue;
  cudaError_t e = lns::allow_smem(fab_mega_apply_kernel, kApplySmem);
  if (e != cudaSuccess) return e;
  fab_mega_apply_kernel<<<dim3(kS / kLT, b), kThreads, kApplySmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(u_t), static_cast<const bf16*>(kx), static_cast<const bf16*>(ky),
      static_cast<const bf16*>(m), static_cast<const bf16*>(bias), static_cast<bf16*>(out), n);
  return cudaGetLastError();
}

extern "C" int lns_interior_dot(const void* kx, const void* a, void* out, int l, void* stream) {
  if (lns_interior_dot_limit(1, l, kS, kS, kC)) return cudaErrorInvalidValue;
  interior_dot_kernel<<<(l + kLT - 1) / kLT, kThreads, kDotSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(kx), static_cast<const bf16*>(a), static_cast<bf16*>(out), l);
  return cudaGetLastError();
}

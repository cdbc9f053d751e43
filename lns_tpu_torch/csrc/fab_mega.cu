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
// head, 1,000 per byte of u read once per sample. At b116 n8, 15.6 GFLOP:
// 0.0157 ms at 989 TFLOP/s, against 15.2 MB of u (0.0045 ms at 3.35 TB/s).
//
// The statistics pass (fab_mega_stats_wgmma, sm_90a: wgmma, TMA, mbarriers;
// hopper.cuh). Two plans read u once per sample:
//   per sample  a block per sample loops over its heads: b blocks (116, one
//               wave on 132 SMs, 16 idle), u_t 128 KB in shared memory for
//               all heads, kx and ky of the next heads prefetched; 134 MFLOP
//               a block.
//   cluster     a block per (sample, head), a sample's heads one cluster fed
//               by TMA multicast (kernel 2's statistics pass): 928 blocks,
//               one an SM (u's ring and a), clusters of 8, at most 16 of
//               them at once on 132 SMs: 116 / 16 = 7.25 -> 8 waves, the
//               last a quarter full.
// Taken: per sample. One wave without a ragged last one, no cluster barrier
// or multicast bookkeeping, and u lands once and stays. Shared memory,
// 230,672 bytes: u_t 131,072 (by h: each h's [32 w][64 c] an MN-major wgmma
// operand), a tile of 16 columns l 65,536 (8 pair blocks of 8 KB), kx and
// ky of two heads 16,384 (rows 128 bytes, columns 32 .. 63 zero), G and s
// passed between the warpgroups 16,640. Two warpgroups, 216 registers a
// thread. u by 16-byte cp.async in four slabs of 8 h (one commit group
// each: step 1 of the first head starts on the first two slabs; TMA boxes
// of one h, 32 rows of 128 bytes 4 KB apart, landed slower), kx and ky by
// TMA two heads ahead (thread 0, after each head's last read). Per head and
// l tile of 16:
//   1. a^T [c, l] = u_h^T [c, w] . ky_tile^T [w, l] (m64 n16 k16, u
//      MN-major, ky K-major), batches of 8 h, the warpgroups' in turn,
//      rounded to bf16 and stored K-major for step 2: a pair block holds a
//      warpgroup's two columns l, l + 2 as rows c, one column's 32 h in each
//      half row, so a batch's 8 h of one (c, l) are one 16-byte store and a
//      store's 32 pieces fill each bank group four times (stmatrix into a
//      [h][c] layout, the first version's, put 8 columns in one bank group:
//      8-way conflicts);
//   2. per pair block (each warpgroup its four) bb^T [c, i] = a_l^T . kx^T
//      (m64 n32 k16, both K-major), rounded to bf16: b2; its values added
//      to the column sums where they lie (rows c of the thread, the quad's
//      four sums added by shuffles at the head's end) and stored over the
//      pair block in the same K-major form (stmatrix, conflict-free);
//   3. G += b2^T b2 (m64 n64 k16), A = b2^T from the registers step 2 left
//      it in (two neighbouring n8 accumulator blocks are one k16 A
//      fragment), B = b2 K-major.
// G and s of a head: the first warpgroup's sums + the second's (its columns
// l = 0, 2, .. and 1, 3, ..), each warpgroup adding and storing half of the
// rows. The same function and rounding points as the plain version. Step 1
// (n16 products) and the Gram's per-pair waits and barriers keep it at
// about a quarter of its bound (PERF.md; probe_fab_mega.py --phases).
//
// The apply pass: a block keeps its sample's u [32 w, 2048 (h c)] in shared
// memory (cp.async, rows padded to 2,056 elements so ldmatrix finds eight
// distinct banks) and walks the heads for one tile of 8 rows l, all
// products on mma.sync m16n8k16 (f32 accumulators):
//   1. a for the tile, transposed: a^T [(h c), l] = u^T . ky^T, M = 2048
//      (256 rows a warp), N = 8, K = 32; rounded and stored [l][h][c];
//   2. warp w takes l = l0 + w: bb [32 i, 64 c] = kx . a[l] (M 32, N 64,
//      K 32), rounded to bf16 in registers;
//   3. the m16n8 accumulator layout of two neighbouring n-tiles is the
//      m16k16 A-fragment layout, so b2 . m takes b2 from registers; the
//      block's [256, 64] f32 sum lives in registers across the heads, a
//      fixed order with no atomics.
// Grids: statistics (b); apply (4 l-tiles, b), each block loops over the
// heads with u loaded once; interior dot ceil(l / 8). One block per SM
// (shared memory) in the passes.

#include <cstdio>

#include "common.cuh"
#include "hopper.cuh"
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
static_assert(kThreads / 32 == kLT, "one warp per l row of a tile");

using bf16 = __nv_bfloat16;

constexpr size_t kUBytes = sizeof(bf16) * kS * kUP;
constexpr size_t kKBytes = sizeof(bf16) * 2 * kS * kKP;
constexpr size_t kABytes = sizeof(bf16) * kLT * kAL;
constexpr size_t kApplySmem = kUBytes + kKBytes + kABytes + sizeof(bf16) * kC * kCP;
constexpr size_t kDotSmem = sizeof(bf16) * kS * kKP + kABytes;
static_assert(kApplySmem <= lns::kMaxDynamicSmem,
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

// ---- the statistics pass on wgmma (sm_90a; TMA, mbarriers, hopper.cuh) ------

constexpr int kWG = 2;                         // warpgroups
constexpr int kThreadsTc = 128 * kWG;
constexpr int kTL = 16;                        // columns l of a tile
constexpr int kSlab = 8;                       // h per cp.async group of u
constexpr int kHB = 8;                         // h per step-1 batch
constexpr int kBox = kS * 128;                 // one 32-row operand, 128-byte rows
constexpr int kPair = 2 * kBox;                // a pair block: two columns of a warpgroup
// column l's pair block: the warpgroup l % 2's columns l and l + 2 share one
__host__ __device__ constexpr int pair(int l) { return l % kWG + kWG * (l / (2 * kWG)); }
// shared memory, byte offsets from its first 1024-byte boundary: u_t by h
// ([w rows][64 c] each), a and then b2 of a tile by pair block ([c rows][2
// columns x 32 h or i]), kx and ky of two heads ([i or l rows][64 h or w, 32
// used]), the rows of G [c][c] and s [c] (f32) one warpgroup passes the
// other, the barriers
constexpr int kOffA = kS * kBox;
constexpr int kOffKx = kOffA + kTL * kBox;
constexpr int kOffKy = kOffKx + 2 * kBox;
constexpr int kOffG = kOffKy + 2 * kBox;
constexpr int kOffBar = kOffG + 4 * (kC * kC + kC);
constexpr size_t kStatsTcSmem = 1024 + kOffBar + 8 * 2;
static_assert(kWG == 2 && kHB == 8 && kS / kSlab == 4 && kTL % (2 * kWG) == 0,
              "two warpgroups, a pair block's two columns, batches of 8 h in slabs of 8");
static_assert(kStatsTcSmem <= lns::kMaxDynamicSmem, "one block per SM");

// Step 1 of h = h0 .. h0 + kHB - 1 (a warpgroup): a^T [c, l] = u_h^T [c, w] .
// ky_tile^T [w, l] (m64 n16 k16, u MN-major, ky K-major), rounded to bf16
// and stored K-major for step 2: column l in half l / 2 % 2 of pair block
// pair(l), rows c, its h along the row (the batch's kHB h of one (c, l) one
// 16-byte piece; a store's 32 pieces fill every bank group four times)
__device__ __forceinline__ void tc_step1(const uint8_t* u_s, const uint8_t* kyt, uint8_t* a_s,
                                         int h0, int wt) {
  float acc[kHB][8];
#pragma unroll
  for (int r = 0; r < kHB; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
    lns::wgmma_fence_regs(acc[r]);
  }
  lns::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kS / 16; ++ks) {
    const uint64_t db = lns::desc_kmajor(kyt + ks * 32);
#pragma unroll
    for (int r = 0; r < kHB; ++r)
      lns::wgmma<kTL, 1, 0>(acc[r], lns::desc_mnmajor(u_s + (h0 + r) * kBox + ks * 2048), db);
  }
  lns::wgmma_commit();
  lns::wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < kHB; ++r) lns::wgmma_fence_regs(acc[r]);
  // acc[r][4 k + 2 hf + e]: row c = 16 q + 8 hf + g, column l = 8 k + 2 u + e, h = h0 + r
  const int q = wt / 32, lane = wt % 32, g = lane / 4, u = lane % 4;
#pragma unroll
  for (int k = 0; k < kTL / 8; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = 8 * k + 2 * u + e;
      uint8_t* pb = a_s + pair(l) * kPair;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * k + 2 * hf + e;
        *reinterpret_cast<uint4*>(pb + lns::sw128(16 * q + 8 * hf + g, (l / 2 % 2) * kS + h0)) =
            make_uint4(lns::pack_bf16(acc[0][i], acc[1][i]), lns::pack_bf16(acc[2][i], acc[3][i]),
                       lns::pack_bf16(acc[4][i], acc[5][i]), lns::pack_bf16(acc[6][i], acc[7][i]));
      }
    }
}

// Step 2 of the warpgroup's two columns in pair block pb (a_l K-major, the
// first column in bytes 0 .. 63 of each row c, the second in 64 .. 127):
// bb^T [c, i] = a_l^T [c, h] . kx^T [h, i] (m64 n32 k16) into acc, issued
// as one commit group.
__device__ __forceinline__ void tc_step2(const uint8_t* pb, const uint8_t* kx_b,
                                         float (&acc)[2][16]) {
#pragma unroll
  for (int cl = 0; cl < 2; ++cl) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[cl][i] = 0.f;
    lns::wgmma_fence_regs(acc[cl]);
  }
  lns::wgmma_fence();
#pragma unroll
  for (int cl = 0; cl < 2; ++cl)
#pragma unroll
    for (int ks = 0; ks < kS / 16; ++ks)
      lns::wgmma<32, 0, 0>(acc[cl], lns::desc_kmajor(pb + cl * 64 + ks * 32),
                           lns::desc_kmajor(kx_b + ks * 32));
  lns::wgmma_commit();
}

// The pair's step 2 done (acc): b2 = bf16(bb) added to the column sums (s0:
// row c = 16 q + g, s1: c + 8) and stored over the pair block in the same
// K-major form (rows c, i along the row; stmatrix, conflict-free); then G +=
// b2^T b2 (m64 n64 k16) issued as one commit group, A = b2^T from the
// registers that hold it, B = b2 K-major, in column order into G.
__device__ __forceinline__ void tc_gram(uint8_t* pb, float (&acc)[2][16], float (&gacc)[32],
                                        float& s0, float& s1, int wg, int wt) {
  uint32_t p[2][8];  // p[.][2 k + hf]: rows c = 16 q + 8 hf + g, columns i = 8 k + 2 u, + 1
#pragma unroll
  for (int cl = 0; cl < 2; ++cl) {
    lns::wgmma_fence_regs(acc[cl]);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      p[cl][m] = lns::pack_bf16(acc[cl][2 * m], acc[cl][2 * m + 1]);
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&p[cl][m]);
      float& sum = m % 2 ? s1 : s0;
      sum += __low2float(v);
      sum += __high2float(v);
    }
  }
  lns::bar_sync(2 + wg, 128);  // every warp's part of the pair is read before b2 overwrites it
  const int q = wt / 32, lane = wt % 32, m = lane / 8, lr = lane % 8;
#pragma unroll
  for (int cl = 0; cl < 2; ++cl)
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // tiles 4 j .. 4 j + 3: rows c = 16 q + 8 (tm % 2) + lr
      const int tm = 4 * j + m;
      lns::stsm_x4(pb + lns::sw128(16 * q + 8 * (tm % 2) + lr, cl * kS + 8 * (tm / 2)),
                   p[cl][4 * j], p[cl][4 * j + 1], p[cl][4 * j + 2], p[cl][4 * j + 3]);
    }
  lns::fence_async_shared();  // b2's stores, visible to wgmma
  lns::bar_sync(2 + wg, 128);
  lns::wgmma_fence();
#pragma unroll
  for (int cl = 0; cl < 2; ++cl)
#pragma unroll
    for (int ks = 0; ks < kS / 16; ++ks) {
      const uint32_t a[4] = {p[cl][4 * ks], p[cl][4 * ks + 1], p[cl][4 * ks + 2],
                             p[cl][4 * ks + 3]};
      lns::wgmma_n64_rs<0>(gacc, a, lns::desc_kmajor(pb + cl * 64 + ks * 32));
    }
  lns::wgmma_commit();
}

// Step 2 and the Gram of a tile's columns for warpgroup wg: its pair blocks
// wg + 2 j (columns wg + 4 j and wg + 4 j + 2), one after another.
__device__ __forceinline__ void tc_columns(uint8_t* a_s, const uint8_t* kx_b, float (&gacc)[32],
                                           float& s0, float& s1, int wg, int wt) {
  lns::wgmma_fence_regs(gacc);
#pragma unroll 1
  for (int j = 0; j < kTL / (2 * kWG); ++j) {
    uint8_t* pb = a_s + (wg + kWG * j) * kPair;
    float acc[2][16];
    tc_step2(pb, kx_b, acc);
    lns::wgmma_wait<0>();
    tc_gram(pb, acc, gacc, s0, s1, wg, wt);
    lns::wgmma_wait<0>();
  }
  lns::wgmma_fence_regs(gacc);
}

// u_t's slab q (h = 8 q .. 8 q + 7) of one sample (global [w][h][c]) into
// u_s by 16-byte cp.async (the consumers, 8 pieces a thread, a 1 KB run of
// 8 h per w), each h as its [w][c] operand in the 128-byte swizzle
__device__ __forceinline__ void load_u_slab(uint8_t* u_s, const bf16* u_b, int q, int tid) {
#pragma unroll
  for (int k = 0; k < kSlab * kS * 8 / (128 * kWG); ++k) {
    const int e = tid + k * 128 * kWG, c8 = e % 8, h = q * kSlab + (e / 8) % kSlab,
              w = e / (8 * kSlab);
    lns::cp_async16(u_s + h * kBox + lns::sw128(w, 8 * c8), u_b + (w * kS + h) * kC + 8 * c8,
                    true);
  }
}

// One block per sample: u_t once into shared memory, then the sample's heads
// one after another, kx and ky of the next two heads loaded by TMA while
// this one runs; per head the l tiles, each step 1 (the warpgroups' batches
// of 8 h) and then step 2 and the Gram (each warpgroup its pair blocks). G =
// the first warpgroup's sum + the second's, s likewise, each warpgroup
// adding and storing half of the rows (a fixed order: no atomics, two runs
// give the same bits).
__global__ void __launch_bounds__(kThreadsTc, 1)
fab_mega_stats_wgmma(const bf16* __restrict__ u_t, const __grid_constant__ CUtensorMap map_kx,
                     const __grid_constant__ CUtensorMap map_ky, float* __restrict__ g_out,
                     float* __restrict__ s_out, int n) {
  extern __shared__ uint8_t smem_tc[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_tc) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* u_s = base;
  uint8_t* a_s = base + kOffA;
  uint8_t* kx_s = base + kOffKx;
  uint8_t* ky_s = base + kOffKy;
  float* g_st = reinterpret_cast<float*>(base + kOffG);
  float* s_st = g_st + kC * kC;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(base + kOffBar);
  const int tid = threadIdx.x, b = blockIdx.x;
  // kx and ky of head hn into buffer hn % 2 (thread 0), completing on kfull
  auto load_k = [&](int hn) {
    uint64_t* bar = &kfull[hn & 1];
    lns::mbar_expect_tx(bar, 2 * kBox);
    lns::tma_load(kx_s + (hn & 1) * kBox, &map_kx, bar, 0, 0, b * n + hn, 0);
    lns::tma_load(ky_s + (hn & 1) * kBox, &map_ky, bar, 0, 0, b * n + hn, 0);
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) lns::mbar_init(&kfull[i], 1);
    lns::mbar_fence_init();
    for (int hn = 0; hn < 2 && hn < n; ++hn) load_k(hn);
  }
  const bf16* u_b = u_t + static_cast<size_t>(b) * kS * kS * kC;
#pragma unroll
  for (int q = 0; q < kS / kSlab; ++q) {  // every slab in flight, one commit group each
    load_u_slab(u_s, u_b, q, tid);
    lns::cp_async_commit();
  }
  __syncthreads();  // the barriers exist before anyone waits on them
  const int wg = tid / 128, wt = tid % 128;
  const int q = wt / 32, lane = wt % 32, r0 = 16 * q + lane / 4, c2 = 2 * (lane % 4);
  for (int hn = 0; hn < n; ++hn) {
    const int kb = hn & 1;
    const uint8_t* kx_b = kx_s + kb * kBox;
    const uint8_t* ky_b = ky_s + kb * kBox;
    lns::mbar_wait(&kfull[kb], (hn >> 1) & 1);
    float gacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gacc[i] = 0.f;
    float s0 = 0.f, s1 = 0.f;
    for (int t = 0; t < kS / kTL; ++t) {
#pragma unroll
      for (int it = 0; it < 2; ++it) {  // batch it of warpgroup wg: slab 2 it + wg
        if (hn == 0 && t == 0) {  // the first pass waits for the slabs
          if (it == 0) lns::cp_async_wait<2>();
          if (it == 1) lns::cp_async_wait<0>();
          lns::fence_async_shared();  // every thread's pieces, visible to wgmma
          lns::bar_sync(1, 128 * kWG);
        }
        tc_step1(u_s, ky_b + t * kTL * 128, a_s, (2 * it + wg) * kSlab, wt);
      }
      lns::fence_async_shared();  // a's stores, visible to wgmma
      lns::bar_sync(1, 128 * kWG);
      tc_columns(a_s, kx_b, gacc, s0, s1, wg, wt);
      lns::bar_sync(1, 128 * kWG);  // the tile is consumed before the next one's step 1
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {  // the quad's four column sums: (u0 + u1) + (u2 + u3)
      s0 += __shfl_xor_sync(0xffffffffu, s0, x);
      s1 += __shfl_xor_sync(0xffffffffu, s1, x);
    }
    // G and s, rows c < 32 (warps 0, 1) finished by the first warpgroup and
    // rows 32 .. 63 (warps 2, 3) by the second: each passes the other its
    // sums of those rows through g_st and s_st, adds the other's to its own
    // (f32 addition commutes: both give G0 + G1) and stores them
    const bool mine = (q < 2) == (wg == 0);
    if (!mine) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float* gp = g_st + r0 * kC + 8 * k + c2;
        *reinterpret_cast<float2*>(gp) = make_float2(gacc[4 * k], gacc[4 * k + 1]);
        *reinterpret_cast<float2*>(gp + 8 * kC) = make_float2(gacc[4 * k + 2], gacc[4 * k + 3]);
      }
      if (c2 == 0) {
        s_st[r0] = s0;
        s_st[r0 + 8] = s1;
      }
    }
    lns::bar_sync(1, 128 * kWG);  // also: head hn's kx and ky are read
    if (tid == 0 && hn + 2 < n) load_k(hn + 2);
    if (mine) {
      const size_t bn = static_cast<size_t>(b) * n + hn;
      float* go = g_out + bn * kC * kC;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = r0 * kC + 8 * k + c2;
        const float2 v0 = *reinterpret_cast<const float2*>(g_st + e);
        const float2 v1 = *reinterpret_cast<const float2*>(g_st + e + 8 * kC);
        *reinterpret_cast<float2*>(go + e) =
            make_float2(gacc[4 * k] + v0.x, gacc[4 * k + 1] + v0.y);
        *reinterpret_cast<float2*>(go + e + 8 * kC) =
            make_float2(gacc[4 * k + 2] + v1.x, gacc[4 * k + 3] + v1.y);
      }
      if (c2 == 0) {
        s_out[bn * kC + r0] = s0 + s_st[r0];
        s_out[bn * kC + r0 + 8] = s1 + s_st[r0 + 8];
      }
    }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using u64 = uint64_t;
  const u64 BN = static_cast<u64>(b) * n, S = kS;
  CUtensorMap mkx, mky;
  // kx, ky [b n, 32, 32]: one head's matrix, columns 32 .. 63 of the box zero
  cudaError_t e = lns::make_map(&mkx, kx, {S, S, BN, 1}, {S * 2, S * S * 2, BN * S * S * 2},
                                {64, static_cast<uint32_t>(kS), 1, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&mky, ky, {S, S, BN, 1}, {S * 2, S * S * 2, BN * S * S * 2},
                      {64, static_cast<uint32_t>(kS), 1, 1});
  if (e == cudaSuccess) e = lns::allow_smem(fab_mega_stats_wgmma, kStatsTcSmem);
  if (e != cudaSuccess) return e;
  fab_mega_stats_wgmma<<<b, kThreadsTc, kStatsTcSmem, st>>>(
      static_cast<const bf16*>(u_t), mkx, mky, static_cast<float*>(g), static_cast<float*>(s), n);
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

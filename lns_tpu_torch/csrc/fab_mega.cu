// The FAB core's apply pair recomputed in each of two passes, so that the
// head-major values bb never reach device memory: a statistics pass (per
// sample and head, the Gram matrix and the column sums of the rounded apply
// pair) and an apply pass (the apply pair again, its product with a per-head
// c x o matrix, summed over the heads). Their second apply on its own, the
// interior dot kx [i, h] . a [l, h, c] -> bf16 [i, l, c] with f32 sums (the
// forms of benchmarks/probe_fab_mega.py's `piece` that are an interior dot:
// A, and B2, the same function with the same output memory), runs through
// mosaic_dots.cu's dot_general (its straight x transposed orientation); its
// limit stays here, lns_interior_dot_limit.
//
// Replaces benchmarks/probe_fab_mega.py: stats_pass (_stats_kernel) and
// apply_pass (_apply_kernel).
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
//               f32 sums.
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
// The apply pass (fab_mega_apply_wgmma, sm_90a) keeps the statistics pass's
// plan: a block per sample (116 blocks, one wave at b116), u_t read once into
// shared memory in the same per-h layout (load_u_slab), every product on
// wgmma. Its head sum is what shapes it: a sample's [1024 (i l), 64 o] f32
// sum is 256 KB, more than shared memory holds beside u, so the block loops
// over tiles of TL columns l outside and the heads inside, the tile's sum in
// the two warpgroups' registers across the heads (no atomics: each output
// belongs to one warpgroup, summed over the heads in order). Per tile and
// head (an "iteration"; kx, the tile's rows of ky and m come by TMA into a
// ring of two slots, thread 0 issuing iteration j + 2's copies once j has
// consumed its slot):
//   1. a^T [c, l] as in the statistics pass (tc_step1, m64 nTL k16, u
//      MN-major), rounded and stored K-major in pair blocks;
//   2. per pair block (each warpgroup its TL / 4): bb [(l', i), c] for the
//      pair's two columns l' at once, M = 64 = 2 x 32 i: A is kx as a block
//      diagonal [(l', i), (l'', h)] = kx[i, h] if l' = l'' else 0, each warp
//      holding its 16 rows' fragments in registers (ldmatrix from the slot's
//      kx; the off-diagonal k steps zero), B the pair block (K-major, K =
//      (l'', h)): m64 n64 k16 x 4, twice step 2's products, none of them
//      stored;
//   3. b2 = bf16(bb) packed in registers is the A of out [(l', i), o] +=
//      b2 . m (m64 n64 k16 x 4, m MN-major by TMA), the tile's sum; pair
//      j's b2 . m and pair j + 1's step 2 go in one commit group.
// After a tile's last head its sum minus the bias is rounded once and goes
// through shared memory (a's region, 16-byte chunks XOR-swizzled by row) to
// 16-byte global stores. Shared memory at TL = 16: u_t 131,072, a tile's
// pair blocks 65,536, two slots of kx 4,096 + m 8,192 + ky rows 2,048;
// 226,320 bytes with the barriers and the 1 KB alignment (TL = 8: 32,768 of
// pair blocks, slots of 13,312). Registers: the tile's sum, TL / 4 x 32 f32 a
// thread (128 at TL = 16), beside step 1's 64 accumulators (kApplyHB = 8 h
// a batch): ptxas spills about 250 bytes a thread at TL = 16, and still the
// tile of 16 and batches of 8 measured faster than tiles of 8 or batches of
// 4 (probe_fab_mega.py --variants). What bounds it: step 1's nTL products,
// which read all of u from shared memory once per iteration (2 MB a sample
// at TL = 16, 4 MB at TL = 8), and the waits and block barriers between
// the steps (probe_fab_mega.py --phases); u itself is read from device
// memory once.
//
// Grids: statistics and apply (b), each block looping over its heads with
// u loaded once. One block per SM (shared memory).

#include <cstdio>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kS = 32;             // h = w
constexpr int kC = 64;             // c (and o)

using bf16 = __nv_bfloat16;

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

// Step 1 of h = h0 .. h0 + HB - 1 (a warpgroup) for a tile of TL columns l:
// a^T [c, l] = u_h^T [c, w] . ky_tile^T [w, l] (m64 nTL k16, u MN-major, ky
// K-major), rounded to bf16 and stored K-major for step 2: column l in half
// l / 2 % 2 of pair block pair(l), rows c, its h along the row (the batch's
// HB h of one (c, l) one 16-byte piece at HB = 8, a store's 32 pieces
// filling every bank group four times; 8 bytes at HB = 4)
template <int TL, int HB>
__device__ __forceinline__ void tc_step1(const uint8_t* u_s, const uint8_t* kyt, uint8_t* a_s,
                                         int h0, int wt) {
  static_assert(HB == 4 || HB == 8, "batches of 4 or 8 h");
  float acc[HB][TL / 2];
#pragma unroll
  for (int r = 0; r < HB; ++r) {
#pragma unroll
    for (int i = 0; i < TL / 2; ++i) acc[r][i] = 0.f;
    lns::wgmma_fence_regs(acc[r]);
  }
  lns::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kS / 16; ++ks) {
    const uint64_t db = lns::desc_kmajor(kyt + ks * 32);
#pragma unroll
    for (int r = 0; r < HB; ++r)
      lns::wgmma<TL, 1, 0>(acc[r], lns::desc_mnmajor(u_s + (h0 + r) * kBox + ks * 2048), db);
  }
  lns::wgmma_commit();
  lns::wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < HB; ++r) lns::wgmma_fence_regs(acc[r]);
  // acc[r][4 k + 2 hf + e]: row c = 16 q + 8 hf + g, column l = 8 k + 2 u + e, h = h0 + r
  const int q = wt / 32, lane = wt % 32, g = lane / 4, u = lane % 4;
#pragma unroll
  for (int k = 0; k < TL / 8; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = 8 * k + 2 * u + e;
      uint8_t* pb = a_s + pair(l) * kPair;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * k + 2 * hf + e;
        uint8_t* at = pb + lns::sw128(16 * q + 8 * hf + g, (l / 2 % 2) * kS + h0);
        if constexpr (HB == 8) {
          *reinterpret_cast<uint4*>(at) = make_uint4(
              lns::pack_bf16(acc[0][i], acc[1][i]), lns::pack_bf16(acc[2][i], acc[3][i]),
              lns::pack_bf16(acc[4][i], acc[5][i]), lns::pack_bf16(acc[6][i], acc[7][i]));
        } else {
          *reinterpret_cast<uint2*>(at) = make_uint2(lns::pack_bf16(acc[0][i], acc[1][i]),
                                                     lns::pack_bf16(acc[2][i], acc[3][i]));
        }
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
        tc_step1<kTL, kHB>(u_s, ky_b + t * kTL * 128, a_s, (2 * it + wg) * kSlab, wt);
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

// ---- the apply pass on wgmma ---------------------------------------------

constexpr int kApplyTile = 16;  // columns l of the apply pass's tile (8 or 16; PERF.md)
constexpr int kApplyHB = 8;     // h of one step-1 batch in the apply pass (4 or 8; PERF.md)
constexpr int kKRing = 2;       // the apply pass's slots of (kx, m, ky rows)

// The apply pass's shared memory for a tile of TL columns, byte offsets from
// the first 1024-byte boundary: u_t by h (as the statistics pass), the
// tile's pair blocks (then the tile's output, [i][l][o] rows of 128 bytes),
// kKRing slots of kx ([i rows][64 h, 32 used]), m ([c rows][64 o], an
// MN-major B) and the tile's rows of ky ([l rows][64 w, 32 used]), the
// slots' barriers
template <int TL>
struct ApplySmem {
  static constexpr int kPairs = TL / 2;
  static constexpr int kOffA = kS * kBox;
  static constexpr int kOffSlot = kOffA + kPairs * kPair;
  static constexpr int kM = kBox;                      // m in a slot
  static constexpr int kKy = kM + 2 * kBox;            // ky's rows in a slot
  static constexpr int kSlot = kKy + TL * 128;
  static constexpr int kSlotTx = kSlot;                // bytes the copies of a slot bring
  static constexpr int kOffBar = kOffSlot + kKRing * kSlot;
  static constexpr size_t kBytes = 1024 + kOffBar + 8 * kKRing;
  static_assert(TL == 8 || TL == 16, "a tile of 8 or 16 columns");
  static_assert(kBytes <= lns::kMaxDynamicSmem, "one block per SM");
  static_assert(kS * TL * 128 == kPairs * kPair, "the tile's output fits its pair blocks");
};

// A warpgroup's P pair blocks, pb0 + j kWG kPair: per pair, step 2, bb
// [(l', i), c] = kxd . a_pair (kxd the block-diagonal kx, this warp's
// fragments in ka; B the pair block, K-major, K = (l', h)); b2 = bf16(bb)
// packed in registers (two neighbouring n8 accumulator blocks are one k16 A
// fragment); acc[j] += b2 . m (m MN-major) in k order. Pipelined: pair j's
// b2 . m and pair j + 1's step 2 are one commit group (two products in
// flight per wait).
template <int P>
__device__ __forceinline__ void tc_apply_pairs(const uint8_t* pb0, const uint32_t (&ka)[4][4],
                                               const uint8_t* m_s, float (&acc)[P][32]) {
  float bb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) bb[i] = 0.f;
  lns::wgmma_fence_regs(bb);
  lns::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) lns::wgmma_n64_rs<0>(bb, ka[ks], lns::desc_kmajor(pb0 + ks * 32));
  lns::wgmma_commit();
  lns::wgmma_wait<0>();
  lns::wgmma_fence_regs(bb);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    uint32_t p[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) p[m] = lns::pack_bf16(bb[2 * m], bb[2 * m + 1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) bb[i] = 0.f;
    lns::wgmma_fence_regs(bb);
    lns::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3]};
      lns::wgmma_n64_rs<1>(acc[j], a, lns::desc_mnmajor(m_s + ks * 2048));
    }
    if (j + 1 < P) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        lns::wgmma_n64_rs<0>(bb, ka[ks], lns::desc_kmajor(pb0 + (j + 1) * kWG * kPair + ks * 32));
    }
    lns::wgmma_commit();
    lns::wgmma_wait<0>();
    lns::wgmma_fence_regs(bb);
  }
}

// One block per sample: u_t once into shared memory, then per tile of TL
// columns l the heads in order, each step 1 (the warpgroups' batches of 8 h)
// and then, per pair block of the warpgroup, step 2 and b2 . m into the
// tile's sum; the tile's sum minus the bias rounded once and stored. Each
// output belongs to one warpgroup and sums the heads in order (no atomics:
// two runs give the same bits).
template <int TL>
__global__ void __launch_bounds__(kThreadsTc, 1)
fab_mega_apply_wgmma(const bf16* __restrict__ u_t, const __grid_constant__ CUtensorMap map_kx,
                     const __grid_constant__ CUtensorMap map_ky,
                     const __grid_constant__ CUtensorMap map_m, const bf16* __restrict__ bias,
                     bf16* __restrict__ out, int n) {
  using L = ApplySmem<TL>;
  extern __shared__ uint8_t smem_ap[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_ap) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* u_s = base;
  uint8_t* a_s = base + L::kOffA;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(base + L::kOffBar);
  const int tid = threadIdx.x, b = blockIdx.x, steps = (kS / TL) * n;
  // iteration j (tile j / n, head j % n): kx, m and ky's rows into slot j %
  // kKRing (thread 0), completing on its barrier
  auto load = [&](int j) {
    uint64_t* bar = &kfull[j % kKRing];
    uint8_t* sl = base + L::kOffSlot + (j % kKRing) * L::kSlot;
    const int bn = b * n + j % n;
    lns::mbar_expect_tx(bar, L::kSlotTx);
    lns::tma_load(sl, &map_kx, bar, 0, 0, bn, 0);
    lns::tma_load(sl + L::kM, &map_m, bar, 0, 0, bn, 0);
    lns::tma_load(sl + L::kKy, &map_ky, bar, 0, j / n * TL, bn, 0);
  };
  if (tid == 0) {
    for (int i = 0; i < kKRing; ++i) lns::mbar_init(&kfull[i], 1);
    lns::mbar_fence_init();
    for (int j = 0; j < kKRing && j < steps; ++j) load(j);
  }
  const bf16* u_b = u_t + static_cast<size_t>(b) * kS * kS * kC;
#pragma unroll
  for (int q = 0; q < kS / kSlab; ++q) {  // every slab in flight, one commit group each
    load_u_slab(u_s, u_b, q, tid);
    lns::cp_async_commit();
  }
  __syncthreads();  // the barriers exist before anyone waits on them
  const int wg = tid / 128, wt = tid % 128, q = wt / 32, lane = wt % 32, g = lane / 4,
            u = lane % 4;
  for (int t = 0; t < kS / TL; ++t) {
    float acc[TL / 4][32];  // the sum of pair block wg + 2 jj: rows (l', i), columns o
#pragma unroll
    for (int jj = 0; jj < TL / 4; ++jj) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[jj][i] = 0.f;
      lns::wgmma_fence_regs(acc[jj]);
    }
    for (int hn = 0; hn < n; ++hn) {
      const int j = t * n + hn;
      const uint8_t* sl = base + L::kOffSlot + (j % kKRing) * L::kSlot;
      lns::mbar_wait(&kfull[j % kKRing], (j / kKRing) & 1);
      constexpr int kPer = kSlab / kApplyHB;  // batches of a slab
#pragma unroll
      for (int it = 0; it < 2 * kPer; ++it) {  // warpgroup wg's batch it: slab 2 (it / kPer) + wg
        if (j == 0 && it % kPer == 0) {  // the first iteration waits for the slabs
          if (it == 0) lns::cp_async_wait<2>();
          if (it == kPer) lns::cp_async_wait<0>();
          lns::fence_async_shared();  // every thread's pieces, visible to wgmma
          lns::bar_sync(1, kThreadsTc);
        }
        tc_step1<TL, kApplyHB>(u_s, sl + L::kKy, a_s,
                               (2 * (it / kPer) + wg) * kSlab + it % kPer * kApplyHB, wt);
      }
      lns::fence_async_shared();  // a's stores, visible to wgmma
      lns::bar_sync(1, kThreadsTc);
      // this warp's rows (l' = q / 2, i = 16 (q % 2) ..) of the block-diagonal
      // kx: k steps 2 (q / 2) and 2 (q / 2) + 1 hold kx[i, h], the others zero
      uint32_t kf[2][4], ka[4][4];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        lns::ldsm_x4(kf[c], sl + lns::sw128(16 * (q % 2) + (lane & 15), 16 * c + (lane >> 4) * 8));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int x = 0; x < 4; ++x) ka[ks][x] = ks / 2 == q / 2 ? kf[ks % 2][x] : 0u;
      tc_apply_pairs<TL / 4>(a_s + wg * kPair, ka, sl + L::kM, acc);
      lns::bar_sync(1, kThreadsTc);  // the pair blocks and the slot are consumed
      if (tid == 0 && j + kKRing < steps) load(j + kKRing);
    }
    // the tile's output, rounded once, into a's region: row (i, l) of 128
    // bytes, 16-byte chunk k at k ^ (i % 8) (each store's eight rows i in
    // distinct banks); then 16-byte stores of whole rows
#pragma unroll
    for (int jj = 0; jj < TL / 4; ++jj) lns::wgmma_fence_regs(acc[jj]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // the bias at columns o = 8 k + 2 u, + 1
      const float2 bo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          bias + static_cast<size_t>(b) * kC + 8 * k + 2 * u));
#pragma unroll
      for (int jj = 0; jj < TL / 4; ++jj) {
        const int l = wg + 4 * jj + 2 * (q / 2);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * (q % 2) + g + 8 * hf;
          *reinterpret_cast<uint32_t*>(a_s + (i * TL + l) * 128 + ((k ^ (i & 7)) << 4) + 4 * u) =
              lns::pack_bf16(acc[jj][4 * k + 2 * hf] - bo.x, acc[jj][4 * k + 2 * hf + 1] - bo.y);
        }
      }
    }
    lns::bar_sync(1, kThreadsTc);
    for (int e = tid; e < kS * TL * 8; e += kThreadsTc) {
      const int k = e % 8, l = e / 8 % TL, i = e / (8 * TL);
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * kS + i) * kS + t * TL + l) * kC +
                                8 * k) =
          *reinterpret_cast<const uint4*>(a_s + (i * TL + l) * 128 + ((k ^ (i & 7)) << 4));
    }
    lns::bar_sync(1, kThreadsTc);  // the output is read before the next tile's step 1
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

// The interior dot's, kx [i, k] . a [l, k, c], which dot_general
// (mosaic_dots.cu) computes: l c below 2^31, dot_general's output columns.
extern "C" const char* lns_interior_dot_limit(int dtype, int l, int i, int k, int c) {
  return shape_limit("i, k", dtype, i, k, c, "l", l, 2147483647 / kC);
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
  constexpr int TL = kApplyTile;
  using u64 = uint64_t;
  const u64 BN = static_cast<u64>(b) * n, S = kS, C = kC;
  CUtensorMap mkx, mky, mm;
  // kx [b n, 32, 32]: one head's matrix, columns 32 .. 63 of the box zero;
  // ky: the tile's TL rows of one head's; m [b n, 64 c, 64 o]: one head's
  cudaError_t e = lns::make_map(&mkx, kx, {S, S, BN, 1}, {S * 2, S * S * 2, BN * S * S * 2},
                                {64, static_cast<uint32_t>(kS), 1, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&mky, ky, {S, S, BN, 1}, {S * 2, S * S * 2, BN * S * S * 2},
                      {64, static_cast<uint32_t>(TL), 1, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&mm, m, {C, C, BN, 1}, {C * 2, C * C * 2, BN * C * C * 2},
                      {64, static_cast<uint32_t>(kC), 1, 1});
  if (e == cudaSuccess) e = lns::allow_smem(fab_mega_apply_wgmma<TL>, ApplySmem<TL>::kBytes);
  if (e != cudaSuccess) return e;
  fab_mega_apply_wgmma<TL><<<b, kThreadsTc, ApplySmem<TL>::kBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(u_t), mkx, mky, mm, static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), n);
  return cudaGetLastError();
}

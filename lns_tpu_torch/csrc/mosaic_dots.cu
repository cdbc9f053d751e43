// The rank-3 dot orientations and FAB chains of the TPU probe
// benchmarks/probe_mosaic_dots.py (its pallas_call at :305 over the nineteen
// bodies of CASES, :46-229), at its shapes: C = 64, H = W = L = I = 32, bf16
// inputs u [C,H,W], k2 [L,W], k3 [I,H], a3 [C,H,L], q [L,C,I], m [C,C].
// Two kernels:
//
// dot_general: one strided contraction, the port's jax.lax.dot_general for
//   operands of rank 3 or less with one contracting dim and at most one batch
//   dim (12 of the 19 cases, and fab_mega.py's interior dot kx [i, h] . a
//   [l, h, c], the straight x transposed orientation of rhs_interior). The
//   output is [batch, lhs free, rhs free] (JAX's order), stored contiguous,
//   rounded once to its dtype; or, with the sum_batch epilogue, summed over
//   the batch in the kernel ([lhs free, rhs free]); or, with the moments
//   epilogue, phi = bf16(product) reduced to the [2, rhs free] f32 column
//   sums of phi and of bf16(phi^2), in a fixed order. A free side's dims are
//   (r1, r2), addressed by their strides, so a pair that cannot merge into
//   one strided dim (rhs_interior's (C, L), with a split H between them)
//   needs no copy. bf16 x bf16 runs on mma.sync m16n8k16 with f32 sums; any
//   f32 operand puts the product in full f32 on the CUDA cores (no TF32,
//   which keeps about three digits; block tile 64 x 64, one k stage at a
//   time). How an operand reaches the tensor core (its feed, chosen on the
//   host and returned to the caller):
//     straight    the contracted dim has unit stride: 16-byte cp.async along
//                 k into a [row][k] tile, ldmatrix;
//     transposed  the inner free dim has unit stride (and a size that is a
//                 multiple of 8): 16-byte cp.async along the rows into a
//                 [k][row] tile, ldmatrix.trans;
//     staged      neither (or a base or stride off 16 bytes): a gather, one
//                 element a thread, into a [row][k] tile, ldmatrix.
//   The bf16 kernel, 4 warps (2 x 2 of the block tile):
//     ring        a block's stages, 32 deep, in order (its m tiles, in each
//                 its batches, in each the k stages) stream through a ring
//                 of 4 slots in shared memory, one cp.async commit group a
//                 stage: the first 4 are in flight before the first wait
//                 (cp.async.wait_group 3, empty groups past the end keeping
//                 the count), and stage s + 4 is issued as soon as slot s is
//                 consumed. At the probe's depths (K 32 or 64, sum_batch's 4
//                 batches a block) a block's whole depth is one round trip;
//                 K = 200 streams through the ring.
//     tile        32 x 32, 32 x 64, 64 x 32 or 64 x 64, chosen per launch
//                 from (m, n, batch, epilogue) by tile_of (stated once, in
//                 C, beside feed_of, and returned to the caller): a side of
//                 32 or fewer takes 32 (no tile half zeros), the moments the
//                 largest tile, else the largest tile whose grid has at least
//                 min(66, the grid of 32 x 32 tiles) blocks, half of the 132
//                 SMs where the output has that many 32 x 32 tiles. At the
//                 probe's shapes every case but the moments takes 32 x 32:
//                 64 blocks (gram_batched 128, gram_b+sum 32), where a fixed
//                 64 x 64 tile would give 16 or 32, those at a side of 32
//                 half zeros.
//     stores      the f32 tile rounded to the output dtype into shared
//                 memory ([rows][cols + 8]: the fragments' writes fall in
//                 distinct banks), then whole rows of the contiguous output
//                 in 16-byte pieces, neighbouring threads on neighbouring
//                 addresses (rows of odd bytes one element a thread), the
//                 ragged edge masked.
//     sum_batch   a cluster of min(8, batch) blocks per output tile splits
//                 the batch (rank r takes batches r, r + 8, ...), each rank's
//                 batches through its ring; rank r adds rows r, r + 8, ... of
//                 the tile over the ranks in rank order through DSMEM (a
//                 thread's loads from every rank issued together) and
//                 stores 16-byte pieces. An output's f32 sums run in the
//                 same order at any tile (a rank's batches in order, then
//                 the ranks): gram_b+sum takes 4 tiles x 8 ranks = 32
//                 blocks.
//     moments     a cluster of up to 8 blocks splits the output rows (rank
//                 r takes row tiles r, r + 8, ...), folded in a fixed order:
//                 a thread's rows in order, 16 row groups, then the ranks in
//                 rank order (DSMEM).
//   Two runs give the same bits: fixed orders throughout, no atomics.
//
// dot_chain: the seven chains, one launch of one cluster of 8 blocks each.
//   Every stage rounds where the TPU body rounds and nowhere else (a
//   dt-typed _dg rounds to bf16, an f32 dot does not, and
//   preferred_element_type=bf16 is an f32 sum rounded once). No intermediate
//   reaches device memory: the kernel reads the inputs and writes only the
//   output. Each block owns a slice of one free dim of each stage's output;
//   a stage that needs what its peers computed reads their slices through
//   distributed shared memory (DSMEM) after a cluster barrier (pull_all: a
//   thread's loads from the 8 peers issued together), and the
//   cross-block sums run in a fixed order, so two runs give the same bits.
//   The bf16 products run on mma.sync as in dot_general. The f32 ones run in
//   full f32 on the CUDA cores (no TF32), register-blocked (ffma_tile): each
//   of the 256 threads holds a 4 x 8 or 8 x 4 tile of the output, both
//   operands are f32 k-major copies in shared memory (the bf16 inputs
//   widened once as they land), so each k step reads 16-byte vectors, and
//   every stride is a template parameter (no division or modulo in the k
//   loop); each output stays one fmaf chain in k order, the first design's
//   bits. The inputs come in commit groups in the order the stages need
//   them, so the first product starts while the later inputs land. Per
//   chain (rank r of 8):
//     0 apply_chain        block owns c [8r, 8r+8): a = bf16(u . k2) [c,h,l],
//                          bb = bf16(k3 . a) [i,c,l]; DSMEM: block owns
//                          i [4r, 4r+4) of t = bb . m, gathers bb[i, all c,
//                          l]; out = bf16(2 t)                    [I,L,O] bf16
//     1 chain_projf_f32    block owns h [4r, 4r+4): v = bf16(m^T u) [o,h,w],
//                          a = bf16(v . k2) [o,h,l]; DSMEM: block owns
//                          o [8r, 8r+8) of t = k3 . a, gathers a[o, all h,
//                          l]; out = 2 t                           [I,O,L] f32
//     2 chain_moments_f32  as 1; phi = bf16(k3 . a); each warp holds one o
//                          whole, so the moments over (i, l) need no
//                          cross-block sum                          [O,2] f32
//     3 scr_bf16_f32       as 0 with out = bb . m                  [I,L,O] f32
//     4 scr_f32_f32        as 0 with bb in f32 and out = bb . f32(m) on the
//                          CUDA cores                               [I,L,O] f32
//     5 chain_scr2_f32     all f32 on the CUDA cores: as 4 to the gather
//                          (a = u . k2, bb = k3 . a), phi = bb . m kept in
//                          registers, its column sums of phi and phi^2 in a
//                          fixed tree (a thread's 4 rows in order, its
//                          warp's 4 row groups by shuffles, the 8 warps,
//                          then the 8 ranks, pushed by DSMEM, in every
//                          block); mean, var = max(s2/n - mean^2, 0), inv =
//                          rsqrt(var + 1e-5), mm = (m inv) m^T and bias =
//                          (mean inv) m^T in every block; out = (t - bias)
//                          + t, t = bb . mm
//     6 transp_chain_f32   block owns y = q's dim 0 in [4r, 4r+4): a =
//                          q . m (f32 sums) stored with its two leading
//                          dims swapped, [x][y][m1]; DSMEM: block owns x in
//                          [4r, 4r+4) of bb = a' . k2 (f32, CUDA cores),
//                          gathers a'[x, all y, m1]       [32,64,32] f32
//   Live set per block (bytes of shared memory, the limit that
//   lns_dot_chain_limit states and the launch checks: 232,448):
//     0, 3  u 20,480 + k2, k3 5,120 + m 9,216 + a 20,480 + bb 20,480
//           + gathered bb 20,480 = 96,256
//     4     the same with bb and its gather in f32, and f32(m) 16,384:
//           137,216
//     1, 2  u 17,408 + k2, k3 5,120 + m 9,216 + v 20,480 + a 20,480
//           + gathered a 20,480 = 93,184
//     5     the raw inputs u 20,480 + k2, k3 5,120 + m 9,216 (then the
//           column sums, the ranks' sums and the statistics, 9,216) + k2^T,
//           k3^T 8,192 + three f32 regions of 32,768: u^T, then bb, then
//           (m inv)^T and mm; a, then f32(m) and m^T; the gathered bb =
//           141,312
//     6     q 20,480 + m 9,216 + k2 2,048 + a' 32,768 + gathered a' 32,768
//           + k2^T 4,096 = 101,376
//   The cluster as a whole holds each intermediate once (128 KB in bf16,
//   256 KB in f32), which no single block's 227 KB could hold two of.
//
// What bounds them on an H100: neither bytes nor operations. lhs_minor moves
// 264 KB (0.079 us at 3.35 TB/s) for 4.2 MFLOP (0.004 us at 989 TFLOP/s);
// chain_scr2_f32 does 25.7 MFLOP in f32 (0.38 us at 67 TFLOP/s), on 8 SMs
// 1.8 M fmaf a block (7.8 us at 128 fmaf a cycle and 1.83 GHz). A launch
// costs more than the bound: these kernels are bound by launch latency and,
// in each block, by the serial round trips of its loads, products and
// stores; the f32 chains also by the fmaf issue rate of 8 SMs. dot_general's
// ring leaves one load round trip a block at the probe's depths, its tiles
// spread a case over 32-128 SMs, and its stores leave in whole rows: what is
// left is the launch, one round trip each way, each k stage's chain of
// dependent mma.sync products (longer than its loads: probe_dots.py
// --variants times copies without the products and with only the first
// stage's loads) and (sum_batch, moments) the cluster barriers. Neither
// kernel is on a model's path; they answer the TPU
// probe's two questions on this card (which orientations reach the tensor
// cores, and how; whether a chain's intermediates can stay on chip).

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ---- dot_general ------------------------------------------------------------

constexpr int kT = 64;            // the f32 kernel's block tile (kT x kT), the bf16 kernel's largest
constexpr int kKT = 32;           // depth of one staged tile
constexpr int kRK = kKT + 8;      // row stride of a [row][k] bf16 tile (80 bytes)
constexpr int kFK = kKT + 1;      // row stride of a [row][k] f32 tile
constexpr int kGThreads = 128;    // 4 warps, 2 x 2 pieces of the block tile
constexpr int kStages = 4;        // the bf16 kernel's ring of k stages
constexpr int kFill = 66;         // blocks that fill half of the H100's 132 SMs
constexpr int kRowGroups = 16;    // the moments' partial sums per column
constexpr int kMaxCluster = 8;    // blocks that split sum_batch's batch or the moments' rows
static_assert((kRowGroups * 2 + 2) * kT <= kT * kT, "the moments' sums fit the fold's tile");

// bf16 elements of one operand's stage of `rows` rows: [rows][kRK] (k has
// unit stride) or [kKT][rows + 8] (the rows have unit stride)
__host__ __device__ constexpr int stage_elems(int rows) {
  return rows * kRK > kKT * (rows + 8) ? rows * kRK : kKT * (rows + 8);
}

enum Feed { kStraight = 0, kTransposed = 1, kStaged = 2, kCudaCores = 3 };
enum Epilogue { kStore = 0, kSumBatch = 1, kMoments = 2 };

// An operand: element (batch b, row r = r1 r2 + (r % r2), depth k) at
// p + b sb + r1 s1 + (r % r2) s2 + k sk (element strides).
struct Operand {
  const void* p;
  long long sb, s1, s2, sk;
  int r2, feed, bf;  // bf: 1 for bf16, 0 for f32
  __device__ __forceinline__ long long at(int b, int r, int k) const {
    return b * sb + (r / r2) * s1 + (r % r2) * s2 + k * sk;
  }
};

struct DgParams {
  Operand a, b;
  void* out;
  int nb, m, n, k, epi, out_bf;
  int cl;  // blocks of a cluster that share one output tile (1 for a plain store)
};

// A thread's share of one operand's [TR rows][kKT k] stage in shared memory,
// by the operand's feed: straight and transposed, its 16-byte pieces (one or
// two a thread), their rows' offsets in the operand computed once a tile
// (`tile`: the division by r2 happens there, never per stage), so that a
// stage's addresses are a multiply-add each; staged, a gather of one
// element a thread, zero past the edges.
template <int TR>
struct Pieces {
  static constexpr int kN = TR * kKT / 8 / kGThreads;  // 16-byte pieces a thread
  static_assert(kN * kGThreads * 8 == TR * kKT, "whole pieces a thread");
  int kk[kN], at[kN];  // depth in the stage, offset in the slot
  int r[kN];           // row in the tile
  long long row[kN];   // the row's offset in the operand (batch 0, depth 0); -1 past the edge
  __device__ __forceinline__ explicit Pieces(int feed) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = threadIdx.x + j * kGThreads;
      if (feed == kTransposed) {  // s[k][row], pieces along the rows
        kk[j] = e / (TR / 8);
        r[j] = e % (TR / 8) * 8;
        at[j] = kk[j] * (TR + 8) + r[j];
      } else {  // s[row][k], pieces along k
        r[j] = e / (kKT / 8);
        kk[j] = e % (kKT / 8) * 8;
        at[j] = r[j] * kRK + kk[j];
      }
    }
  }
  // the rows of the tile at r0 (of `rows`)
  __device__ __forceinline__ void tile(const Operand& o, int r0, int rows) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = r0 + r[j];
      row[j] = i < rows ? (i / o.r2) * o.s1 + (i % o.r2) * o.s2 : -1;
    }
  }
  // the stage at depth k0 of batch bi into s, one cp.async a piece (zero past
  // the edges); staged: [row][k], element by element
  __device__ __forceinline__ void load(bf16* s, const Operand& o, int bi, int r0, int rows, int k0,
                                       int klen) const {
    const bf16* p = static_cast<const bf16*>(o.p);
    if (o.feed == kStaged) {
      for (int e = threadIdx.x; e < TR * kKT; e += kGThreads) {
        const int rr = e / kKT, k = e % kKT;
        s[rr * kRK + k] = r0 + rr < rows && k0 + k < klen ? p[o.at(bi, r0 + rr, k0 + k)]
                                                          : __float2bfloat16(0.f);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const bool valid = row[j] >= 0 && k0 + kk[j] < klen;
      lns::cp_async16(s + at[j], valid ? p + (bi * o.sb + row[j] + (k0 + kk[j]) * o.sk) : p, valid);
    }
  }
};

// The same tile as f32 values, s[row][k] (row stride kFK), for the CUDA cores.
__device__ __forceinline__ void stage_f32(float* s, const Operand& o, int bi, int r0, int rows,
                                          int k0, int klen) {
  for (int e = threadIdx.x; e < kT * kKT; e += kGThreads) {
    const int r = e / kKT, kk = e % kKT;
    float v = 0.f;
    if (r0 + r < rows && k0 + kk < klen) {
      const long long i = o.at(bi, r0 + r, k0 + kk);
      v = o.bf ? __bfloat162float(static_cast<const bf16*>(o.p)[i])
               : static_cast<const float*>(o.p)[i];
    }
    s[r * kFK + kk] = v;
  }
}

__device__ __forceinline__ void store_out(const DgParams& p, int bi, int m, int n, float v) {
  if (m >= p.m || n >= p.n) return;
  const long long i = (static_cast<long long>(bi) * p.m + m) * p.n + n;
  if (p.out_bf) {
    static_cast<bf16*>(p.out)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p.out)[i] = v;
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = lns::pack_bf16(v0, v1);
}

// The moments' running sums of one output value: phi = bf16(v), phi^2
// rounded to bf16 (the TPU body squares a bf16 array), summed in f32.
__device__ __forceinline__ void add_moments(float v, float& s1, float& s2) {
  const float phi = lns::rnd<bf16>(v);
  s1 += phi;
  s2 += lns::rnd<bf16>(phi * phi);  // exact in f32, then rounded once
}

// Fold the threads' column sums (row group rg, column col of the block's
// tile of TN columns; red is [kRowGroups][2][TN]) in row-group order into the
// block's [2][TN] sums, then rank 0 adds the cluster's blocks' sums in rank
// order (DSMEM) into out [2, n].
template <int TN>
__device__ __forceinline__ void fold_moments(const DgParams& p, float* red, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  float* mine = red + kRowGroups * 2 * TN;
  __syncthreads();
  if (threadIdx.x < 2 * TN) {
    const int which = threadIdx.x / TN, col = threadIdx.x % TN;
    float s = 0.f;
    for (int rg = 0; rg < kRowGroups; ++rg) s += red[(rg * 2 + which) * TN + col];
    mine[threadIdx.x] = s;
  }
  cluster.sync();  // every block's sums are whole
  if (cluster.block_rank() == 0 && threadIdx.x < 2 * TN) {
    const int which = threadIdx.x / TN, col = threadIdx.x % TN;
    float s = 0.f;
    for (int q = 0; q < p.cl; ++q) s += cluster.map_shared_rank(mine, q)[threadIdx.x];
    if (n0 + col < p.n)
      static_cast<float*>(p.out)[static_cast<long long>(which) * p.n + n0 + col] = s;
  }
  cluster.sync();  // no block leaves while rank 0 reads it
}

// The f32 kernel's sum_batch: each block of the cluster holds its batches'
// sum of the output tile in red [kT][kT]; block r adds rows r, r + cl, ...
// over the blocks in rank order (DSMEM) and stores them.
__device__ __forceinline__ void fold_batches(const DgParams& p, float* red, int m0, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's tile is whole
  for (int r = static_cast<int>(cluster.block_rank()); r < kT; r += p.cl)
    for (int c = threadIdx.x; c < kT; c += kGThreads) {
      float s = 0.f;
      for (int q = 0; q < p.cl; ++q) s += cluster.map_shared_rank(red, q)[r * kT + c];
      store_out(p, 0, m0 + r, n0 + c, s);
    }
  cluster.sync();
}

// The block's loops (tm rows a tile): a plain store takes one output tile of
// one batch (grid (n tiles, m tiles, batch)); sum_batch's cluster of cl
// blocks (grid z) splits the batch, block r taking batches r, r + cl, ...;
// the moments' cluster splits the m tiles (grid (n tiles, 1, cl)). Fixed
// orders throughout: no atomics.
struct Loops {
  int rank, b0, b_step, m_first, m_step;
  __device__ __forceinline__ Loops(const DgParams& p, int tm)
      : rank(p.epi == kStore ? 0 : static_cast<int>(blockIdx.z)),
        b0(p.epi == kStore ? static_cast<int>(blockIdx.z) : p.epi == kSumBatch ? rank : 0),
        b_step(p.epi == kSumBatch ? p.cl : p.nb),
        m_first(p.epi == kMoments ? rank * tm : static_cast<int>(blockIdx.y) * tm),
        m_step(p.epi == kMoments ? p.cl * tm : p.m) {}
};

// The block's tile (its warps' f32 fragments acc) rounded to T into st
// ([TM][TN + 8]), then stored row by row into the contiguous [batch, m, n]
// output: 16-byte pieces, neighbouring threads on neighbouring addresses,
// where the rows hold whole 16-byte pieces; else one element a thread, in
// the same order. Nothing past m or n.
template <typename T, int TM, int TN, int MT, int NT>
__device__ __forceinline__ void store_tile(const DgParams& p, T* st, const float (&acc)[MT][NT][4],
                                           int wm, int wn, int bi, int m0, int n0) {
  constexpr int V = 16 / sizeof(T), kLd = TN + 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(st + (wm + mt * 16 + g + 8 * h) * kLd + wn + nt * 8 + 2 * t, acc[mt][nt][2 * h],
               acc[mt][nt][2 * h + 1]);
  __syncthreads();
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(bi) * p.m + m0) * p.n + n0;
  const int rows = p.m - m0 < TM ? p.m - m0 : TM, cols = p.n - n0 < TN ? p.n - n0 : TN;
  if (p.n % V == 0) {
    for (int e = threadIdx.x; e < rows * (TN / V); e += kGThreads) {
      const int r = e / (TN / V), c = e % (TN / V) * V;
      if (c < cols)
        *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * p.n + c) =
            *reinterpret_cast<const uint4*>(st + r * kLd + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * TN; e += kGThreads) {
      const int r = e / TN, c = e % TN;
      if (c < cols) out[static_cast<long long>(r) * p.n + c] = st[r * kLd + c];
    }
  }
}

// sum_batch: each block of the cluster holds its batches' sum of the tile in
// red ([TM][TN + 8] f32); block r adds rows r, r + cl, ... over the blocks in
// rank order (DSMEM: a thread's loads from every peer issued together) and
// stores them rounded to T, V = 16 / sizeof(T) columns a thread (one 16-byte
// store where the rows hold whole 16-byte pieces).
template <typename T, int TM, int TN>
__device__ __forceinline__ void fold_tiles(const DgParams& p, float* red, int m0, int n0) {
  constexpr int V = 16 / sizeof(T), kLd = TN + 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = (TM - rank + p.cl - 1) / p.cl;
  cluster.sync();  // every block's tile is whole
  for (int e = threadIdx.x; e < rows * (TN / V); e += kGThreads) {
    const int r = rank + e / (TN / V) * p.cl, c = e % (TN / V) * V;
    float4 x[kMaxCluster][V / 4];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < p.cl)
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          x[q][j] = reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + r * kLd + c)[j];
    float s[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < p.cl)
#pragma unroll
        for (int j = 0; j < V / 4; ++j) {
          s[4 * j] += x[q][j].x;
          s[4 * j + 1] += x[q][j].y;
          s[4 * j + 2] += x[q][j].z;
          s[4 * j + 3] += x[q][j].w;
        }
    if (m0 + r < p.m && n0 + c < p.n) {
      T* dst = static_cast<T*>(p.out) + static_cast<long long>(m0 + r) * p.n + n0 + c;
      if (p.n % V == 0) {
        uint4 v;
        T* e8 = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int j = 0; j < V; ++j) e8[j] = lns::cvt<T>(s[j]);
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        for (int j = 0; j < V && n0 + c + j < p.n; ++j) dst[j] = lns::cvt<T>(s[j]);
      }
    }
  }
  cluster.sync();  // no block leaves while a peer reads it
}

// bf16 x bf16 on mma.sync, block tile TM x TN (the rule: tile_of), warps 2 x
// 2 of (TM / 2) x (TN / 2). The block's stages, in order (its m tiles, in
// each its batches, in each the k stages of 32), stream through a ring of
// kStages slots, one cp.async commit group a stage: the first kStages are
// in flight before the first wait, and stage s + kStages is issued as soon
// as slot s is consumed. At the probe's depths every stage of a block is in
// flight at once.
template <int TM, int TN>
__global__ void __launch_bounds__(kGThreads) dot_general_bf16(const DgParams p) {
  constexpr int kA = stage_elems(TM), kStage = kA + stage_elems(TN);
  constexpr int kWM = TM / 2, kWN = TN / 2, MT = kWM / 16, NT = kWN / 8;
  static_assert(sizeof(float) * (kRowGroups * 2 + 2) * TN <= sizeof(bf16) * kStages * kStage &&
                    sizeof(float) * TM * (TN + 8) <= sizeof(bf16) * kStages * kStage,
                "the epilogues' tiles fit the ring");
  __shared__ uint4 ring4[kStages * kStage / 8];
  bf16* ring = reinterpret_cast<bf16*>(ring4);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int wm = warp / 2 * kWM, wn = warp % 2 * kWN, n0 = blockIdx.x * TN;
  const bool moments = p.epi == kMoments;
  const Loops lp(p, TM);
  const int kc = (p.k + kKT - 1) / kKT;
  const int batches = (p.nb - lp.b0 + lp.b_step - 1) / lp.b_step;
  const int total = (p.m - lp.m_first + lp.m_step - 1) / lp.m_step * batches * kc;
  Pieces<TM> pa(p.a.feed);
  Pieces<TN> pb(p.b.feed);
  pb.tile(p.b, n0, p.n);
  // the next stage to issue: its k stage, batch and m tile (counters: no
  // division per stage)
  int ik = 0, ib = 0, m_next = lp.m_first;
  // the next stage into slot (its number) % kStages as one commit group (an
  // empty one past the end)
  auto issue = [&](int s) {
    if (s < total) {
      if (ik == 0 && ib == 0) pa.tile(p.a, m_next, p.m);  // a new m tile
      const int bi = lp.b0 + ib * lp.b_step;
      bf16* slot = ring + s % kStages * kStage;
      pa.load(slot, p.a, bi, m_next, p.m, ik * kKT, p.k);
      pb.load(slot + kA, p.b, bi, n0, p.n, ik * kKT, p.k);
      if (++ik == kc) {
        ik = 0;
        if (++ib == batches) {
          ib = 0;
          m_next += lp.m_step;
        }
      }
    }
    lns::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(s);
  int ck = 0, m_done = lp.m_first;  // the computed stage's k stage (the moments: and m tile)
  float acc[MT][NT][4] = {};
  float s1[NT][2] = {}, s2[NT][2] = {};
  for (int s = 0; s < total; ++s) {
    lns::cp_async_wait<kStages - 1>();  // this thread's copies of stage s have landed
    __syncthreads();                     // and every thread's
    const bf16* as = ring + s % kStages * kStage;
    const bf16* bs = as + kA;
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (p.a.feed == kTransposed) {
          lns::ldsm_x4_trans(af[mt], as + lns::at_addr(lane, ks * 16, wm + mt * 16, TM + 8));
        } else {
          lns::ldsm_x4(af[mt], as + lns::a_addr(lane, wm + mt * 16, ks * 16, kRK));
        }
      }
      if (p.b.feed == kTransposed) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          lns::ldsm_x4_trans(r, bs + lns::b_addr(lane, ks * 16, wn + np * 16, TN + 8));
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t r[2];
          lns::ldsm_x2(r, bs + lns::bt_addr(lane, wn + nt * 8, ks * 16, kRK));
          bfr[nt][0] = r[0];
          bfr[nt][1] = r[1];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) lns::mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
    if (moments && ++ck == kc) {  // an m tile is whole: its rows into the sums, in order
      // C fragment: (row g (+ 8), columns 2t, 2t + 1) of each m16 n8 piece
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (m_done + wm + mt * 16 + g + e / 2 * 8 < p.m)
              add_moments(acc[mt][nt][e], s1[nt][e % 2], s2[nt][e % 2]);
            acc[mt][nt][e] = 0.f;
          }
      ck = 0;
      m_done += lp.m_step;
    }
    if (s + kStages < total) __syncthreads();  // slot s % kStages is consumed
    issue(s + kStages);
  }
  __syncthreads();  // the ring is consumed: the epilogue reuses it
  const int m0 = lp.m_first;
  if (p.epi == kStore) {
    if (p.out_bf) {
      store_tile<bf16, TM, TN>(p, ring, acc, wm, wn, blockIdx.z, m0, n0);
    } else {
      store_tile<float, TM, TN>(p, reinterpret_cast<float*>(ring), acc, wm, wn, blockIdx.z, m0,
                                n0);
    }
  } else if (p.epi == kSumBatch) {
    float* red = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(red + (wm + mt * 16 + g + 8 * h) * (TN + 8) + wn + nt * 8 + 2 * t,
                 acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    if (p.out_bf) {
      fold_tiles<bf16, TM, TN>(p, red, m0, n0);
    } else {
      fold_tiles<float, TM, TN>(p, red, m0, n0);
    }
  } else {
    float* red = reinterpret_cast<float*>(ring);
    const int rg = warp / 2 * 8 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn + nt * 8 + 2 * t + j;
        red[(rg * 2) * TN + col] = s1[nt][j];
        red[(rg * 2 + 1) * TN + col] = s2[nt][j];
      }
    fold_moments<TN>(p, red, n0);
  }
}

// The same contraction in full f32 on the CUDA cores (an operand in bf16 is
// widened exactly), block tile kT x kT. Thread (tr, tc) holds rows 4 tr ..
// 4 tr + 3 and columns tc + 8 j of the tile; each output is one fmaf chain in
// k order.
__global__ void __launch_bounds__(kGThreads) dot_general_f32(const DgParams p) {
  __shared__ float as[kT * kFK];
  __shared__ float bs[kT * kFK];
  __shared__ float red[kT * kT];
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8, n0 = blockIdx.x * kT;
  const bool moments = p.epi == kMoments;
  const Loops lp(p, kT);
  float s1[8] = {}, s2[8] = {};
  for (int m0 = lp.m_first; m0 < p.m; m0 += lp.m_step) {
    float acc[4][8] = {};
    for (int bi = lp.b0; bi < p.nb; bi += lp.b_step) {
      for (int k0 = 0; k0 < p.k; k0 += kKT) {
        __syncthreads();
        stage_f32(as, p.a, bi, m0, p.m, k0, p.k);
        stage_f32(bs, p.b, bi, n0, p.n, k0, p.k);
        __syncthreads();
        for (int kk = 0; kk < kKT; ++kk) {
          float a[4], b[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = as[(tr * 4 + i) * kFK + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = bs[(tc + 8 * j) * kFK + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int mi = tr * 4 + i, ni = tc + 8 * j;
        if (p.epi == kStore) {
          store_out(p, blockIdx.z, m0 + mi, n0 + ni, acc[i][j]);
        } else if (p.epi == kSumBatch) {
          red[mi * kT + ni] = acc[i][j];
        } else if (m0 + mi < p.m) {
          add_moments(acc[i][j], s1[j], s2[j]);
        }
      }
  }
  if (p.epi == kSumBatch) fold_batches(p, red, blockIdx.y * kT, n0);
  if (moments) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[(tr * 2) * kT + tc + 8 * j] = s1[j];
      red[(tr * 2 + 1) * kT + tc + 8 * j] = s2[j];
    }
    fold_moments<kT>(p, red, n0);
  }
}

// The layout the wrapper passes: nb, m1, m2, n1, n2, k, then a's strides
// (batch, m1, m2, k) and b's (batch, n1, n2, k), in elements.
enum { kNb, kM1, kM2, kN1, kN2, kK, kSa, kSb = kSa + 4, kLayoutLen = kSb + 4 };

// How an operand reaches the tensor core (the one statement of the rule).
int feed_of(const void* p, const long long* s, int r2, int k, bool tensor_cores) {
  if (!tensor_cores) return kCudaCores;
  const bool base = reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const bool b8 = s[0] % 8 == 0, r18 = s[1] % 8 == 0, r28 = s[2] % 8 == 0, k8 = s[3] % 8 == 0;
  if (base && s[3] == 1 && k % 8 == 0 && b8 && r18 && r28) return kStraight;
  if (base && s[2] == 1 && r2 % 8 == 0 && b8 && r18 && k8) return kTransposed;
  return kStaged;
}

// The bf16 kernel's block tile (the one statement of the rule), from the
// output's rows m, columns n, batch nb and epilogue; the f32 kernel's is
// always kT x kT. A side of 32 or fewer takes 32 (no tile half zeros). The
// moments take the largest tile (their cluster splits the rows, in a fixed
// order). Otherwise the largest tile whose grid has at least min(kFill, the
// grid of 32 x 32 tiles) blocks: half the card where the output has that
// many 32 x 32 tiles (sum_batch: times its cluster), else every 32 x 32
// tile a block. 64 rows before 64 columns on a tie.
struct Tile {
  int m, n;
};
Tile tile_of(long long m, long long n, long long nb, int epilogue) {
  const int tm_max = m <= 32 ? 32 : 64, tn_max = n <= 32 ? 32 : 64;
  if (epilogue == kMoments) return {tm_max, tn_max};
  const long long per_tile = epilogue == kStore ? nb : std::min<long long>(kMaxCluster, nb);
  auto blocks = [&](int tm, int tn) { return (m + tm - 1) / tm * ((n + tn - 1) / tn) * per_tile; };
  const long long want = std::min<long long>(kFill, blocks(32, 32));
  for (const Tile c : {Tile{64, 64}, Tile{64, 32}, Tile{32, 64}})
    if (c.m <= tm_max && c.n <= tn_max && blocks(c.m, c.n) >= want) return c;
  return {32, 32};
}

// ---- dot_chain ----------------------------------------------------------------

constexpr int kP = 8;             // blocks of a chain's cluster
constexpr int kCThreads = 256;    // 8 warps
constexpr int kCW = kCThreads / 32;
constexpr int kCh = 64;           // C (and O)
constexpr int kS = 32;            // H = W = L = I
constexpr int kL40 = kS + 8;      // bf16 row strides that ldmatrix reads without bank conflicts
constexpr int kL72 = kCh + 8;
constexpr int kL136 = 4 * kS + 8;
enum Chain { kApply, kProjF, kMomentsF, kScrBf16, kScrF32, kScr2, kTransp, kChains };

// Element (r, k) of a matrix in shared memory: (r / r2) s1 + (r % r2) s2 + k sk.
struct View {
  int r2, s1, s2, sk;
  __device__ __forceinline__ int at(int r, int k) const {
    return r / r2 * s1 + r % r2 * s2 + k * sk;
  }
};

// out[m][n] = sum_k A(m, k) B(n, k) on mma.sync, bf16 operands in shared
// memory, f32 sums. A with kAT is read by ldmatrix.trans (its rows have unit
// stride, in runs of 8), else by ldmatrix (k has unit stride); B likewise.
// Warps take tiles of 16 MT x 8 NT in turn; epi(m, n, v[m][n], v[m][n + 1]).
template <bool kAT, bool kBT, int MT, int NT, class Epi>
__device__ __forceinline__ void mma_gemm(const bf16* A, View va, const bf16* B, View vb, int M,
                                         int N, int K, Epi&& epi) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int tn = N / (8 * NT), tiles = M / (16 * MT) * tn;
  for (int tile = warp; tile < tiles; tile += kCW) {
    const int m0 = tile / tn * 16 * MT, n0 = tile % tn * 8 * NT;
    float acc[MT][NT][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = m0 + mt * 16;
        if constexpr (kAT) {
          lns::ldsm_x4_trans(af[mt],
                             A + va.at(m + (lane >> 3 & 1) * 8, k0 + (lane & 7) + (lane >> 4) * 8));
        } else {
          lns::ldsm_x4(af[mt], A + va.at(m + (lane & 15), k0 + (lane >> 4) * 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        const int n = n0 + nt * 8;
        if constexpr (kBT) {
          uint32_t r[4];
          lns::ldsm_x4_trans(r, B + vb.at(n + (lane >> 4) * 8, k0 + (lane & 15)));
          bfr[nt][0] = r[0];
          bfr[nt][1] = r[1];
          bfr[nt + 1][0] = r[2];
          bfr[nt + 1][1] = r[3];
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t r[2];
            lns::ldsm_x2(r, B + vb.at(n + h * 8 + (lane & 7), k0 + (lane >> 3 & 1) * 8));
            bfr[nt + h][0] = r[0];
            bfr[nt + h][1] = r[1];
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) lns::mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epi(m0 + mt * 16 + g + 8 * h, n0 + nt * 8 + 2 * t, acc[mt][nt][2 * h],
              acc[mt][nt][2 * h + 1]);
  }
}

// A k-major f32 operand in shared memory: element (r, k) at (r / R) S + k LD
// + r % R floats, so that the rows of a thread's tile (a run within one R)
// are one 16-byte-aligned vector at each k. Everything is known at compile
// time: the k loop has no division or modulo.
template <int R, int S, int LD>
struct KMajor {
  static_assert(R % 4 == 0 && S % 4 == 0 && LD % 4 == 0, "16-byte vectors");
  static constexpr int kLD = LD;
  __device__ __forceinline__ static int at(int r, int k) { return r / R * S + k * LD + r % R; }
};

// TN floats of a k-major operand at p into v, as 16-byte loads
template <int TN>
__device__ __forceinline__ void ld_vec(float (&v)[TN], const float* p) {
#pragma unroll
  for (int j = 0; j < TN; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + j);
    v[j] = x.x;
    v[j + 1] = x.y;
    v[j + 2] = x.z;
    v[j + 3] = x.w;
  }
}

// out[m][n] = sum_k A(m, k) B(n, k) in full f32 on the CUDA cores, A and B
// k-major in shared memory (KMajor LA, LB). Register-blocked: thread t takes
// the TM x TN outputs at rows TM (t / (N / TN)), columns TN (t % (N / TN)),
// the 256 threads covering M x N once (a warp's lanes along the columns: B's
// vectors contiguous, A's broadcast to 32 / (N / TN) row tiles, a row's
// stores contiguous); per k it reads TM / 4 + TN / 4 16-byte vectors for TM
// TN fmaf. Each output is one fmaf chain in k order from 0, so any tiling
// gives the same bits. epi(m0, n0, acc[TM][TN]), called once by every
// thread.
template <int M, int N, int K, int TM, int TN, class LA, class LB, class Epi>
__device__ __forceinline__ void ffma_tile(const float* A, const float* B, Epi&& epi) {
  static_assert((M / TM) * (N / TN) == kCThreads && M % TM == 0 && N % TN == 0,
                "one tile a thread");
  const int m0 = static_cast<int>(threadIdx.x) / (N / TN) * TM;
  const int n0 = static_cast<int>(threadIdx.x) % (N / TN) * TN;
  const float* a = A + LA::at(m0, 0);
  const float* b = B + LB::at(n0, 0);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
    ld_vec(av, a + k * LA::kLD);
    ld_vec(bv, b + k * LB::kLD);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
  epi(m0, n0, acc);
}

// f32 copy of a bf16 matrix in shared memory: dst[r][c] (row stride dld)
// from src[r][c] (row stride sld, rows of 16-byte pieces), or with kT the
// transpose dst[c][r]; a thread takes 8 columns of one row at a time (the
// warp's 32 rows of one piece: transposed stores of 32 consecutive floats)
template <bool kT>
__device__ __forceinline__ void widen(float* dst, int dld, const bf16* src, int sld, int rows,
                                      int cols) {
  for (int e = threadIdx.x; e < rows * cols / 8; e += kCThreads) {
    const int r = e % rows, c8 = e / rows * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * sld + c8);
    const bf16* x = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (kT) {
        dst[(c8 + j) * dld + r] = __bfloat162float(x[j]);
      } else {
        dst[r * dld + c8 + j] = __bfloat162float(x[j]);
      }
    }
  }
}

// an epilogue that stores a thread's tile row by row into f32 o (row stride
// ld), 16-byte stores
template <int ld>
struct StoreRows {
  float* o;
  template <int TM, int TN>
  __device__ __forceinline__ void operator()(int m0, int n0, float (&acc)[TM][TN]) const {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; j += 4)
        *reinterpret_cast<float4*>(o + (m0 + i) * ld + n0 + j) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  }
};

// rows x cols bf16 (cols a multiple of 8) from global (row stride src_ld)
// into shared memory (row stride dst_ld) by 16-byte cp.async
__device__ __forceinline__ void load_rows(bf16* dst, int dst_ld, const bf16* src, int src_ld,
                                          int rows, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += kCThreads) {
    const int r = e / per_row, c8 = e % per_row * 8;
    lns::cp_async16(dst + r * dst_ld + c8, src + static_cast<size_t>(r) * src_ld + c8, true);
  }
}

// Copy `rows` runs of `bytes` (a multiple of 16) from every peer's shared
// memory into ours, each thread's loads from all peers issued together: run
// j of peer p from its base + src(j) to mine + dst(p, j) (byte offsets).
template <class T, class Src, class Dst>
__device__ __forceinline__ void pull_all(cg::cluster_group& cluster, T* base, unsigned char* mine,
                                         int rows, int bytes, Src src, Dst dst) {
  const int per = bytes / 16;
  for (int e = threadIdx.x; e < rows * per; e += kCThreads) {
    const int j = e / per, v = e % per * 16;
    uint4 x[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p)
      x[p] = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const unsigned char*>(cluster.map_shared_rank(base, p)) + src(j) + v);
#pragma unroll
    for (int p = 0; p < kP; ++p) *reinterpret_cast<uint4*>(mine + dst(p, j) + v) = x[p];
  }
}

// Shared-memory bytes of each chain (the regions the kernel carves, in order).
constexpr int kBf = 2, kF = 4;
constexpr int chain_smem(int c) {
  return c == kApply || c == kScrBf16
             ? kBf * (8 * kS * kL40 + 2 * kS * kL40 + kCh * kL72 + 3 * 8 * kS * kL40)
         : c == kScrF32
             ? kBf * (8 * kS * kL40 + 2 * kS * kL40 + kCh * kL72 + 8 * kS * kL40) +
                   kF * (2 * kS * 8 * kS + kCh * kCh)
         : c == kProjF || c == kMomentsF
             ? kBf * (kCh * kL136 + 2 * kS * kL40 + kCh * kL72 + 3 * kCh * 4 * kL40)
         : c == kScr2
             ? kBf * (8 * kS * kL40 + 2 * kS * kL40 + kCh * kL72) + kF * (2 * kS * kS) +
                   kF * 3 * 8 * kS * kS
             : kBf * (4 * kCh * kL40 + kCh * kL72 + kS * kS) + kF * (2 * kS * 4 * kCh + kS * kS);
}
static_assert(chain_smem(kApply) == 96256 && chain_smem(kScrF32) == 137216 &&
                  chain_smem(kProjF) == 93184 && chain_smem(kScr2) == 141312 &&
                  chain_smem(kTransp) == 101376,
              "the live sets stated above");
static_assert(chain_smem(kScr2) <= lns::kMaxDynamicSmem &&
                  chain_smem(kScrF32) <= lns::kMaxDynamicSmem,
              "a block's shared memory");

// Chains 0, 3, 4: block r owns c [8r, 8r + 8) of a and bb, then i [4r, 4r + 4)
// of the output.
template <int kCase>
__device__ __forceinline__ void chain_by_c(unsigned char* sm, cg::cluster_group& cluster,
                                           const bf16* u, const bf16* k2, const bf16* k3,
                                           const bf16* m, void* out) {
  using BB = typename std::conditional<kCase == kScrF32, float, bf16>::type;
  constexpr int kBL = kCase == kScrF32 ? kS : kL40;  // bb's row stride
  const int r = static_cast<int>(cluster.block_rank()), c0 = 8 * r, i0 = 4 * r;
  bf16* u_s = reinterpret_cast<bf16*>(sm);  // [c 8][h 32][kL40]
  bf16* k2_s = u_s + 8 * kS * kL40;         // [l][kL40]
  bf16* k3_s = k2_s + kS * kL40;            // [i][kL40]
  bf16* m_s = k3_s + kS * kL40;             // [c][kL72]
  bf16* a_s = m_s + kCh * kL72;             // [c 8][h 32][kL40]
  BB* bb_s = reinterpret_cast<BB*>(a_s + 8 * kS * kL40);  // [i 32][c 8][kBL]
  BB* g_s = bb_s + kS * 8 * kBL;                          // [i 4][c 64][kBL]
  float* mf_s = reinterpret_cast<float*>(g_s + 4 * kCh * kBL);  // chain 4: f32(m) [c][o]
  load_rows(u_s, kL40, u + c0 * kS * kS, kS, 8 * kS, kS);  // three commit groups, in the
  load_rows(k2_s, kL40, k2, kS, kS, kS);                    // order the stages need them
  lns::cp_async_commit();
  load_rows(k3_s, kL40, k3, kS, kS, kS);
  lns::cp_async_commit();
  load_rows(m_s, kL72, m, kCh, kCh, kCh);
  lns::cp_async_commit();
  lns::cp_async_wait<2>();
  __syncthreads();
  // a = bf16(u . k2): rows (c, h), columns l, depth w
  mma_gemm<false, false, 2, 4>(u_s, View{8 * kS, 0, kL40, 1}, k2_s, View{kS, 0, kL40, 1}, 8 * kS,
                               kS, kS, [&](int mi, int n, float v0, float v1) {
                                 store2(a_s + mi * kL40 + n, v0, v1);
                               });
  lns::cp_async_wait<1>();
  __syncthreads();
  // bb = k3 . a: rows i, columns (c, l), depth h; bf16 (rounded once) or f32
  mma_gemm<false, true, 2, 4>(k3_s, View{kS, 0, kL40, 1}, a_s, View{kS, kS * kL40, 1, kL40}, kS,
                              8 * kS, kS, [&](int i, int n, float v0, float v1) {
                                store2(bb_s + (i * 8 + n / kS) * kBL + n % kS, v0, v1);
                              });
  lns::cp_async_wait<0>();
  if constexpr (kCase == kScrF32) {
    __syncthreads();
    widen<false>(mf_s, kCh, m_s, kL72, kCh, kCh);
  }
  cluster.sync();  // every block's bb is whole
  // g[i][8p + c][l] = bb of peer p at [i0 + i][c][l]
  constexpr int kB = static_cast<int>(sizeof(BB));
  pull_all(cluster, bb_s, reinterpret_cast<unsigned char*>(g_s), 4 * 8, kS * kB,
           [&](int j) { return kB * ((i0 + j / 8) * 8 + j % 8) * kBL; },
           [&](int p, int j) { return kB * (j / 8 * kCh + 8 * p + j % 8) * kBL; });
  cluster.sync();  // no block reads a peer after this
  // out = bb . m: rows (i, l), columns o, depth c
  const View vg{kS, kCh * kBL, 1, kBL}, vm{kCh, 0, 1, kL72};
  if constexpr (kCase == kScrF32) {  // rows (i, l), columns o, depth c, on the CUDA cores
    ffma_tile<4 * kS, kCh, kCh, 4, 8, KMajor<kS, kCh * kS, kS>, KMajor<kCh, 0, kCh>>(
        g_s, mf_s, StoreRows<kCh>{static_cast<float*>(out) + i0 * kS * kCh});
  } else if constexpr (kCase == kApply) {
    bf16* o = static_cast<bf16*>(out) + i0 * kS * kCh;
    mma_gemm<true, true, 2, 4>(g_s, vg, m_s, vm, 4 * kS, kCh, kCh,
                               [&](int mi, int n, float v0, float v1) {
                                 store2(o + mi * kCh + n, v0 + v0, v1 + v1);
                               });
  } else {
    float* o = static_cast<float*>(out) + i0 * kS * kCh;
    mma_gemm<true, true, 2, 4>(g_s, vg, m_s, vm, 4 * kS, kCh, kCh,
                               [&](int mi, int n, float v0, float v1) {
                                 store2(o + mi * kCh + n, v0, v1);
                               });
  }
}

// Chains 1, 2: block r owns h [4r, 4r + 4) of v and a, then o [8r, 8r + 8)
// of the output.
template <int kCase>
__device__ __forceinline__ void chain_by_h(unsigned char* sm, cg::cluster_group& cluster,
                                           const bf16* u, const bf16* k2, const bf16* k3,
                                           const bf16* m, float* out) {
  const int r = static_cast<int>(cluster.block_rank()), h0 = 4 * r, o0 = 8 * r;
  bf16* u_s = reinterpret_cast<bf16*>(sm);  // [c][(h 4, w 32)][kL136]
  bf16* k2_s = u_s + kCh * kL136;
  bf16* k3_s = k2_s + kS * kL40;
  bf16* m_s = k3_s + kS * kL40;             // [c][kL72]
  bf16* v_s = m_s + kCh * kL72;             // [o 64][h 4][kL40]
  bf16* a_s = v_s + kCh * 4 * kL40;         // [o 64][h 4][kL40]
  bf16* g_s = a_s + kCh * 4 * kL40;         // [o 8][h 32][kL40]
  load_rows(u_s, kL136, u + h0 * kS, kS * kS, kCh, 4 * kS);  // three commit groups, in the
  load_rows(m_s, kL72, m, kCh, kCh, kCh);                      // order the stages need them
  lns::cp_async_commit();
  load_rows(k2_s, kL40, k2, kS, kS, kS);
  lns::cp_async_commit();
  load_rows(k3_s, kL40, k3, kS, kS, kS);
  lns::cp_async_commit();
  lns::cp_async_wait<2>();
  __syncthreads();
  // v = bf16(m^T . u): rows o, columns (h, w), depth c
  mma_gemm<true, true, 2, 4>(m_s, View{kCh, 0, 1, kL72}, u_s, View{4 * kS, 0, 1, kL136}, kCh,
                             4 * kS, kCh, [&](int o, int n, float v0, float v1) {
                               store2(v_s + (o * 4 + n / kS) * kL40 + n % kS, v0, v1);
                             });
  lns::cp_async_wait<1>();
  __syncthreads();
  // a = bf16(v . k2): rows (o, h), columns l, depth w
  mma_gemm<false, false, 2, 4>(v_s, View{kCh * 4, 0, kL40, 1}, k2_s, View{kS, 0, kL40, 1},
                               kCh * 4, kS, kS, [&](int mi, int n, float v0, float v1) {
                                 store2(a_s + mi * kL40 + n, v0, v1);
                               });
  lns::cp_async_wait<0>();
  cluster.sync();
  // g[o][4p + h][l] = a of peer p at [o0 + o][h][l]
  pull_all(cluster, a_s, reinterpret_cast<unsigned char*>(g_s), 8 * 4, kS * kBf,
           [&](int j) { return kBf * ((o0 + j / 4) * 4 + j % 4) * kL40; },
           [&](int p, int j) { return kBf * (j / 4 * kS + 4 * p + j % 4) * kL40; });
  cluster.sync();
  // t = k3 . a: rows i, columns (o, l), depth h; warp w's tile is o0 + w whole
  const View vk3{kS, 0, kL40, 1}, vg{kS, kS * kL40, 1, kL40};
  if constexpr (kCase == kProjF) {
    float* o = out + o0 * kS;
    mma_gemm<false, true, 2, 4>(k3_s, vk3, g_s, vg, kS, 8 * kS, kS,
                                [&](int i, int n, float v0, float v1) {
                                  store2(o + i * kCh * kS + n, v0 + v0, v1 + v1);
                                });
  } else {
    float s1 = 0.f, s2 = 0.f;
    mma_gemm<false, true, 2, 4>(k3_s, vk3, g_s, vg, kS, 8 * kS, kS,
                                [&](int, int, float v0, float v1) {
                                  add_moments(v0, s1, s2);
                                  add_moments(v1, s1, s2);
                                });
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (threadIdx.x % 32 == 0) store2(out + 2 * (o0 + threadIdx.x / 32), s1, s2);
  }
}

// The sum of v over the four lanes that share lane % 8 (ffma_tile's four row
// tiles of one column tile in a warp) in a tree fixed by the lane numbers:
// (l + (l ^ 8)) then (. + (. ^ 16)), the same bits in all four lanes.
__device__ __forceinline__ float lane_tree(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)) of v[k stride]
__device__ __forceinline__ float tree8(const float* v, int stride) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[stride]), __fadd_rn(v[2 * stride], v[3 * stride])),
                   __fadd_rn(__fadd_rn(v[4 * stride], v[5 * stride]),
                             __fadd_rn(v[6 * stride], v[7 * stride])));
}

// Chain 5, all f32 on the CUDA cores: block r owns c [8r, 8r + 8) of a and
// bb, then i [4r, 4r + 4) of phi and the output. The inputs are widened to
// f32 k-major copies as their commit groups land (u and k2 first: the first
// product starts while k3 and m are landing). phi is never stored: the
// column sums of phi and phi^2 are taken from its product's registers in a
// fixed tree over the block's 256 row groups of 4 rows (i, l), each summed
// in row order (ffma_tile's rows: thread tree, lane_tree, the 8 warps by
// tree8), then over the 8 blocks in rank order by tree8 in every block: the
// same bits in every block and every run.
__device__ __forceinline__ void chain_scr2(unsigned char* sm, cg::cluster_group& cluster,
                                           const bf16* u, const bf16* k2, const bf16* k3,
                                           const bf16* m, float* out) {
  const int r = static_cast<int>(cluster.block_rank()), c0 = 8 * r, i0 = 4 * r;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* u_s = reinterpret_cast<bf16*>(sm);           // [(c 8, h 32)][kL40], raw
  bf16* k2_s = u_s + 8 * kS * kL40;                  // [l][kL40], raw
  bf16* k3_s = k2_s + kS * kL40;                     // [i][kL40], raw
  bf16* m_s = k3_s + kS * kL40;                      // [c][kL72], raw
  float* k2t_s = reinterpret_cast<float*>(m_s + kCh * kL72);  // [w][l]
  float* k3t_s = k2t_s + kS * kS;                    // [h][i]
  float* r1_s = k3t_s + kS * kS;                     // u^T [w][(c, h)]; bb; (m inv)^T, mm
  float* r2_s = r1_s + 8 * kS * kS;                  // a [(c, h)][l]; f32(m) [c][d], m^T [d][c]
  float* g_s = r2_s + 8 * kS * kS;                   // [i 4][c 64][l]
  float* ut_s = r1_s, *bb_s = r1_s, *winvt_s = r1_s, *mm_s = r1_s + kCh * kCh;
  float* a_s = r2_s, *mf_s = r2_s, *mt_s = r2_s + kCh * kCh;
  // the raw u is consumed by then: per-warp column sums [warp][s1, s2][d],
  // the ranks' sums [rank][s1, s2][d], the statistics mean, inv, mean inv,
  // bias [d]
  float* part_s = reinterpret_cast<float*>(u_s);
  float* red_s = part_s + kCW * 2 * kCh;
  float* st_s = red_s + kP * 2 * kCh;
  load_rows(u_s, kL40, u + c0 * kS * kS, kS, 8 * kS, kS);  // three commit groups, in the
  load_rows(k2_s, kL40, k2, kS, kS, kS);                    // order the stages need them
  lns::cp_async_commit();
  load_rows(k3_s, kL40, k3, kS, kS, kS);
  lns::cp_async_commit();
  load_rows(m_s, kL72, m, kCh, kCh, kCh);
  lns::cp_async_commit();
  lns::cp_async_wait<2>();
  __syncthreads();
  widen<true>(ut_s, 8 * kS, u_s, kL40, 8 * kS, kS);
  widen<true>(k2t_s, kS, k2_s, kL40, kS, kS);
  __syncthreads();
  // a = u . k2: rows (c, h), columns l, depth w
  ffma_tile<8 * kS, kS, kS, 8, 4, KMajor<8 * kS, 0, 8 * kS>, KMajor<kS, 0, kS>>(
      ut_s, k2t_s, StoreRows<kS>{a_s});
  lns::cp_async_wait<1>();
  __syncthreads();
  widen<true>(k3t_s, kS, k3_s, kL40, kS, kS);
  __syncthreads();
  // bb = k3 . a: rows i, columns (c, l), depth h
  ffma_tile<kS, 8 * kS, kS, 4, 8, KMajor<kS, 0, kS>, KMajor<kS, kS * kS, kS>>(
      k3t_s, a_s, StoreRows<8 * kS>{bb_s});
  lns::cp_async_wait<0>();
  __syncthreads();  // a is consumed, m has landed
  widen<false>(mf_s, kCh, m_s, kL72, kCh, kCh);
  widen<true>(mt_s, kCh, m_s, kL72, kCh, kCh);
  cluster.sync();  // every block's bb is whole
  // g[i][8p + c][l] = bb of peer p at [i0 + i][c][l]
  pull_all(cluster, bb_s, reinterpret_cast<unsigned char*>(g_s), 4, 8 * kS * kF,
           [&](int j) { return kF * (i0 + j) * 8 * kS; },
           [&](int p, int j) { return kF * (j * kCh + 8 * p) * kS; });
  cluster.sync();  // no block reads a peer's bb after this
  using LG = KMajor<kS, kCh * kS, kS>;  // g: rows (i, l), depth c
  // phi = bb . m: rows (i, l), columns d, depth c; only its column sums
  ffma_tile<4 * kS, kCh, kCh, 4, 8, LG, KMajor<kCh, 0, kCh>>(
      g_s, mf_s, [&](int, int n0, float (&acc)[4][8]) {
        float s[2][8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[0][j] = acc[0][j];
          s[1][j] = __fmul_rn(acc[0][j], acc[0][j]);
#pragma unroll
          for (int i = 1; i < 4; ++i) {
            s[0][j] = __fadd_rn(s[0][j], acc[i][j]);
            s[1][j] = __fadd_rn(s[1][j], __fmul_rn(acc[i][j], acc[i][j]));
          }
          s[0][j] = lane_tree(s[0][j]);
          s[1][j] = lane_tree(s[1][j]);
        }
        if (lane < 8)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            part_s[(warp * 2) * kCh + n0 + j] = s[0][j];
            part_s[(warp * 2 + 1) * kCh + n0 + j] = s[1][j];
          }
      });
  __syncthreads();
  if (threadIdx.x < 2 * kCh) {  // the block's sums over its 8 warps, sent to every block
    const float v = tree8(part_s + threadIdx.x, 2 * kCh);
    for (int p = 0; p < kP; ++p) *cluster.map_shared_rank(red_s + r * 2 * kCh + threadIdx.x, p) = v;
  }
  cluster.sync();  // every block's sums are in every block
  if (threadIdx.x < kCh) {
    const int d = threadIdx.x;
    const float s1 = tree8(red_s + d, 2 * kCh), s2 = tree8(red_s + kCh + d, 2 * kCh);
    const float n = static_cast<float>(kS * kS);
    const float mean = __fdiv_rn(s1, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean)), 0.f);
    const float inv = __frsqrt_rn(__fadd_rn(var, 1e-5f));
    st_s[d] = mean;
    st_s[kCh + d] = inv;
    st_s[2 * kCh + d] = __fmul_rn(mean, inv);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kCh * kCh; e += kCThreads)  // (m inv)^T [d][c]
    winvt_s[e] = __fmul_rn(mt_s[e], st_s[kCh + e / kCh]);
  if (threadIdx.x < kCh) {  // bias = (mean inv) . m^T
    float b = 0.f;
    for (int d = 0; d < kCh; ++d) b = fmaf(st_s[2 * kCh + d], mf_s[threadIdx.x * kCh + d], b);
    st_s[3 * kCh + threadIdx.x] = b;
  }
  __syncthreads();
  // mm = (m inv) . m^T: rows c, columns c', depth d
  ffma_tile<kCh, kCh, kCh, 4, 4, KMajor<kCh, 0, kCh>, KMajor<kCh, 0, kCh>>(
      winvt_s, mt_s, StoreRows<kCh>{mm_s});
  __syncthreads();
  // out = (t - bias) + t, t = bb . mm: rows (i, l), columns o, depth c
  float* o = out + i0 * kS * kCh;
  const float* bias = st_s + 3 * kCh;
  ffma_tile<4 * kS, kCh, kCh, 4, 8, LG, KMajor<kCh, 0, kCh>>(
      g_s, mm_s, [&](int m0, int n0, float (&acc)[4][8]) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; j += 4) {
            float v[4];
#pragma unroll
            for (int x = 0; x < 4; ++x)
              v[x] = __fadd_rn(__fsub_rn(acc[i][j + x], bias[n0 + j + x]), acc[i][j + x]);
            *reinterpret_cast<float4*>(o + (m0 + i) * kCh + n0 + j) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
      });
}

// Chain 6: block r owns y [4r, 4r + 4) of a = q . m, stored [x][y][m1];
// then x [4r, 4r + 4) of bb = a' . k2.
__device__ __forceinline__ void chain_transp(unsigned char* sm, cg::cluster_group& cluster,
                                             const bf16* q, const bf16* k2, const bf16* m,
                                             float* out) {
  const int r = static_cast<int>(cluster.block_rank()), y0 = 4 * r, x0 = 4 * r;
  bf16* q_s = reinterpret_cast<bf16*>(sm);  // [y 4][c 64][x kL40]
  bf16* m_s = q_s + 4 * kCh * kL40;         // [c][kL72]
  bf16* k2_s = m_s + kCh * kL72;            // [l][y]
  float* s_s = reinterpret_cast<float*>(k2_s + kS * kS);  // a': [x 32][y 4][m1 64]
  float* g_s = s_s + kS * 4 * kCh;                        // [x 4][y 32][m1 64]
  float* k2t_s = g_s + 4 * kS * kCh;                      // f32 [y][l]
  load_rows(q_s, kL40, q + y0 * kCh * kS, kS, 4 * kCh, kS);  // two commit groups, in the
  load_rows(m_s, kL72, m, kCh, kCh, kCh);                    // order the stages need them
  lns::cp_async_commit();
  load_rows(k2_s, kS, k2, kS, kS, kS);
  lns::cp_async_commit();
  lns::cp_async_wait<1>();
  __syncthreads();
  // a = q . m: rows (y, x), columns m1, depth c, stored with y and x swapped
  mma_gemm<true, true, 2, 4>(q_s, View{kS, kCh * kL40, 1, kL40}, m_s, View{kCh, 0, 1, kL72},
                             4 * kS, kCh, kCh, [&](int mi, int n, float v0, float v1) {
                               store2(s_s + (mi % kS * 4 + mi / kS) * kCh + n, v0, v1);
                             });
  lns::cp_async_wait<0>();
  __syncthreads();
  widen<true>(k2t_s, kS, k2_s, kS, kS, kS);
  cluster.sync();
  // g[x][4p + y][m1] = a' of peer p at [x0 + x][y][m1]
  pull_all(cluster, s_s, reinterpret_cast<unsigned char*>(g_s), 4, 4 * kCh * kF,
           [&](int j) { return kF * (x0 + j) * 4 * kCh; },
           [&](int p, int j) { return kF * (j * kS + 4 * p) * kCh; });
  cluster.sync();
  // bb = a' . k2: rows (x, m1), columns l, depth y, in f32 on the CUDA cores
  ffma_tile<4 * kCh, kS, kS, 8, 4, KMajor<kCh, kS * kCh, kCh>, KMajor<kS, 0, kS>>(
      g_s, k2t_s, StoreRows<kS>{out + x0 * kCh * kS});
}

template <int kCase>
__global__ void __launch_bounds__(kCThreads, 1)
dot_chain_kernel(const bf16* __restrict__ u, const bf16* __restrict__ k2,
                 const bf16* __restrict__ k3, const bf16* __restrict__ q,
                 const bf16* __restrict__ m, void* __restrict__ out) {
  extern __shared__ uint4 smem_chain[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_chain);
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (kCase == kApply || kCase == kScrBf16 || kCase == kScrF32) {
    chain_by_c<kCase>(sm, cluster, u, k2, k3, m, out);
  } else if constexpr (kCase == kProjF || kCase == kMomentsF) {
    chain_by_h<kCase>(sm, cluster, u, k2, k3, m, static_cast<float*>(out));
  } else if constexpr (kCase == kScr2) {
    chain_scr2(sm, cluster, u, k2, k3, m, static_cast<float*>(out));
  } else {
    chain_transp(sm, cluster, q, k2, m, static_cast<float*>(out));
  }
}

template <int kCase>
cudaError_t launch_chain(const void* u, const void* k2, const void* k3, const void* q,
                         const void* m, void* out, cudaStream_t stream) {
  constexpr int smem = chain_smem(kCase);
  cudaError_t e = lns::allow_smem(dot_chain_kernel<kCase>, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kP);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kP;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dot_chain_kernel<kCase>, static_cast<const bf16*>(u),
                         static_cast<const bf16*>(k2), static_cast<const bf16*>(k3),
                         static_cast<const bf16*>(q), static_cast<const bf16*>(m), out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// dot_general's limits (the one statement of them): nullptr when it takes
// the layout, dtypes and epilogue, else the limit they break. Dtype codes:
// 0 f32, 1 bf16.
extern "C" const char* lns_dot_general_limit(const long long* l, int a_dtype, int b_dtype,
                                             int out_dtype, int epilogue) {
  static thread_local char msg[200];
  const long long m = l[kM1] * l[kM2], n = l[kN1] * l[kN2];
  if (a_dtype < 0 || a_dtype > 1 || b_dtype < 0 || b_dtype > 1 || out_dtype < 0 || out_dtype > 1) {
    snprintf(msg, sizeof msg, "bf16 or f32 operands and output, got dtype codes %d, %d, %d",
             a_dtype, b_dtype, out_dtype);
    return msg;
  }
  if (epilogue < kStore || epilogue > kMoments) {
    snprintf(msg, sizeof msg, "an epilogue of store, sum_batch or moments, got code %d", epilogue);
    return msg;
  }
  if (l[kNb] < 1 || l[kM1] < 1 || l[kM2] < 1 || l[kN1] < 1 || l[kN2] < 1 || l[kK] < 1) {
    snprintf(msg, sizeof msg, "every size at least 1");
    return msg;
  }
  if (m > 2147483647LL || n > 2147483647LL || l[kK] > 2147483647LL) {
    snprintf(msg, sizeof msg, "m, n and k below 2^31, got %lld, %lld, %lld", m, n, l[kK]);
    return msg;
  }
  const Tile t = a_dtype == 1 && b_dtype == 1 ? tile_of(m, n, l[kNb], epilogue) : Tile{kT, kT};
  const long long mt = (m + t.m - 1) / t.m, nt = (n + t.n - 1) / t.n;
  if (epilogue == kMoments && (l[kNb] != 1 || out_dtype != 0)) {
    snprintf(msg, sizeof msg, "the moments epilogue without a batch dim and with an f32 output");
  } else if (epilogue != kMoments && mt > 65535) {
    snprintf(msg, sizeof msg, "at most 65535 tiles of %d output rows (the grid's y), got %lld",
             t.m, mt);
  } else if (epilogue == kStore && l[kNb] > 65535) {
    snprintf(msg, sizeof msg, "a batch of at most 65535 (the grid's z), got %lld", l[kNb]);
  } else if (nt > 2147483647LL) {
    snprintf(msg, sizeof msg, "fewer than 2^31 tiles of %d output columns", t.n);
  } else {
    return nullptr;
  }
  return msg;
}

// Launch dot_general; feeds (host memory, two ints) receives each operand's
// feed (0 straight, 1 transposed, 2 staged, 3 f32 on the CUDA cores), plan
// (four ints) the block tile's rows and columns (tile_of), the blocks and
// the cluster.
extern "C" int lns_dot_general(const long long* l, int a_dtype, int b_dtype, int out_dtype,
                               int epilogue, const void* a, const void* b, void* out, int* feeds,
                               int* plan, void* stream) {
  if (lns_dot_general_limit(l, a_dtype, b_dtype, out_dtype, epilogue)) return cudaErrorInvalidValue;
  const bool tc = a_dtype == 1 && b_dtype == 1;
  DgParams p;
  p.a = {a, l[kSa], l[kSa + 1], l[kSa + 2], l[kSa + 3], static_cast<int>(l[kM2]),
         feed_of(a, l + kSa, static_cast<int>(l[kM2]), static_cast<int>(l[kK]), tc), a_dtype};
  p.b = {b, l[kSb], l[kSb + 1], l[kSb + 2], l[kSb + 3], static_cast<int>(l[kN2]),
         feed_of(b, l + kSb, static_cast<int>(l[kN2]), static_cast<int>(l[kK]), tc), b_dtype};
  p.out = out;
  p.nb = static_cast<int>(l[kNb]);
  p.m = static_cast<int>(l[kM1] * l[kM2]);
  p.n = static_cast<int>(l[kN1] * l[kN2]);
  p.k = static_cast<int>(l[kK]);
  p.epi = epilogue;
  p.out_bf = out_dtype;
  const Tile t = tc ? tile_of(p.m, p.n, p.nb, epilogue) : Tile{kT, kT};
  const int m_tiles = (p.m + t.m - 1) / t.m;
  p.cl = epilogue == kSumBatch ? std::min(kMaxCluster, p.nb)
         : epilogue == kMoments ? std::min(kMaxCluster, m_tiles) : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.n + t.n - 1) / t.n, epilogue == kMoments ? 1 : m_tiles,
                     epilogue == kStore ? p.nb : p.cl);
  cfg.blockDim = dim3(kGThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  if (feeds) {
    feeds[0] = p.a.feed;
    feeds[1] = p.b.feed;
  }
  if (plan) {
    const long long blocks = 1LL * cfg.gridDim.x * cfg.gridDim.y * cfg.gridDim.z;
    plan[0] = t.m;
    plan[1] = t.n;
    plan[2] = static_cast<int>(std::min(blocks, 2147483647LL));
    plan[3] = p.cl;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = p.cl;
  cfg.attrs = &attr;
  cfg.numAttrs = p.cl > 1;  // a cluster of one block launches without the attribute
  void (*kernel)(DgParams) = !tc          ? dot_general_f32
                             : t.m == 32 ? (t.n == 32 ? dot_general_bf16<32, 32>
                                                      : dot_general_bf16<32, 64>)
                                         : (t.n == 32 ? dot_general_bf16<64, 32>
                                                      : dot_general_bf16<64, 64>);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// dot_chain's limits: the chain's number, bf16 inputs (dtype code 1) and the
// TPU probe's shape, C 64 and H = W = L = I = 32.
extern "C" const char* lns_dot_chain_limit(int chain, int dtype, int c, int h, int w, int l,
                                           int i) {
  static thread_local char msg[200];
  if (chain < 0 || chain >= kChains) {
    snprintf(msg, sizeof msg, "a chain number in [0, %d), got %d", kChains, chain);
  } else if (dtype != 1) {
    snprintf(msg, sizeof msg, "bf16 inputs (the probe's dtype), got dtype code %d", dtype);
  } else if (c != kCh || h != kS || w != kS || l != kS || i != kS) {
    snprintf(msg, sizeof msg,
             "C %d and H = W = L = I = %d (the probe's shape; a cluster of %d blocks of at most "
             "%d bytes of shared memory), got C %d, H %d, W %d, L %d, I %d",
             kCh, kS, kP, chain_smem(kScr2), c, h, w, l, i);
  } else {
    return nullptr;
  }
  return msg;
}

// Launch chain `chain` (one cluster of 8 blocks) on `stream`; q is read by
// chain 6 only, u and k3 by the others.
extern "C" int lns_dot_chain(int chain, const void* u, const void* k2, const void* k3,
                             const void* q, const void* m, void* out, void* stream) {
  if (lns_dot_chain_limit(chain, 1, kCh, kS, kS, kS, kS)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chain) {
    case kApply: return launch_chain<kApply>(u, k2, k3, q, m, out, s);
    case kProjF: return launch_chain<kProjF>(u, k2, k3, q, m, out, s);
    case kMomentsF: return launch_chain<kMomentsF>(u, k2, k3, q, m, out, s);
    case kScrBf16: return launch_chain<kScrBf16>(u, k2, k3, q, m, out, s);
    case kScrF32: return launch_chain<kScrF32>(u, k2, k3, q, m, out, s);
    case kScr2: return launch_chain<kScr2>(u, k2, k3, q, m, out, s);
    default: return launch_chain<kTransp>(u, k2, k3, q, m, out, s);
  }
}

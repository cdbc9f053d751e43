// FAB core: axial applications in channel space, InstanceNorm statistics from
// the Gram matrix, and the folded out-projection summed over heads.
//
// Replaces lns_tpu/pallas_kernels/fab_core.py: fab_fused_core (_fused_kernel),
// the drop-in for FABlock2D._batched_gram_core. Shapes (row-major):
//   u [b, h, w, c]   k_x [b, n, h, h]   k_y [b, n, w, w]   (dtype T)
//   w_in [c, n, d] (T)   w_o1 [n, d, o] (f32)   ->   out [b, h, w, o] (T)
// Per (sample, head): bb = k_x . u . k_y^T (per channel), phi = bb . W_in
// (never formed), mean/var of phi over (h, w) per d from
// mean_c = sum_ij sum(k_x)_i sum(k_y)_j u_ij / N and E[phi^2] = W_in^T (G/N) W_in
// with G the c x c Gram of bb; m = W_in diag(inv) W_o1, bias = (mean inv) W_o1;
// out = sum_heads (bb . m) - sum_heads bias.
//
// bf16 also takes the mean as the jitted JAX FAB block feeds it to
// _batched_gram_core (kernels/fab_core.py: block_mean_c), where the caller
// gives its inputs: x [b, h, w, c] (bf16; u = bf16(bf16(x sc) + sh), the
// block's GroupNorm(1)), coef [b, 2, c] (its sc, sh; f32) and the f32 row
// sums of the unrounded kernels, sx [b, n, h] and sy [b, n, w]: mean_c =
// sum_ij sx_i sy_j (bf16(x_ij sc) + sh) / N, from the GroupNorm output
// before its last rounding. The variance stays max(E[phi^2] - mean^2, 0),
// as in _batched_gram_core.
//
// What bounds it on an H100: the bf16 tensor-core rate. At SW's 48x96,
// c = o = d = 64, 8 heads, b336 one call is ~437 GFLOP (both axial applies,
// the Gram, the c -> o product; 0.442 ms at 989 TFLOP/s) against ~0.66 GB
// of u, x, k and out (0.20 ms at 3.35 TB/s); at NS2d's 32x32 b116 ~24.5
// GFLOP (0.025 ms) against ~0.05 GB (0.015 ms). This design adds the bb
// scratch's write and read, 2 x 1.59 GB at 48x96 b336 (0.95 ms) and
// 2 x 0.12 GB at 32x32 b116 (0.07 ms).
//
// bf16 design (four passes; sm_90a: TMA, mbarriers, clusters, wgmma from
// hopper.cuh). The TPU kernel holds a sample's field per program and sums
// the heads over a sequential grid axis; on the H100 a sample's bb does not
// fit in a block, and the statistics must be complete before bb . m:
//   mean     one block per sample (fab_block_mean_bf16): mean_c [b, n, c] of
//            every head from one read of the sample's x (or u).
//   stats    one block per (head, sample), the sample's heads one cluster
//            (fab_bb_stats_bf16). A producer warpgroup (one thread issues;
//            it hands its registers to the consumers) streams u's rows
//            through a ring of shared memory by TMA; each stage is loaded
//            once and multicast to every block of the cluster, so u is read
//            from device memory once per sample per tile of L columns (once
//            at NS2d's fields, 6 times at SW's 48x96), not once per head.
//            Two consumer warpgroups run the products on wgmma (m64, f32
//            accumulators) from shared memory, at _batched_gram_core's
//            rounding points: a = bf16(u . k_y^T) a ring stage at a time as it
//            lands ([c x L] per row, the stages taken by the warpgroups in
//            turn), bb = bf16(k_x . a) a column at a time
//            ([c x h], written over a), then G += bb^T bb (alternate 16-pixel
//            steps per warpgroup, the two sums added once at the end). bb
//            leaves once by TMA store to a scratch [b, n, h, w, cp] (cp: c
//            padded to whole 64-channel atoms), G to a scratch [b, n, c, c]
//            (f32); the axial applies are never recomputed.
//   moments  one block per (head, sample) (fab_moments_bf16), several to an
//            SM: E[phi^2] and the mean from G, mean_c and W_in, then m =
//            bf16(W_in diag(inv) W_o1) [cp, o] and the bias, f32 on CUDA
//            cores in 4 x 4 register blocks.
//   out      one block per (128 pixels, 64 columns of o, sample)
//            (fab_out_bf16): sum_n bb_n . m_n as one wgmma product with K = n
//            cp in f32, a head per stage of a TMA ring filled by a producer
//            warp; out = bf16(bf16(sum) - bf16(sum of the heads' biases, in
//            head order)), staged in shared memory and stored by TMA.
// Every wgmma stage is straight-line: accumulators set before the fence,
// no other instruction touching them until the wait, no branch around a
// product, and barrier waits polled inside their asm; otherwise ptxas
// serializes each wgmma behind the last one. No atomics and no dependence
// on scheduling: two runs give the same bits.
// For w <= h k_y is applied first, for w > h k_x (as _batched_gram_core):
// the kernels then work on the transposed field, whose rows and columns the
// tensor maps' boxes read and write in place (no copy). Side lengths are
// padded to 16 and c to 64 with zeros (TMA fills what lies outside a
// tensor with zeros and stores none of it); the statistics divide by the
// true h w. Shared memory per block: stats 72,832 bytes at 16x16 c64,
// 210,048 at 32x32 and 224,384 at SW's 48x96 (plan_for: the widest tile,
// then the deepest u ring that fits); moments 54,016 and out 116,096 at c =
// d = o = 64. Limits, stated once in bf16_limit (the launcher refuses, the
// wrapper raises with its text): c a multiple of 16 up to 128, o a multiple
// of 16, h and w up to 128, and each pass's block within 227 KB.
//
// f32 (the check path, not timed): two passes of f32 FMAs on CUDA cores, bb
// in tiles of kTI = 2 rows, k_x applied first; f32 has no tensor-core form
// at the TPU kernel's precision.

#include <algorithm>
#include <cstdio>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using lns::ld;

constexpr int kThreads = 256;

// ---- f32: FMA kernels ------------------------------------------------------

constexpr int kTI = 2;  // rows of bb per tile

// t[ii, m, cc] = sum_j kxr[ii, j] u[j, m, cc]; bb[ii, l, cc] = sum_m ky[l, m] t[ii, m, cc]
// for the kTI rows of a tile (rows >= `rows` come out zero). kxr, ky, t, bb in
// shared memory; u is the sample's [h, w, c] in device memory.
__device__ void tile_bb(const float* __restrict__ u, const float* __restrict__ kxr,
                        const float* __restrict__ ky, float* __restrict__ t,
                        float* __restrict__ bb, int rows, int h, int w, int c) {
  const int wc = w * c;
  for (int e = threadIdx.x; e < wc; e += blockDim.x) {
    float acc[kTI];
#pragma unroll
    for (int ii = 0; ii < kTI; ++ii) acc[ii] = 0.f;
    for (int j = 0; j < h; ++j) {
      const float uv = u[static_cast<size_t>(j) * wc + e];
#pragma unroll
      for (int ii = 0; ii < kTI; ++ii) acc[ii] = fmaf(kxr[ii * h + j], uv, acc[ii]);
    }
#pragma unroll
    for (int ii = 0; ii < kTI; ++ii) t[ii * wc + e] = acc[ii];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTI * wc; e += blockDim.x) {
    const int ii = e / wc, r = e % wc, l = r / c, cc = r % c;
    const float* tp = t + ii * wc + cc;
    const float* kp = ky + l * w;
    float acc = 0.f;
    for (int m = 0; m < w; ++m) acc = fmaf(kp[m], tp[m * c], acc);
    bb[e] = ii < rows ? acc : 0.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fab_stats_f32(const float* __restrict__ u, const float* __restrict__ kx,
              const float* __restrict__ ky, const float* __restrict__ w_in,
              const float* __restrict__ w1, float* __restrict__ m_out,
              float* __restrict__ bias_out, int n, int h, int w, int c, int d, int o, float eps) {
  extern __shared__ float4 smem4[];
  float* kx_s = reinterpret_cast<float*>(smem4);  // [h, h]
  float* ky_s = kx_s + h * h;                     // [w, w]
  float* win_s = ky_s + w * w;                    // [c, d]
  float* g_s = win_s + c * d;                     // [c, c]
  float* t_s = g_s + c * c;                       // [kTI, w, c]
  float* bb_s = t_s + kTI * w * c;                // [kTI, w, c]
  float* kxr_s = bb_s + kTI * w * c;              // [kTI, h]
  float* sx = kxr_s + kTI * h;                    // [h]
  float* sy = sx + h;                             // [w]
  float* meanc = sy + w;                          // [c]
  float* mean_d = meanc + c;                      // [d]
  float* inv_d = mean_d + d;                      // [d]

  const int hd = blockIdx.x, s = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const size_t sn = static_cast<size_t>(s) * n + hd;
  const float* us = u + static_cast<size_t>(s) * h * w * c;
  for (int i = tid; i < h * h; i += nt) kx_s[i] = kx[sn * h * h + i];
  for (int i = tid; i < w * w; i += nt) ky_s[i] = ky[sn * w * w + i];
  for (int i = tid; i < c * d; i += nt)
    win_s[i] = w_in[(static_cast<size_t>(i / d) * n + hd) * d + i % d];
  for (int i = tid; i < c * c; i += nt) g_s[i] = 0.f;
  __syncthreads();
  for (int j = tid; j < h; j += nt) {
    float a = 0.f;
    for (int i = 0; i < h; ++i) a += kx_s[i * h + j];
    sx[j] = a;
  }
  for (int m = tid; m < w; m += nt) {
    float a = 0.f;
    for (int l = 0; l < w; ++l) a += ky_s[l * w + m];
    sy[m] = a;
  }
  __syncthreads();
  const float inv_n = 1.f / static_cast<float>(h * w);
  for (int cc = tid; cc < c; cc += nt) {
    float a = 0.f;
    for (int j = 0; j < h; ++j) {
      float r = 0.f;
      for (int m = 0; m < w; ++m) r = fmaf(sy[m], us[(j * w + m) * c + cc], r);
      a = fmaf(sx[j], r, a);
    }
    meanc[cc] = a * inv_n;
  }
  for (int i0 = 0; i0 < h; i0 += kTI) {
    const int rows = min(kTI, h - i0);
    for (int i = tid; i < kTI * h; i += nt) {
      const int ii = i / h;
      kxr_s[i] = ii < rows ? kx_s[(i0 + ii) * h + i % h] : 0.f;
    }
    __syncthreads();
    tile_bb(us, kxr_s, ky_s, t_s, bb_s, rows, h, w, c);
    const int np = kTI * w;
    for (int e = tid; e < c * c; e += nt) {
      const int ci = e / c, cj = e % c;
      float acc = g_s[e];
      for (int p = 0; p < np; ++p) acc = fmaf(bb_s[p * c + ci], bb_s[p * c + cj], acc);
      g_s[e] = acc;
    }
    __syncthreads();
  }
  for (int dd = tid; dd < d; dd += nt) {
    float mean = 0.f, ex2 = 0.f;
    for (int ci = 0; ci < c; ++ci) {
      mean = fmaf(meanc[ci], win_s[ci * d + dd], mean);
      float gw = 0.f;
      for (int cj = 0; cj < c; ++cj) gw = fmaf(g_s[ci * c + cj], win_s[cj * d + dd], gw);
      ex2 = fmaf(win_s[ci * d + dd], gw, ex2);
    }
    const float var = fmaxf(ex2 * inv_n - mean * mean, 0.f);
    mean_d[dd] = mean;
    inv_d[dd] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float* w1h = w1 + static_cast<size_t>(hd) * d * o;
  float* mo = m_out + sn * c * o;
  for (int e = tid; e < c * o; e += nt) {
    const int ci = e / o, oo = e % o;
    float acc = 0.f;
    for (int dd = 0; dd < d; ++dd) acc = fmaf(win_s[ci * d + dd] * inv_d[dd], w1h[dd * o + oo], acc);
    mo[e] = acc;
  }
  for (int oo = tid; oo < o; oo += nt) {
    float acc = 0.f;
    for (int dd = 0; dd < d; ++dd) acc = fmaf(mean_d[dd] * inv_d[dd], w1h[dd * o + oo], acc);
    bias_out[sn * o + oo] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
fab_apply_f32(const float* __restrict__ u, const float* __restrict__ kx,
              const float* __restrict__ ky, const float* __restrict__ m_in,
              const float* __restrict__ bias_in, float* __restrict__ out, int n, int h, int w,
              int c, int o) {
  extern __shared__ float4 smem4[];
  float* ky_s = reinterpret_cast<float*>(smem4);  // [w, w]
  float* m_s = ky_s + w * w;                      // [c, o]
  float* t_s = m_s + c * o;                       // [kTI, w, c]
  float* bb_s = t_s + kTI * w * c;                // [kTI, w, c]
  float* acc_s = bb_s + kTI * w * c;              // [kTI, w, o]
  float* kxr_s = acc_s + kTI * w * o;             // [kTI, h]
  float* bsum = kxr_s + kTI * h;                  // [o]

  const int i0 = blockIdx.x * kTI, s = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int rows = min(kTI, h - i0);
  const float* us = u + static_cast<size_t>(s) * h * w * c;
  const int nacc = kTI * w * o;
  for (int i = tid; i < nacc; i += nt) acc_s[i] = 0.f;
  for (int i = tid; i < o; i += nt) bsum[i] = 0.f;
  for (int hd = 0; hd < n; ++hd) {
    const size_t sn = static_cast<size_t>(s) * n + hd;
    for (int i = tid; i < w * w; i += nt) ky_s[i] = ky[sn * w * w + i];
    for (int i = tid; i < kTI * h; i += nt) {
      const int ii = i / h;
      kxr_s[i] = ii < rows ? kx[(sn * h + i0 + ii) * h + i % h] : 0.f;
    }
    for (int i = tid; i < c * o; i += nt) m_s[i] = m_in[sn * c * o + i];
    for (int i = tid; i < o; i += nt) bsum[i] += bias_in[sn * o + i];
    __syncthreads();
    tile_bb(us, kxr_s, ky_s, t_s, bb_s, rows, h, w, c);
    for (int e = tid; e < nacc; e += nt) {
      const int q = e / o, oo = e % o;
      const float* bp = bb_s + q * c;
      float acc = acc_s[e];
      for (int cc = 0; cc < c; ++cc) acc = fmaf(bp[cc], m_s[cc * o + oo], acc);
      acc_s[e] = acc;
    }
    __syncthreads();
  }
  float* os = out + (static_cast<size_t>(s) * h + i0) * w * o;
  for (int e = tid; e < rows * w * o; e += nt) os[e] = acc_s[e] - bsum[e % o];
}

int launch_f32(const float* u, const float* kx, const float* ky, const float* w_in,
               const float* w1, float* m, float* bias, float* out, int b, int n, int h, int w,
               int c, int d, int o, float eps, cudaStream_t stream) {
  const size_t stats_smem =
      sizeof(float) * (static_cast<size_t>(h) * h + w * w + c * d + c * c + 2 * kTI * w * c +
                       kTI * h + h + w + c + 2 * d);
  const size_t apply_smem =
      sizeof(float) * (static_cast<size_t>(w) * w + c * o + 2 * kTI * w * c + kTI * w * o +
                       kTI * h + o);
  cudaError_t e = lns::allow_smem(fab_stats_f32, stats_smem);
  if (e != cudaSuccess) return e;
  e = lns::allow_smem(fab_apply_f32, apply_smem);
  if (e != cudaSuccess) return e;
  fab_stats_f32<<<dim3(n, b), kThreads, stats_smem, stream>>>(u, kx, ky, w_in, w1, m, bias, n, h,
                                                              w, c, d, o, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fab_apply_f32<<<dim3((h + kTI - 1) / kTI, b), kThreads, apply_smem, stream>>>(
      u, kx, ky, m, bias, out, n, h, w, c, o);
  return cudaGetLastError();
}

// ---- bf16: Hopper kernels (TMA, mbarriers, clusters, wgmma) ----------------

constexpr int kStatsWGs = 2;                         // statistics: consumer warpgroups
constexpr int kConsumers = 128 * kStatsWGs;
constexpr int kThreadsTc = kConsumers + 128;         // and a producer warpgroup
constexpr int kOutConsumers = 256;                   // output: two consumer warpgroups
constexpr int kThreadsOut = kOutConsumers + 32;      // and a producer warp
constexpr int kMaxSide = 128;                   // h, w
constexpr int kMaxC = 128;                      // c
constexpr int kMaxCluster = 8;                  // the portable cluster size
constexpr int kOutRows = 128;                   // output pass: pixels per block
constexpr int kOutCols = 64;                    // output pass: o columns per block
constexpr int kOutStages = 4;                   // output pass: ring stages (heads)
constexpr int kBarBytes = 128, kAlign = 1024;

// The launch plan. The kernels' field is hk x wk with hk >= wk: for w > h
// it is the transposed field (k_x applied first), read and written through
// the tensor maps' boxes, never copied. The statistics pass's shared memory,
// byte offsets from the first 1024-byte boundary in it (`base`):
//   a     [c atoms][L][hp][64]      a, then bb in place, of one tile
//   kx    [k atoms][hp][64]         k_x, rows i, K = j
//   ky    [2][k atoms][L][64]       k_y tiles (double buffered)
//   ring  [S][c atoms][R][wp][64]   u rows, multicast to the cluster
// and at off_bar from the start of the dynamic shared memory the barriers
// full[S], empty[S], kyfull[2], kyempty[2], kx. G [c, c] (f32) is staged
// over a once the last tile is read.
struct Plan {
  int hk, wk, transposed;
  int hp, wp, cp, ca;        // hk, wk padded to 16; c padded to 64 and its 64-channel atoms
  int kxa, kya;              // 64-wide K atoms of k_x and k_y
  int L, tiles, R, S, nq;    // tile columns, tiles, u rows per stage, stages, stages per tile
  int cs;                    // cluster size (heads sharing one u stream)
  int off_kx, off_ky, off_ring, off_bar, stats_bytes, moments_bytes, out_bytes;
};

__host__ __device__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ int round4(int v) { return (v + 3) / 4 * 4; }

int moments_bytes(int c, int d, int o) {
  const int dp = round4(d);
  return 4 * (c * c + c * dp + dp * o + c + 2 * dp + c / 4 * dp);
}

Plan make_plan(int h, int w, int c, int d, int o, int n, int L, int R, int S) {
  Plan p;
  p.transposed = w > h;
  p.hk = std::max(h, w);
  p.wk = std::min(h, w);
  p.hp = round_up(p.hk, 16);
  p.wp = round_up(p.wk, 16);
  p.cp = round_up(c, 64);
  p.ca = p.cp / 64;
  p.kxa = (p.hp + 63) / 64;
  p.kya = (p.wp + 63) / 64;
  p.L = L;
  p.tiles = (p.wk + L - 1) / L;
  p.R = R;
  p.S = S;
  p.nq = (p.hp + R - 1) / R;
  p.cs = 1;
  for (int k = kMaxCluster; k > 1; --k)
    if (n % k == 0) {
      p.cs = k;
      break;
    }
  const int a = p.ca * L * p.hp * 128;
  p.off_kx = a;
  p.off_ky = p.off_kx + p.kxa * p.hp * 128;
  p.off_ring = p.off_ky + 2 * p.kya * L * 128;
  const int end = p.off_ring + S * p.ca * R * p.wp * 128;
  p.off_bar = round_up(std::max(kAlign + end, 4 * c * c), 16);  // G is staged over a
  p.stats_bytes = p.off_bar + kBarBytes;
  p.moments_bytes = moments_bytes(c, d, o);
  p.out_bytes = kAlign + kOutStages * (p.ca * kOutRows * 128 + p.cp * 128) +
                kOutRows * 128 + 4 * kOutCols + kBarBytes;
  return p;
}

int plan_smem(const Plan& p) { return std::max({p.stats_bytes, p.moments_bytes, p.out_bytes}); }

// The widest tile (L columns: 32, 16, 8; no wider than wk needs) with the
// deepest u ring that fits; else the narrowest plan (which does not fit).
Plan plan_for(int h, int w, int c, int d, int o, int n) {
  const int limit = static_cast<int>(lns::kMaxDynamicSmem);
  const int wk = std::min(h, w);
  const int rings[][2] = {{4, 4}, {4, 3}, {2, 4}, {2, 3}, {2, 2}, {1, 3}, {1, 2}};
  for (int L : {32, 16, 8}) {
    if (L > 8 && L / 2 >= wk) continue;
    for (const auto& rs : rings) {
      const Plan p = make_plan(h, w, c, d, o, n, L, rs[0], rs[1]);
      if (plan_smem(p) <= limit) return p;
    }
  }
  return make_plan(h, w, c, d, o, n, 8, 1, 2);
}

// The bf16 kernels' limits, stated once: nullptr when they take the shape,
// else the limit it breaks (for launch_bf16 and the wrapper's message).
const char* bf16_limit(int h, int w, int c, int d, int o) {
  static thread_local char msg[160];
  const int limit = static_cast<int>(lns::kMaxDynamicSmem);
  if (c < 16 || c > kMaxC || c % 16) {
    snprintf(msg, sizeof msg, "c a multiple of 16 in [16, %d], got %d", kMaxC, c);
  } else if (o < 16 || o % 16) {
    snprintf(msg, sizeof msg, "o a multiple of 16, got %d", o);
  } else if (h < 1 || h > kMaxSide || w < 1 || w > kMaxSide) {
    snprintf(msg, sizeof msg, "h, w in [1, %d], got %dx%d", kMaxSide, h, w);
  } else if (d < 1) {
    snprintf(msg, sizeof msg, "d >= 1, got %d", d);
  } else {
    const int need = plan_smem(plan_for(h, w, c, d, o, 1));
    if (need <= limit) return nullptr;
    snprintf(msg, sizeof msg, "shared memory per block within %d bytes, needs %d", limit, need);
  }
  return msg;
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + kAlign - 1) &
                                    ~static_cast<uintptr_t>(kAlign - 1));
}

// The block's mean_c [b, n, c] (f32) as the jitted JAX FAB block feeds it
// to _batched_gram_core: sum_px sx[n, j] sy[n, m] (bf16(x[px] sc) + sh) / N,
// from the GroupNorm(1) output before its last rounding and the f32 row sums
// of the unrounded kernels. Without coef (mean_c from u alone, x = u) the
// value is u itself, and without sx, sy the sums are those of the bf16
// kernels (kx, ky: [b, n, h, kxp] and [b, n, w, kyp], rows padded), summed
// here in order. One block per (sample, kHC heads) reads the sample's x
// once for all its heads: 8 channels and a run of pixels per thread,
// partial sums added through shared memory in a fixed order. In the
// field's own orientation: a channel mean does not depend on it.
constexpr int kMeanThreads = 256, kHC = 8;

__global__ void __launch_bounds__(kMeanThreads)
fab_block_mean_bf16(const bf16* __restrict__ x, const float* __restrict__ coef,
                    const float* __restrict__ sxg, const float* __restrict__ syg,
                    const bf16* __restrict__ kx, const bf16* __restrict__ ky, int kxp, int kyp,
                    float* __restrict__ mean_b, int n, int h, int w, int c) {
  extern __shared__ float4 smem_mean[];
  float* sx = reinterpret_cast<float*>(smem_mean);  // [n, h]
  float* sy = sx + n * h;                            // [n, w]
  float* part = sy + n * w;                          // [groups, kHC, c]
  const int tid = threadIdx.x, s = blockIdx.x, n0 = blockIdx.y * kHC;
  const int c8n = c / 8, groups = kMeanThreads / c8n, c8 = tid % c8n * 8, grp = tid / c8n;
  const size_t sn0 = static_cast<size_t>(s) * n;
  for (int e = tid; e < n * h; e += kMeanThreads) {
    if (sxg) {
      sx[e] = sxg[sn0 * h + e];
    } else {  // sum_i k_x[i, j]
      const bf16* col = kx + (sn0 + e / h) * h * kxp + e % h;
      float a = 0.f;
      for (int i = 0; i < h; ++i) a += ld(col[static_cast<size_t>(i) * kxp]);
      sx[e] = a;
    }
  }
  for (int e = tid; e < n * w; e += kMeanThreads) {
    if (syg) {
      sy[e] = syg[sn0 * w + e];
    } else {
      const bf16* col = ky + (sn0 + e / w) * w * kyp + e % w;
      float a = 0.f;
      for (int i = 0; i < w; ++i) a += ld(col[static_cast<size_t>(i) * kyp]);
      sy[e] = a;
    }
  }
  float sc[8], sh[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    sc[q] = coef && grp < groups ? coef[2 * static_cast<size_t>(s) * c + c8 + q] : 1.f;
    sh[q] = coef && grp < groups ? coef[(2 * static_cast<size_t>(s) + 1) * c + c8 + q] : 0.f;
  }
  __syncthreads();
  const bf16* xs = x + static_cast<size_t>(s) * h * w * c;
  const float inv_n = 1.f / static_cast<float>(h * w);
  const int hc = min(kHC, n - n0);
  float acc[kHC][8] = {};
  if (grp < groups)
#pragma unroll 2
    for (int px = grp; px < h * w; px += groups) {
      const int j = px / w, m = px % w;
      const uint4 xv =
          __ldg(reinterpret_cast<const uint4*>(xs + static_cast<size_t>(px) * c + c8));
      const bf16* xb = reinterpret_cast<const bf16*>(&xv);
      float uf[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)  // bf16(x sc) + sh in f32: the GN output before its rounding
        uf[q] = __fadd_rn(lns::rnd<bf16>(__fmul_rn(ld(xb[q]), sc[q])), sh[q]);
#pragma unroll
      for (int k = 0; k < kHC; ++k) {
        if (k >= hc) break;
        const float wgt = sx[(n0 + k) * h + j] * sy[(n0 + k) * w + m];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[k][q] = fmaf(wgt, uf[q], acc[k][q]);
      }
    }
  if (grp < groups)
#pragma unroll
    for (int k = 0; k < kHC; ++k)
#pragma unroll
      for (int q = 0; q < 8; ++q) part[(grp * kHC + k) * c + c8 + q] = acc[k][q];
  __syncthreads();
  for (int e = tid; e < hc * c; e += kMeanThreads) {
    const int k = e / c, cc = e % c;
    float a = 0.f;
    for (int g = 0; g < groups; ++g) a += part[(g * kHC + k) * c + cc];
    mean_b[(sn0 + n0 + k) * c + cc] = a * inv_n;
  }
}

int block_mean_smem(int n, int h, int w, int c) {
  return 4 * (n * (h + w) + kMeanThreads / (c / 8) * kHC * c);
}

// Step A of NR consecutive u rows j0.. of a ring stage (a warpgroup; their
// rows row_bytes apart from u0): a_j^T [c x L] = u_j^T [c x wk] . k_y tile^T
// [wk x L] per 64-channel atom, every row's products issued before one
// wait, rounded to bf16 into a [ca][l][j].
template <int L, int NR>
__device__ __forceinline__ void step_a(const uint8_t* u0, int row_bytes, const uint8_t* kyt,
                                       uint8_t* a_s, const Plan& p, int j0, int ca, int wt) {
  constexpr int kR = L / 2;
  float acc[NR][kR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[r][i] = 0.f;
    lns::wgmma_fence_regs(acc[r]);
  }
  for (int ks = 0; ks < p.wp / 16; ++ks) {
    const uint64_t db = lns::desc_kmajor(kyt + (ks / 4) * L * 128 + (ks % 4) * 32);
    lns::wgmma_fence();
#pragma unroll
    for (int r = 0; r < NR; ++r)
      lns::wgmma<L, 1, 0>(acc[r], lns::desc_mnmajor(u0 + r * row_bytes + ks * 2048), db);
    lns::wgmma_commit();
  }
  lns::wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < NR; ++r) lns::wgmma_fence_regs(acc[r]);
  const int q = wt / 32, lane = wt % 32, cr = 16 * q + lane / 4, l2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int l = 8 * (i / 4) + l2 + i % 2, cc = cr + 8 * ((i % 4) / 2);
    uint8_t* col = a_s + (ca * L + l) * p.hp * 128;
#pragma unroll
    for (int r = 0; r < NR; ++r)
      *reinterpret_cast<bf16*>(col + lns::sw128(j0 + r, cc)) = __float2bfloat16(acc[r][i]);
  }
}

// Step A of `rows` consecutive rows of a stage, in batches of as many rows
// as keep the accumulators to 32 registers a thread (at most 4)
template <int L>
__device__ __forceinline__ void step_a_rows(const uint8_t* u0, int row_bytes, const uint8_t* kyt,
                                            uint8_t* a_s, const Plan& p, int j0, int rows, int ca,
                                            int wt) {
  constexpr int kBatch = 64 / L < 4 ? 64 / L : 4;
  int r = 0;
  for (; r + kBatch <= rows; r += kBatch)
    step_a<L, kBatch>(u0 + r * row_bytes, row_bytes, kyt, a_s, p, j0 + r, ca, wt);
  for (; r < rows; ++r) step_a<L, 1>(u0 + r * row_bytes, row_bytes, kyt, a_s, p, j0 + r, ca, wt);
}

// bb^T rows i0.. of a column: acc (m64 x 16 NB) rounded to bf16 at [i][c]
template <int NB>
__device__ __forceinline__ void store_bb(uint8_t* blk, const float (&acc)[8 * NB], int i0,
                                         int wt) {
  const int q = wt / 32, lane = wt % 32, cr = 16 * q + lane / 4, i2 = i0 + 2 * (lane % 4);
#pragma unroll
  for (int k = 0; k < 8 * NB; ++k) {
    const int i = 8 * (k / 4) + i2 + k % 2, cc = cr + 8 * ((k % 4) / 2);
    *reinterpret_cast<bf16*>(blk + lns::sw128(i, cc)) = __float2bfloat16(acc[k]);
  }
}

// Step B of column l (a warpgroup): bb^T [c x hk] = a_l^T [c x hk] .
// k_x^T per channel atom, rounded to bf16 in place of a_l, as [i][c]; the
// rows i in chunks of at most 64 (NB0 16-row steps, then NB1 more).
template <int NB0, int NB1>
__device__ __forceinline__ void step_b(uint8_t* blk, const uint8_t* kx_s, const Plan& p, int wg,
                                       int wt) {
  float acc0[8 * NB0], acc1[8 * (NB1 > 0 ? NB1 : 1)];
#pragma unroll
  for (int i = 0; i < 8 * NB0; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8 * (NB1 > 0 ? NB1 : 1); ++i) acc1[i] = 0.f;
  lns::wgmma_fence_regs(acc0);
  lns::wgmma_fence_regs(acc1);
#pragma unroll
  for (int ks = 0; ks < NB0 + NB1; ++ks) {  // K = hp = 16 (NB0 + NB1)
    const uint64_t da = lns::desc_mnmajor(blk + ks * 2048);
    const uint8_t* kb = kx_s + (ks / 4) * p.hp * 128 + (ks % 4) * 32;
    lns::wgmma_fence();
    lns::wgmma<16 * NB0, 1, 0>(acc0, da, lns::desc_kmajor(kb));
    if constexpr (NB1 > 0) lns::wgmma<16 * NB1, 1, 0>(acc1, da, lns::desc_kmajor(kb + 64 * 128));
    lns::wgmma_commit();
  }
  lns::wgmma_wait<0>();
  lns::wgmma_fence_regs(acc0);
  lns::wgmma_fence_regs(acc1);
  lns::bar_sync(2 + wg, 128);  // every warp's part of a_l is read before any is overwritten
  store_bb<NB0>(blk, acc0, 0, wt);
  if constexpr (NB1 > 0) store_bb<NB1>(blk, acc1, 64, wt);
}

// Pass 2, one block per (head, sample), a cluster of cs heads of one sample:
// for each tile of L columns, a = bf16(u . k_y^T) row by row as u's rows
// stream in (multicast: each ring stage is read from device memory once per
// cluster), bb = bf16(k_x . a) column by column, bb written to the scratch
// once (TMA store) and its Gram summed into G [b, n, c, c] (f32) for pass 3.
// CA: 64-channel atoms of c.
template <int CA>
__global__ void __launch_bounds__(kThreadsTc, 1)
fab_bb_stats_bf16(const __grid_constant__ CUtensorMap map_u,
                  const __grid_constant__ CUtensorMap map_kx,
                  const __grid_constant__ CUtensorMap map_ky,
                  const __grid_constant__ CUtensorMap map_bb, float* __restrict__ g_out, int n,
                  int c, Plan p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_smem(smem_raw);
  uint8_t* a_s = base;
  uint8_t* kx_s = base + p.off_kx;
  uint8_t* ky_s = base + p.off_ky;
  uint8_t* ring = base + p.off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + p.off_bar);
  uint64_t* empty = full + p.S;
  uint64_t* kyfull = empty + p.S;
  uint64_t* kyempty = kyfull + 2;
  uint64_t* kxbar = kyempty + 2;
  const int tid = threadIdx.x, hd = blockIdx.x, s = blockIdx.y;
  const int sn = s * n + hd;
  const uint32_t rank = p.cs > 1 ? lns::cluster_rank() : 0;
  const int row_bytes = p.wp * 128, stage_bytes = CA * p.R * row_bytes;
  const int ky_buf = p.kya * p.L * 128;

  if (tid == 0) {
    for (int i = 0; i < p.S; ++i) {
      lns::mbar_init(&full[i], 1);
      lns::mbar_init(&empty[i], p.cs);  // the stage's consumer warpgroup in every block
    }
    for (int i = 0; i < 2; ++i) {
      lns::mbar_init(&kyfull[i], 1);
      lns::mbar_init(&kyempty[i], kStatsWGs);
    }
    lns::mbar_init(kxbar, 1);
    lns::mbar_fence_init();
  }
  __syncthreads();
  if (p.cs > 1) lns::cluster_sync();  // every block's barriers exist before a multicast lands

  // the warpgroup's role, provably uniform across each warp (so that the
  // register hand-over below applies)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == kStatsWGs) {
    // producer: k_x once, k_y tile by tile, u rows through the ring; one
    // thread issues, its warpgroup gives its registers to the consumers
    lns::setmaxnreg_dec<40>();
    if (tid == kConsumers) {
      lns::mbar_expect_tx(kxbar, p.kxa * p.hp * 128);
      for (int ka = 0; ka < p.kxa; ++ka)
        lns::tma_load(kx_s + ka * p.hp * 128, &map_kx, kxbar, 64 * ka, 0, sn, 0);
      int f = 0;
      for (int t = 0; t < p.tiles; ++t) {
        const int kb = t & 1;
        if (t >= 2) lns::mbar_wait(&kyempty[kb], ((t >> 1) - 1) & 1);
        lns::mbar_expect_tx(&kyfull[kb], ky_buf);
        for (int ka = 0; ka < p.kya; ++ka)
          lns::tma_load(ky_s + kb * ky_buf + ka * p.L * 128, &map_ky, &kyfull[kb], 64 * ka,
                        t * p.L, sn, 0);
        for (int q = 0; q < p.nq; ++q, ++f) {
          const int st = f % p.S;
          if (f >= p.S) lns::mbar_wait(&empty[st], ((f / p.S) - 1) & 1);
          lns::mbar_expect_tx(&full[st], stage_bytes);
          if (f % p.cs != static_cast<int>(rank)) continue;  // another block fills this stage
          for (int r = 0; r < p.R; ++r)
            for (int ca = 0; ca < CA; ++ca) {
              uint8_t* dst = ring + st * stage_bytes + (ca * p.R + r) * row_bytes;
              const int j = q * p.R + r;
              const int c1 = p.transposed ? j : 0, c2 = p.transposed ? 0 : j;
              if (p.cs > 1)
                lns::tma_load_multicast(dst, &map_u, &full[st], 64 * ca, c1, c2, s,
                                        static_cast<uint16_t>((1 << p.cs) - 1));
              else
                lns::tma_load(dst, &map_u, &full[st], 64 * ca, c1, c2, s);
            }
        }
      }
    }
    if (p.cs > 1) lns::cluster_sync();  // no block leaves while its cluster may reach it
  } else {
    lns::setmaxnreg_inc<232>();
    const int wg = role, wt = tid % 128;
    float gacc[CA][CA][32];
#pragma unroll
    for (int x = 0; x < CA; ++x)
#pragma unroll
      for (int y = 0; y < CA; ++y)
#pragma unroll
        for (int i = 0; i < 32; ++i) gacc[x][y][i] = 0.f;
#pragma unroll
    for (int x = 0; x < CA; ++x)
#pragma unroll
      for (int y = 0; y < CA; ++y) lns::wgmma_fence_regs(gacc[x][y]);
    lns::mbar_wait(kxbar, 0);
    int f = 0;
    for (int t = 0; t < p.tiles; ++t) {
      const int kb = t & 1, l0 = t * p.L;
      const uint8_t* kyt = ky_s + kb * ky_buf;
      lns::mbar_wait(&kyfull[kb], (t >> 1) & 1);
      // step A: the ring's stages taken by the warpgroups in turn, each
      // stage's rows by one warpgroup
      for (int q = 0; q < p.nq; ++q, ++f) {
        if (f % kStatsWGs != wg) continue;
        const int st = f % p.S, j0 = q * p.R, rows = min(p.R, p.hp - j0);
        lns::mbar_wait(&full[st], (f / p.S) & 1);
        for (int ca = 0; ca < CA; ++ca) {
          const uint8_t* u0 = ring + st * stage_bytes + ca * p.R * row_bytes;
          if (p.L == 32) step_a_rows<32>(u0, row_bytes, kyt, a_s, p, j0, rows, ca, wt);
          else if (p.L == 16) step_a_rows<16>(u0, row_bytes, kyt, a_s, p, j0, rows, ca, wt);
          else step_a_rows<8>(u0, row_bytes, kyt, a_s, p, j0, rows, ca, wt);
        }
        lns::bar_sync(2 + wg, 128);  // the warpgroup's reads of the stage are done
        if (p.cs > 1) {  // lane r releases the stage in cluster block r
          if (wt < p.cs) lns::mbar_arrive_cluster(&empty[st], wt);
        } else if (wt == 0) {
          lns::mbar_arrive(&empty[st]);
        }
      }
      if (wt == 0) lns::mbar_arrive(&kyempty[kb]);
      lns::fence_async_shared();  // a's stores, visible to wgmma
      lns::bar_sync(1, kConsumers);
      // step B: columns l of the tile split between the warpgroups
      for (int l = wg; l < p.L; l += kStatsWGs)
        for (int ca = 0; ca < CA; ++ca) {
          uint8_t* blk = a_s + (ca * p.L + l) * p.hp * 128;
          switch (p.hp / 16) {
            case 1: step_b<1, 0>(blk, kx_s, p, wg, wt); break;
            case 2: step_b<2, 0>(blk, kx_s, p, wg, wt); break;
            case 3: step_b<3, 0>(blk, kx_s, p, wg, wt); break;
            case 4: step_b<4, 0>(blk, kx_s, p, wg, wt); break;
            case 5: step_b<4, 1>(blk, kx_s, p, wg, wt); break;
            case 6: step_b<4, 2>(blk, kx_s, p, wg, wt); break;
            case 7: step_b<4, 3>(blk, kx_s, p, wg, wt); break;
            default: step_b<4, 4>(blk, kx_s, p, wg, wt); break;
          }
        }
      lns::fence_async_shared();  // bb's stores, visible to wgmma and the TMA store
      lns::bar_sync(1, kConsumers);
      if (tid == 0) {  // bb of the tile to the scratch, once; columns past wk are not stored
        for (int l = 0; l < p.L && l0 + l < p.wk; ++l)
          for (int ca = 0; ca < CA; ++ca) {
            const uint8_t* blk = a_s + (ca * p.L + l) * p.hp * 128;
            if (p.transposed)
              lns::tma_store(&map_bb, blk, 64 * ca, 0, l0 + l, sn);
            else
              lns::tma_store(&map_bb, blk, 64 * ca, l0 + l, 0, sn);
          }
        lns::tma_store_commit();
      }
      // the Gram G += bb^T bb over the tile's pixels, alternate k16 steps per
      // warpgroup (the two partial sums are added once, in order, at the end)
#pragma unroll
      for (int x = 0; x < CA; ++x)
#pragma unroll
        for (int y = 0; y < CA; ++y) lns::wgmma_fence_regs(gacc[x][y]);
      for (int ks = wg; ks < p.L * p.hp / 16; ks += kStatsWGs) {
        lns::wgmma_fence();
#pragma unroll
        for (int x = 0; x < CA; ++x)
#pragma unroll
          for (int y = 0; y < CA; ++y)
            lns::wgmma<64, 1, 1>(gacc[x][y],
                                 lns::desc_mnmajor(a_s + x * p.L * p.hp * 128 + ks * 2048),
                                 lns::desc_mnmajor(a_s + y * p.L * p.hp * 128 + ks * 2048));
        lns::wgmma_commit();
      }
      lns::wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < CA; ++x)
#pragma unroll
        for (int y = 0; y < CA; ++y) lns::wgmma_fence_regs(gacc[x][y]);
      if (tid == 0) lns::tma_store_wait_read();
      lns::bar_sync(1, kConsumers);  // the tile's bb is read before the next tile's a
    }

    // G: the warpgroups' sums added in order in shared memory (over a),
    // then to the scratch [b, n, c, c] for the moments pass
    float* g_s = reinterpret_cast<float*>(smem_raw);
    {
      const int q = wt / 32, lane = wt % 32, r0 = 16 * q + lane / 4, c2 = 2 * (lane % 4);
      for (int pass = 0; pass < kStatsWGs; ++pass) {  // each warpgroup's sums, added in order
        if (wg == pass)
#pragma unroll
          for (int x = 0; x < CA; ++x)
#pragma unroll
            for (int y = 0; y < CA; ++y)
#pragma unroll
              for (int i = 0; i < 32; ++i) {
                const int r = 64 * x + r0 + 8 * ((i % 4) / 2);
                const int cc = 64 * y + 8 * (i / 4) + c2 + i % 2;
                float* gp = g_s + r * c + cc;
                if (r < c && cc < c) *gp = pass ? *gp + gacc[x][y][i] : gacc[x][y][i];
              }
        lns::bar_sync(1, kConsumers);
      }
    }
    float4* go = reinterpret_cast<float4*>(g_out + static_cast<size_t>(sn) * c * c);
    for (int e = tid; e < c * c / 4; e += kConsumers)
      go[e] = reinterpret_cast<const float4*>(g_s)[e];
    if (p.cs > 1) lns::cluster_sync();
  }
}

// Pass 3, one block per (head, sample): from G, the head's mean_c, W_in and
// W_o1, the statistics E[phi^2] = W_in^T (G / N) W_in and mean = mean_c
// W_in, inv = rsqrt(max(E[phi^2] - mean^2, 0) + eps), then m = bf16(W_in
// diag(inv) W_o1) [cp, o] (zero rows past c) and the bias (mean inv) W_o1
// (f32): f32 on CUDA cores in 4 x 4 register blocks, several blocks to an
// SM so that their loads and barriers overlap.
constexpr int kMomentThreads = 256;

__global__ void __launch_bounds__(kMomentThreads)
fab_moments_bf16(const float* __restrict__ g, const bf16* __restrict__ w_in,
                 const float* __restrict__ w1, const float* __restrict__ mean_b,
                 bf16* __restrict__ m_out, float* __restrict__ bias_out, int n, int c, int cp,
                 int d, int o, int hw, float eps) {
  extern __shared__ float4 smem_mom[];
  const int tid = threadIdx.x, hd = blockIdx.x, s = blockIdx.y, sn = s * n + hd;
  const int dp = round4(d);  // d padded with zero columns of W_in, rows of W_o1
  float* g_s = reinterpret_cast<float*>(smem_mom);  // [c, c]
  float* win_s = g_s + c * c;                       // [c, dp]
  float* w1_s = win_s + c * dp;                     // [dp, o]: W_o1, then diag(inv) W_o1
  float* meanc = w1_s + dp * o;                     // [c]
  float* mean_d = meanc + c;                        // [dp]
  float* inv_d = mean_d + dp;                       // [dp]
  float* part = inv_d + dp;                         // [c / 4, dp]: E[phi^2] partial sums
  // this head's W_in, W_o1, mean_c and G
#pragma unroll 8
  for (int e = tid; e < c * dp; e += kMomentThreads) {
    const int dd = e % dp;
    win_s[e] = dd < d ? ld(w_in[(static_cast<size_t>(e / dp) * n + hd) * d + dd]) : 0.f;
  }
  const float* w1h = w1 + static_cast<size_t>(hd) * d * o;
#pragma unroll 4
  for (int e = tid; e < dp * o / 4; e += kMomentThreads)  // o % 16 == 0: a float4 is in one row
    reinterpret_cast<float4*>(w1_s)[e] = 4 * e < d * o
        ? reinterpret_cast<const float4*>(w1h)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cc = tid; cc < c; cc += kMomentThreads)
    meanc[cc] = mean_b[static_cast<size_t>(sn) * c + cc];
  const float4* gi = reinterpret_cast<const float4*>(g + static_cast<size_t>(sn) * c * c);
  for (int e = tid; e < c * c / 4; e += kMomentThreads) reinterpret_cast<float4*>(g_s)[e] = gi[e];
  __syncthreads();
  const float inv_n = 1.f / static_cast<float>(hw);
  // E[phi^2] = W_in^T G W_in / N: 4 x 4 blocks of (G W_in)[ci, dd] per
  // thread, reduced over ci in a fixed order through `part` [c / 4][dp];
  // the threads of the first rows also form mean = mean_c W_in
  const int d4 = dp / 4;
  for (int e = tid; e < c / 4 * d4; e += kMomentThreads) {
    const int ci0 = e / d4 * 4, dd0 = e % d4 * 4;
    float acc[4][4] = {}, macc[4] = {};
#pragma unroll 4
    for (int cj = 0; cj < c; ++cj) {
      const float4 gv = *reinterpret_cast<const float4*>(g_s + cj * c + ci0);  // G symmetric
      const float4 wv = *reinterpret_cast<const float4*>(win_s + cj * dp + dd0);
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w}, wb[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int a2 = 0; a2 < 4; ++a2)
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) acc[a2][b2] = fmaf(ga[a2], wb[b2], acc[a2][b2]);
      if (ci0 == 0) {
        const float mc = meanc[cj];
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) macc[b2] = fmaf(mc, wb[b2], macc[b2]);
      }
    }
#pragma unroll
    for (int b2 = 0; b2 < 4; ++b2) {
      float sum = 0.f;
#pragma unroll
      for (int a2 = 0; a2 < 4; ++a2)
        sum = fmaf(win_s[(ci0 + a2) * dp + dd0 + b2], acc[a2][b2], sum);
      part[ci0 / 4 * dp + dd0 + b2] = sum;
      if (ci0 == 0) mean_d[dd0 + b2] = macc[b2];
    }
  }
  __syncthreads();
  for (int dd = tid; dd < dp; dd += kMomentThreads) {
    float ex2 = 0.f;
    for (int k = 0; k < c / 4; ++k) ex2 += part[k * dp + dd];
    const float mean = mean_d[dd], var = fmaxf(ex2 * inv_n - mean * mean, 0.f);
    inv_d[dd] = dd < d ? rsqrtf(var + eps) : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < dp * o; e += kMomentThreads) w1_s[e] *= inv_d[e / o];  // diag(inv) W_o1
  __syncthreads();
  // m = W_in (diag(inv) W_o1), 4 x 4 blocks per thread, in bf16 (rows c..cp
  // zero); the threads of the first rows also form bias = mean (diag(inv) W_o1)
  bf16* mo = m_out + static_cast<size_t>(sn) * cp * o;
  const int o4 = o / 4;
  for (int e = tid; e < c / 4 * o4; e += kMomentThreads) {
    const int ci0 = e / o4 * 4, oo0 = e % o4 * 4;
    float acc[4][4] = {}, bacc[4] = {};
#pragma unroll 4
    for (int dd = 0; dd < dp; ++dd) {
      const float4 v = *reinterpret_cast<const float4*>(w1_s + dd * o + oo0);
      const float vb[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int a2 = 0; a2 < 4; ++a2) {
        const float wa = win_s[(ci0 + a2) * dp + dd];
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) acc[a2][b2] = fmaf(wa, vb[b2], acc[a2][b2]);
      }
      if (ci0 == 0) {
        const float md = mean_d[dd];
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) bacc[b2] = fmaf(md, vb[b2], bacc[b2]);
      }
    }
#pragma unroll
    for (int a2 = 0; a2 < 4; ++a2)
      *reinterpret_cast<uint2*>(mo + (ci0 + a2) * o + oo0) =
          make_uint2(lns::pack_bf16(acc[a2][0], acc[a2][1]),
                     lns::pack_bf16(acc[a2][2], acc[a2][3]));
    if (ci0 == 0)
      *reinterpret_cast<float4*>(bias_out + static_cast<size_t>(sn) * o + oo0) =
          make_float4(bacc[0], bacc[1], bacc[2], bacc[3]);
  }
  for (int e = tid; e < (cp - c) * o / 2; e += kMomentThreads)
    *reinterpret_cast<uint32_t*>(mo + c * o + 2 * e) = 0u;
}

// Pass 4, one block per (128 pixels, 64 columns of o, sample): out =
// bf16(bf16(sum_n bb_n . m_n) - bf16(sum_n bias_n)), one product with K =
// n cp in f32 (a head per ring stage), the bias summed over the heads in
// order; the tile leaves by a TMA store.
template <int CA>
__global__ void __launch_bounds__(kThreadsOut, 1)
fab_out_bf16(const __grid_constant__ CUtensorMap map_bbl, const __grid_constant__ CUtensorMap map_m,
             const __grid_constant__ CUtensorMap map_out, const float* __restrict__ bias, int n,
             int o) {
  constexpr int kA = CA * kOutRows * 128, kB = CA * 64 * 128, kStage = kA + kB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_smem(smem_raw);
  uint8_t* stage_out = base + kOutStages * kStage;
  float* bsum = reinterpret_cast<float*>(stage_out + kOutRows * 128);
  uint64_t* full = reinterpret_cast<uint64_t*>(bsum + kOutCols);
  uint64_t* empty = full + kOutStages;
  const int tid = threadIdx.x, px0 = blockIdx.x * kOutRows, o0 = blockIdx.y * kOutCols;
  const int s = blockIdx.z;
  if (tid == 0) {
    for (int i = 0; i < kOutStages; ++i) {
      lns::mbar_init(&full[i], 1);
      lns::mbar_init(&empty[i], 2);
    }
    lns::mbar_fence_init();
  }
  __syncthreads();
  if (tid >= kOutConsumers) {
    if (tid == kOutConsumers)
      for (int hd = 0; hd < n; ++hd) {
        const int st = hd % kOutStages;
        if (hd >= kOutStages) lns::mbar_wait(&empty[st], ((hd / kOutStages) - 1) & 1);
        lns::mbar_expect_tx(&full[st], kStage);
        uint8_t* sa = base + st * kStage;
        for (int ca = 0; ca < CA; ++ca)
          lns::tma_load(sa + ca * kOutRows * 128, &map_bbl, &full[st], 64 * ca, px0, s * n + hd, 0);
        lns::tma_load(sa + kA, &map_m, &full[st], o0, 0, s * n + hd, 0);
      }
    return;
  }
  const int wg = tid / 128, wt = tid % 128;
  if (tid < kOutCols) {
    float a = 0.f;
    if (o0 + tid < o)
      for (int hd = 0; hd < n; ++hd) a += bias[(static_cast<size_t>(s) * n + hd) * o + o0 + tid];
    bsum[tid] = a;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  lns::wgmma_fence_regs(acc);
  for (int hd = 0; hd < n; ++hd) {
    const int st = hd % kOutStages;
    const uint8_t* sa = base + st * kStage;
    lns::mbar_wait(&full[st], (hd / kOutStages) & 1);
    lns::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CA * 4; ++ks)
      lns::wgmma<64, 0, 1>(acc,
                           lns::desc_kmajor(sa + (ks / 4) * kOutRows * 128 + wg * 64 * 128 +
                                            (ks % 4) * 32),
                           lns::desc_mnmajor(sa + kA + ks * 2048));
    lns::wgmma_commit();
    lns::wgmma_wait<0>();
    lns::wgmma_fence_regs(acc);
    lns::bar_sync(2 + wg, 128);
    if (wt == 0) lns::mbar_arrive(&empty[st]);
  }
  lns::bar_sync(1, kOutConsumers);  // bsum
  using lns::rnd;
  const int q = wt / 32, lane = wt % 32, r0 = 64 * wg + 16 * q + lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = r0 + 8 * ((i % 4) / 2), cc = 8 * (i / 4) + c2;
    const float b0 = rnd<bf16>(bsum[cc]), b1 = rnd<bf16>(bsum[cc + 1]);
    *reinterpret_cast<uint32_t*>(stage_out + lns::sw128(r, cc)) =
        lns::pack_bf16(rnd<bf16>(acc[i]) - b0, rnd<bf16>(acc[i + 1]) - b1);
  }
  lns::fence_async_shared();
  lns::bar_sync(1, kOutConsumers);
  if (tid == 0) {
    lns::tma_store(&map_out, stage_out, o0, px0, s, 0);
    lns::tma_store_commit();
    lns::tma_store_wait_read();
  }
}

// The block's mean inputs (x null: mean_c from u alone) and its scratch.
struct MeanFrom {
  const bf16* x;
  const float *coef, *sx, *sy;
  float* mean;  // [b, n, c]
};

template <typename K>
cudaError_t cluster_config(K kernel, const Plan& p, int b, int n, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = lns::allow_smem(kernel, p.stats_bytes);
  if (e != cudaSuccess) return e;
  *cfg = {};
  cfg->gridDim = dim3(n, b);
  cfg->blockDim = dim3(kThreadsTc);
  cfg->dynamicSmemBytes = p.stats_bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The tensor maps of both passes (kx, ky: the kernels' k_x, k_y, rows
// padded to a multiple of 8 elements).
struct Maps {
  CUtensorMap u, kx, ky, bb, bbl, m, out;
};

cudaError_t make_maps(Maps* mp, const Plan& p, const bf16* u, const bf16* kx, const bf16* ky,
                      const bf16* m, const bf16* bb, const bf16* out, int b, int n, int h, int w,
                      int c, int o) {
  using u64 = uint64_t;
  const u64 B = b, N = n, H = h, W = w, C = c, CP = p.cp, O = o;
  const u64 hk8 = round_up(p.hk, 8), wk8 = round_up(p.wk, 8), HW = H * W;
  const uint32_t wp = p.wp, hp = p.hp, L = p.L;
  cudaError_t e;
  // u [b, h, w, c]: a row j of the kernels' field is one box
  e = lns::make_map(&mp->u, u, {C, W, H, B}, {C * 2, W * C * 2, HW * C * 2},
                    {64, p.transposed ? 1u : wp, p.transposed ? wp : 1u, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&mp->kx, kx, {hk8, u64(p.hk), B * N, 1},
                      {hk8 * 2, p.hk * hk8 * 2, B * N * p.hk * hk8 * 2}, {64, hp, 1, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&mp->ky, ky, {wk8, u64(p.wk), B * N, 1},
                      {wk8 * 2, p.wk * wk8 * 2, B * N * p.wk * wk8 * 2}, {64, L, 1, 1});
  // bb [b n, h, w, cp] in the field's own orientation: one column l per box
  if (e == cudaSuccess)
    e = lns::make_map(&mp->bb, bb, {CP, W, H, B * N}, {CP * 2, W * CP * 2, HW * CP * 2},
                      {64, p.transposed ? hp : 1u, p.transposed ? 1u : hp, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&mp->bbl, bb, {CP, HW, B * N, 1},
                      {CP * 2, HW * CP * 2, B * N * HW * CP * 2}, {64, kOutRows, 1, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&mp->m, m, {O, CP, B * N, 1}, {O * 2, CP * O * 2, B * N * CP * O * 2},
                      {64, static_cast<uint32_t>(p.cp), 1, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&mp->out, out, {O, HW, B, 1}, {O * 2, HW * O * 2, B * HW * O * 2},
                      {kOutCols, kOutRows, 1, 1});
  return e;
}

template <int CA>
int launch_passes(const Maps& mp, const bf16* w_in, const float* w1, const float* mean,
                  float* g, bf16* m, float* bias, int b, int n, int h, int w, int c, int d, int o,
                  float eps, const Plan& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(fab_bb_stats_bf16<CA>, p, b, n, stream, &cfg, &attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, fab_bb_stats_bf16<CA>, mp.u, mp.kx, mp.ky, mp.bb, g, n, c, p);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) e = lns::allow_smem(fab_moments_bf16, p.moments_bytes);
  if (e != cudaSuccess) return e;
  fab_moments_bf16<<<dim3(n, b), kMomentThreads, p.moments_bytes, stream>>>(
      g, w_in, w1, mean, m, bias, n, c, p.cp, d, o, h * w, eps);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = lns::allow_smem(fab_out_bf16<CA>, p.out_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((h * w + kOutRows - 1) / kOutRows, (o + kOutCols - 1) / kOutCols, b);
  fab_out_bf16<CA><<<grid, kThreadsOut, p.out_bytes, stream>>>(mp.bbl, mp.m, mp.out, bias, n, o);
  return cudaGetLastError();
}

// kx [b, n, h, kxp], ky [b, n, w, kyp] (kxp, kyp: h, w rounded up to 8)
int launch_bf16(const bf16* u, const bf16* kx, const bf16* ky, const bf16* w_in, const float* w1,
                const MeanFrom& mf, float* g, bf16* m, float* bias, bf16* bb, bf16* out, int b,
                int n, int h, int w, int c, int d, int o, float eps, cudaStream_t stream) {
  if (bf16_limit(h, w, c, d, o) || !mf.mean || !bb || !g) return cudaErrorInvalidValue;
  if (!mf.x != !mf.coef || !mf.x != !mf.sx || !mf.x != !mf.sy) return cudaErrorInvalidValue;
  const int kxp = round_up(h, 8), kyp = round_up(w, 8);
  const int bytes = block_mean_smem(n, h, w, c);
  cudaError_t e = lns::allow_smem(fab_block_mean_bf16, bytes);
  if (e != cudaSuccess) return e;
  fab_block_mean_bf16<<<dim3(b, (n + kHC - 1) / kHC), kMeanThreads, bytes, stream>>>(
      mf.x ? mf.x : u, mf.coef, mf.sx, mf.sy, kx, ky, kxp, kyp, mf.mean, n, h, w, c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Plan p = plan_for(h, w, c, d, o, n);
  Maps mp;
  e = p.transposed ? make_maps(&mp, p, u, ky, kx, m, bb, out, b, n, h, w, c, o)
                   : make_maps(&mp, p, u, kx, ky, m, bb, out, b, n, h, w, c, o);
  if (e != cudaSuccess) return e;
  return p.ca == 1 ? launch_passes<1>(mp, w_in, w1, mf.mean, g, m, bias, b, n, h, w, c, d, o, eps,
                                      p, stream)
                   : launch_passes<2>(mp, w_in, w1, mf.mean, g, m, bias, b, n, h, w, c, d, o, eps,
                                      p, stream);
}

// The launch plan of a shape, for chip_smoke.py: cluster size, tile
// columns L, u rows per stage, stages, tiles, the statistics and output
// passes' shared memory per block, the padded c, the clusters of the
// statistics pass the card holds at once, the moments pass's shared memory.
int plan_info(int h, int w, int c, int d, int o, int n, int* out) {
  const Plan p = plan_for(h, w, c, d, o, n);
  out[0] = p.cs;
  out[1] = p.L;
  out[2] = p.R;
  out[3] = p.S;
  out[4] = p.tiles;
  out[5] = p.stats_bytes;
  out[6] = p.out_bytes;
  out[7] = p.cp;
  out[8] = 0;
  out[9] = p.moments_bytes;
  if (bf16_limit(h, w, c, d, o)) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = p.ca == 1 ? cluster_config(fab_bb_stats_bf16<1>, p, 1, n, nullptr, &cfg, &attr)
                            : cluster_config(fab_bb_stats_bf16<2>, p, 1, n, nullptr, &cfg, &attr);
  if (e != cudaSuccess) return e;
  return p.ca == 1 ? cudaOccupancyMaxActiveClusters(&out[8], fab_bb_stats_bf16<1>, &cfg)
                   : cudaOccupancyMaxActiveClusters(&out[8], fab_bb_stats_bf16<2>, &cfg);
}

}  // namespace

// nullptr when the bf16 kernels take this shape, else the limit it breaks
extern "C" const char* lns_fab_core_bf16_limit(int h, int w, int c, int d, int o) {
  return bf16_limit(h, w, c, d, o);
}

// The bf16 launch plan of a shape (plan_info): 10 ints into out.
extern "C" int lns_fab_core_bf16_plan(int h, int w, int c, int d, int o, int n, int* out) {
  return plan_info(h, w, c, d, o, n, out);
}

// x, coef, sx, sy: the block's mean inputs (bf16 only; all null for mean_c
// from u alone); bf16's scratch: mean_ws [b, n, c] f32, g_ws the Gram [b, n,
// c, c] f32 and bb_ws [b, n, h, w, cp] bf16 (all null for f32). kx, ky:
// bf16 [b, n, h, round8(h)] and [b, n, w, round8(w)]; f32 [b, n, h, h] and
// [b, n, w, w]. m: [b, n, cp, o] (bf16) or [b, n, c, o] (f32).
extern "C" int lns_fab_core(int dtype, const void* u, const void* kx, const void* ky,
                            const void* w_in, const void* w_o1, const void* x, const void* coef,
                            const void* sx, const void* sy, void* mean_ws, void* g_ws, void* m,
                            void* bias, void* bb_ws, void* out, int b, int n, int h, int w, int c,
                            int d, int o, float eps, void* stream) {
  const float* w1 = static_cast<const float*>(w_o1);
  float* bf = static_cast<float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (x || coef || sx || sy || mean_ws || g_ws || bb_ws) return cudaErrorInvalidValue;
    return launch_f32(static_cast<const float*>(u), static_cast<const float*>(kx),
                      static_cast<const float*>(ky), static_cast<const float*>(w_in), w1,
                      static_cast<float*>(m), bf, static_cast<float*>(out), b, n, h, w, c, d, o,
                      eps, st);
  }
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(u), static_cast<const bf16*>(kx),
                       static_cast<const bf16*>(ky), static_cast<const bf16*>(w_in), w1,
                       MeanFrom{static_cast<const bf16*>(x), static_cast<const float*>(coef),
                                static_cast<const float*>(sx), static_cast<const float*>(sy),
                                static_cast<float*>(mean_ws)},
                       static_cast<float*>(g_ws), static_cast<bf16*>(m), bf,
                       static_cast<bf16*>(bb_ws),
                       static_cast<bf16*>(out), b, n, h, w, c, d, o, eps, st);
  return cudaErrorInvalidValue;
}

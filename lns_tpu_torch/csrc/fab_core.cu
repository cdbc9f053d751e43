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
// before its last rounding, by a first pass over each sample's x
// (fab_block_mean_bf16) into a [b, n, c] scratch that the statistics read
// in place of their own mean. The variance stays max(E[phi^2] - mean^2, 0),
// as in _batched_gram_core.
//
// What bounds it on an H100: arithmetic. At 32x32, c = o = 64, 8 heads and
// 116 samples one call is ~31 GFLOP (both axial applies, the Gram and the
// c -> o product, the applies twice) against ~34 MB of u, k and out:
// ~900 FLOP per byte, above the card's ~295 FLOP/B bf16 ridge, so only
// tensor cores approach the floor.
//
// Both dtypes run two passes, because a sample's bb does not fit in one
// block's shared memory; bb never reaches device memory, and the head sum
// is a loop inside a block (no atomics, no dependence on scheduling):
//   stats  one block per (head, sample): bb tile by tile, the Gram summed
//          over tiles, then m (in T) and the bias (f32) for its head into a
//          small scratch ([b, n, c, o] / [b, n, o]);
//   apply  one block per (tile, sample): for each head, recompute the tile's
//          bb and add bb . m; subtract the summed bias, write the tile once.
//
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulators; mma.cuh), at the
// rounding points of _batched_gram_core. For w <= h (every NS2d field), in
// the TPU kernel's order:
//   a  = u . k_y^T  rounded to bf16    [h, 8, c] for a tile of 8 columns
//   bb = k_x . a    rounded to bf16    [h, 8, c]
//   G += bb^T bb    (f32)              m rounded to bf16; the bias summed
//   out = bf16(bf16(sum_n bb . m_n) - bf16(sum_n bias_n))  over heads in f32
// For w > h, _batched_gram_core applies k_x first. The kernels then run on
// the transposed field: h and w swap, k_x and k_y swap, and u and out are
// read and written through transposed pixel strides (Plan::sj, sm, oi, ol),
// so a tile is 8 rows of the k_x-applied axis and nothing is copied.
// Design. 512 threads (16 warps) per block, one block per SM. A tile is the
// columns l0..l0+7 of the k_y-applied axis. Its a needs every row of u: u
// is resident in shared memory where it fits (loaded once per block with
// cp.async, then read by every tile and head; 32x32 and 16x16 at c64: on an
// H100 0.58-0.60 ms at 32x32 c64 b116 against 0.81 with u streamed), else
// it streams from L2 through a 2-stage cp.async ring of up to 16 rows. Each row of a
// is one [c x w] . [w x 8] product per warp (k_y's fragments stay in
// registers); then bb = k_x . a is [h x h] . [h x 8 c], warps l and l + 8
// sharing column l. The Gram (stats; each warp half sums half the rows,
// added in a fixed order) and bb . m (apply; o split between the two warps
// of a column, accumulated in registers across the heads) read bb from
// shared memory. The apply fetches the next head's k_y tile, m, bias and
// (for h <= 64) k_x into registers while this head's bb . m runs. The
// statistics' f32 epilogue runs on every thread (mean_c from the resident
// u); its arrays overwrite the bf16 ones once every read of them has ended.
// Side lengths are padded to 16 with zeros in shared memory (zero rows and
// columns of k_x, k_y add nothing); the statistics divide by the true h w.
// Shared memory per block (bf16 elements, hp, wp = h, w padded to 16):
//   k_x hp (hp+8) + k_y tile 8 (wp+8) + a hp (8 (c+8) + 8)
//   + u h wp (c+8) + bb 8 hp (c+8)          (u resident), or
//   + max(ring 2 R wp (c+8), bb)             (u streamed)
// plus the column sums of k_x, k_y (stats) or the bias sum (apply), f32:
// 225,152 bytes at 32x32 c64 and 75,392 at 16x16 c64. Where no streamed
// plan fits, a drops the 8-element pad between its tile columns (its rows
// stay conflict-free; its writes take 4-way conflicts): 96x48 c64, and SW's
// 48x96 c64 run transposed, take 231,872 bytes instead of 244,160. Limits,
// stated once in bf16_limit (the launcher refuses, the wrapper raises with
// its text): c a multiple of 16 up to 128, o a multiple of 16, h and w up
// to 128, and the block within 227 KB. Each apply block covers oc = 64
// columns of o (32 when the second-applied side exceeds 32).
//
// f32: the same two passes with f32 FMAs on CUDA cores, bb in tiles of
// kTI = 2 rows, k_x applied first; f32 has no tensor-core form at the TPU
// kernel's precision.

#include <algorithm>
#include <cstdio>

#include "common.cuh"
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

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kTcThreads = 512, kWarps = kTcThreads / 32;
constexpr int kTL = 8;          // tile: columns of the k_y-applied axis, two warps each
constexpr int kMaxSide = 128;   // h, w
constexpr int kMaxC = 128;      // c
constexpr int kGramUnits = 4;   // 16 x 32 Gram blocks per warp: (128 / 16) (128 / 32) / 8
// a k_y tile [8][wp] is two elements per thread (.x: tid, .y: tid + 512),
// packed in one register
static_assert(kTL * kMaxSide == 2 * kTcThreads, "two k_y tile elements per thread");
static_assert(kWarps == 2 * kTL, "warps w and w + 8 share column l0 + w of a tile");

// Shared-memory layout of both bf16 kernels; strides and offsets in bf16
// elements. Every stride is an odd multiple of 16 bytes (conflict-free
// ldmatrix) and every region starts on a 16-byte boundary:
//   k_x [hp][ldk] | k_y tile [8][ldy] | a [hp][lda] | u | bb [8 hp][ldc]
// u is either resident (all h rows, loaded once per block) or a 2-stage ring
// of `rows` rows that bb then overwrites. In the apply pass m [c][ldm] and
// the output staging [8 hp][ldm] reuse a's place.
struct Plan {
  int hp, wp, rows, resident;  // h, w padded to 16; u rows per stage; u held whole
  int ldk, ldy, ldc, lda;      // strides: k_x, k_y tile, u / bb rows (c + 8), a
  int ldac;                    // a's stride between tile columns: c + 8, or c (compact)
  int sj, sm, oi, ol;          // pixel strides of u's (j, m) and out's (i, l)
  int off_ky, off_a, off_u, off_bb;
  int oc, ldm;                 // apply: o columns per block and m's stride
  int stats_bytes, apply_bytes;
};

int round16(int v) { return (v + 15) / 16 * 16; }

Plan make_plan(int h, int w, int c, int d, int o, int rows, bool resident, bool compact) {
  Plan p;
  p.hp = round16(h);
  p.wp = round16(w);
  p.rows = resident ? h : rows;
  p.resident = resident;
  p.ldk = p.hp + 8;
  p.ldy = p.wp + 8;
  p.ldc = c + 8;
  p.ldac = compact ? c : p.ldc;
  p.lda = kTL * p.ldac + 8;
  p.sj = w;
  p.sm = 1;
  p.oi = w;
  p.ol = 1;
  p.oc = p.hp <= 32 ? 64 : 32;
  p.ldm = p.oc + 8;
  p.off_ky = p.hp * p.ldk;
  p.off_a = p.off_ky + kTL * p.ldy;
  p.off_u = p.off_a + p.hp * p.lda;
  const int u = resident ? h * p.wp * p.ldc : 2 * rows * p.wp * p.ldc, bb = kTL * p.hp * p.ldc;
  p.off_bb = resident ? p.off_u + u : p.off_u;
  const int end = resident ? p.off_bb + bb : p.off_u + std::max(u, bb);
  // f32 epilogue (aliases the rest): G, W_in, W_o1, mean_c, mean, inv and
  // the partial sums; then sx, sy past its end
  const int part = std::max(kTcThreads / (c / 8) * c, c / 4 * d);
  const int epilogue = 4 * (c * c + c * d + d * o + c + 2 * d + part);
  p.stats_bytes = std::max(2 * end, epilogue) + 4 * (p.hp + p.wp);
  p.apply_bytes = 2 * std::max(end, p.off_a + kTL * p.hp * p.ldm) + 4 * p.oc;
  return p;
}

int plan_smem(const Plan& p) { return std::max(p.stats_bytes, p.apply_bytes); }

// The plan in the kernels' own (h, w), which for w > h is the transposed
// field: u resident when it fits (each block then reads u from L2 once, not
// once per tile or head); else the most u rows per ring stage (16, 8, 4, 2)
// that fit, with a padded, then compact; else rows = 1 (which does not fit).
Plan plan_kernel(int h, int w, int c, int d, int o) {
  const int limit = static_cast<int>(lns::kMaxDynamicSmem);
  const Plan whole = make_plan(h, w, c, d, o, h, true, false);
  if (plan_smem(whole) <= limit) return whole;
  for (bool compact : {false, true})
    for (int rows = kWarps; rows > 1; rows /= 2) {
      const Plan p = make_plan(h, w, c, d, o, rows, false, compact);
      if (plan_smem(p) <= limit) return p;
    }
  return make_plan(h, w, c, d, o, 1, false, true);
}

// The plan for a field h x w: k_y first for w <= h; for w > h the kernels
// see the transposed field (h, w swapped), reading u and writing out through
// transposed pixel strides.
Plan plan_for(int h, int w, int c, int d, int o) {
  if (w <= h) return plan_kernel(h, w, c, d, o);
  Plan p = plan_kernel(w, h, c, d, o);
  p.sj = 1;  // u'(j, m) = u[m][j], out'(i, l) = out[l][i], both [h][w] in memory
  p.sm = w;
  p.oi = 1;
  p.ol = w;
  return p;
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
    const int need = plan_smem(plan_for(h, w, c, d, o));
    if (need <= limit) return nullptr;
    snprintf(msg, sizeof msg, "shared memory per block within %d bytes, needs %d", limit, need);
  }
  return msg;
}

// Rows r0.. of the sample's u [h, w, c] into `dst` [rows][wp][ldc] (zeros for
// rows >= h and columns >= w), as 16-byte cp.async copies; not committed.
__device__ __forceinline__ void copy_u_rows(const bf16* __restrict__ us, const Plan& p, bf16* dst,
                                        int r0, int rows, int h, int w, int c) {
  const int pieces = rows * p.wp * (c / 8);
  for (int e = threadIdx.x; e < pieces; e += kTcThreads) {
    const int c8 = (e % (c / 8)) * 8, rm = e / (c / 8), m = rm % p.wp, r = rm / p.wp;
    const int j = r0 + r;
    const bool valid = j < h && m < w;
    lns::cp_async16(dst + (r * p.wp + m) * p.ldc + c8,
                    valid ? us + (static_cast<size_t>(j) * p.sj + m * p.sm) * c + c8 : us, valid);
  }
}

// One tile, one head: a = (u . k_y^T) into a_s (rows j < h; rows h..hp stay
// zero), then bb = k_x . a into bb_s, row (l, i) = l hp + i, both rounded to
// bf16. k_x and the k_y tile are in shared memory; u is resident in u_s (all
// h rows, landed) or streams through it as a ring. Ends with bb_s complete
// and the block in step. KF: k_y's fragments held in registers, 4 for
// w <= 64 and 8 above (8 for every w made the kernels spill at w <= 64).
template <int KF>
__device__ __forceinline__ void tile_a_bb(const bf16* __restrict__ us, const Plan& p,
                                          const bf16* kx_s, const bf16* ky_s, bf16* a_s,
                                          bf16* u_s, bf16* bb_s, int h, int w, int c) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int chunk = p.rows * p.wp * p.ldc, nq = (h + p.rows - 1) / p.rows, ct = c / 16;
  if (!p.resident) {
    copy_u_rows(us, p, u_s, 0, p.rows, h, w, c);
    lns::cp_async_commit();
  }
  // k_y's fragments: B of a_j^T [c x TL] = u_j^T [c x w] . k_y^T [w x TL]
  uint32_t kf[KF][2];
#pragma unroll
  for (int ks = 0; ks < KF; ++ks)
    if (ks * 16 < p.wp) lns::ldsm_x2(kf[ks], ky_s + lns::bt_addr(lane, 0, ks * 16, p.ldy));
  for (int q = 0; q < nq; ++q) {
    if (!p.resident) {
      if (q + 1 < nq)
        copy_u_rows(us, p, u_s + (q + 1) % 2 * chunk, (q + 1) * p.rows, p.rows, h, w, c);
      lns::cp_async_commit();
      lns::cp_async_wait<1>();  // chunk q has landed
      __syncthreads();
    }
    const bf16* chunk_s = u_s + (p.resident ? 0 : q % 2 * chunk);
    for (int r = warp; r < p.rows; r += kWarps) {  // one row of u per warp, all channels
      const int j = q * p.rows + r;
      if (j >= h) break;
      const bf16* ur = chunk_s + r * p.wp * p.ldc;  // u_j as [m][cc]
      bf16* ar = a_s + j * p.lda;                   // a_j as [l][cc]
#pragma unroll
      for (int m0 = 0; m0 < kMaxC / 16; m0 += 4) {  // 4 independent 16-channel chains
        if (m0 >= ct) break;
        float acc[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < KF; ++ks)
          if (ks * 16 < p.wp) {
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4)
              if (m0 + q4 < ct) {
                uint32_t af[4];
                lns::ldsm_x4_trans(af, ur + lns::at_addr(lane, ks * 16, (m0 + q4) * 16, p.ldc));
                lns::mma_bf16(acc[q4], af, kf[ks][0], kf[ks][1]);
              }
          }
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4)
          if (m0 + q4 < ct) {  // (cc, l = 2t), (cc, 2t+1), (cc+8, 2t), (cc+8, 2t+1)
            const int cc = (m0 + q4) * 16 + g;
            ar[2 * t * p.ldac + cc] = __float2bfloat16(acc[q4][0]);
            ar[(2 * t + 1) * p.ldac + cc] = __float2bfloat16(acc[q4][1]);
            ar[2 * t * p.ldac + cc + 8] = __float2bfloat16(acc[q4][2]);
            ar[(2 * t + 1) * p.ldac + cc + 8] = __float2bfloat16(acc[q4][3]);
          }
      }
    }
    __syncthreads();  // a's rows are in place; a ring stage is free for chunk q + 2
  }
  // bb[i, l0 + col, :] = sum_j k_x[i, j] a[j, col, :]; warps col and col + 8
  // take alternate 16 x 32 blocks of it
  const int col = warp % kTL, nb = (c + 31) / 32;
  for (int un = warp / kTL; un < p.hp / 16 * nb; un += 2) {
    const int mt = un / nb, n0 = un % nb * 32;
    const bool two = n0 + 16 < c;
    float acc[4][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < p.hp; ks += 16) {
      uint32_t af[4], bfr[4];
      lns::ldsm_x4(af, kx_s + lns::a_addr(lane, mt * 16, ks, p.ldk));
      lns::ldsm_x4_trans(bfr, a_s + lns::b_addr(lane, ks, col * p.ldac + n0, p.lda));
      lns::mma_bf16(acc[0], af, bfr[0], bfr[1]);
      lns::mma_bf16(acc[1], af, bfr[2], bfr[3]);
      if (two) {
        lns::ldsm_x4_trans(bfr, a_s + lns::b_addr(lane, ks, col * p.ldac + n0 + 16, p.lda));
        lns::mma_bf16(acc[2], af, bfr[0], bfr[1]);
        lns::mma_bf16(acc[3], af, bfr[2], bfr[3]);
      }
    }
    bf16* row = bb_s + (col * p.hp + mt * 16 + g) * p.ldc + n0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (nt < 2 || two) {
        *reinterpret_cast<uint32_t*>(row + nt * 8) = lns::pack_bf16(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<uint32_t*>(row + 8 * p.ldc + nt * 8) =
            lns::pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }
  __syncthreads();
}

// u resident: all of the sample's rows, once per block (waited before use)
__device__ __forceinline__ void load_u_resident(const bf16* __restrict__ us, const Plan& p,
                                                bf16* u_s, int h, int w, int c) {
  if (!p.resident) return;
  copy_u_rows(us, p, u_s, 0, h, h, w, c);
  lns::cp_async_commit();
}

// k_x [h, h] of (sample, head) `sn` into kx_s, zero-padded to hp x hp
__device__ __forceinline__ void load_kx(const bf16* __restrict__ kx, size_t sn, const Plan& p,
                                        bf16* kx_s, int h) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < p.hp * p.hp; e += kTcThreads) {
    const int i = e / p.hp, j = e % p.hp;
    kx_s[i * p.ldk + j] = i < h && j < h ? kx[(sn * h + i) * h + j] : zero;
  }
}

// This thread's two elements of the k_y tile [8][wp] of rows l0.. of
// (sample, head) `sn` (zeros outside k_y), and their place in ky_s.
__device__ __forceinline__ __nv_bfloat162 fetch_ky_pair(const bf16* __restrict__ ky, size_t sn,
                                                       const Plan& p, int l0, int w) {
  bf16 v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = threadIdx.x + k * kTcThreads, l = e / p.wp, m = e % p.wp;
    v[k] = l < kTL && l0 + l < w && m < w ? ky[(sn * w + l0 + l) * w + m] : __float2bfloat16(0.f);
  }
  return __halves2bfloat162(v[0], v[1]);
}
__device__ __forceinline__ void store_ky_pair(__nv_bfloat162 v, const Plan& p, bf16* ky_s) {
  const int e0 = threadIdx.x, e1 = threadIdx.x + kTcThreads;
  if (e0 < kTL * p.wp) ky_s[e0 / p.wp * p.ldy + e0 % p.wp] = v.x;
  if (e1 < kTL * p.wp) ky_s[e1 / p.wp * p.ldy + e1 % p.wp] = v.y;
}

// a_s rows h..hp-1 (the padding of the contraction over k_x's columns) to zero
__device__ __forceinline__ void zero_a_tail(const Plan& p, bf16* a_s, int h) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < (p.hp - h) * p.lda; e += kTcThreads) a_s[h * p.lda + e] = zero;
}

// The block's mean_c [b, n, c] (f32) as the jitted JAX FAB block feeds it
// to _batched_gram_core: sum_px sx[n, j] sy[n, m] (bf16(x[px] sc) + sh) / N,
// from the GroupNorm(1) output before its last rounding and the f32 row sums
// of the unrounded kernels. One block per (sample, kHC heads) reads the
// sample's x once for its heads (the statistics' blocks, one per head,
// would read it n times): 8 channels and a run of pixels per thread, partial
// sums added through shared memory in a fixed order. In the field's own
// orientation: a channel mean does not depend on it.
constexpr int kMeanThreads = 256, kHC = 4;

__global__ void __launch_bounds__(kMeanThreads)
fab_block_mean_bf16(const bf16* __restrict__ x, const float* __restrict__ coef,
                    const float* __restrict__ sxg, const float* __restrict__ syg,
                    float* __restrict__ mean_b, int n, int h, int w, int c) {
  extern __shared__ float4 smem_mean[];
  float* sx = reinterpret_cast<float*>(smem_mean);  // [n, h]
  float* sy = sx + n * h;                            // [n, w]
  float* part = sy + n * w;                          // [groups, kHC, c]
  const int tid = threadIdx.x, s = blockIdx.x, n0 = blockIdx.y * kHC;
  const int c8n = c / 8, groups = kMeanThreads / c8n, c8 = tid % c8n * 8, grp = tid / c8n;
  for (int e = tid; e < n * h; e += kMeanThreads) sx[e] = sxg[static_cast<size_t>(s) * n * h + e];
  for (int e = tid; e < n * w; e += kMeanThreads) sy[e] = syg[static_cast<size_t>(s) * n * w + e];
  float sc[8] = {}, sh[8] = {};
  if (grp < groups)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sc[q] = coef[2 * static_cast<size_t>(s) * c + c8 + q];
      sh[q] = coef[(2 * static_cast<size_t>(s) + 1) * c + c8 + q];
    }
  __syncthreads();
  const bf16* xs = x + static_cast<size_t>(s) * h * w * c;
  const float inv_n = 1.f / static_cast<float>(h * w);
  const int hc = min(kHC, n - n0);
  float acc[kHC][8] = {};
  if (grp < groups)
#pragma unroll 4
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
    mean_b[(static_cast<size_t>(s) * n + n0 + k) * c + cc] = a * inv_n;
  }
}

int block_mean_smem(int n, int h, int w, int c) {
  return 4 * (n * (h + w) + kMeanThreads / (c / 8) * kHC * c);
}

template <int KF>
__global__ void __launch_bounds__(kTcThreads, 1)
fab_stats_bf16(const bf16* __restrict__ u, const bf16* __restrict__ kx,
               const bf16* __restrict__ ky, const bf16* __restrict__ w_in,
               const float* __restrict__ w1, const float* __restrict__ mean_b,
               bf16* __restrict__ m_out,
               float* __restrict__ bias_out, int n, int h, int w, int c, int d, int o, float eps,
               Plan p) {
  extern __shared__ uint4 smem_fab[];
  bf16* kx_s = reinterpret_cast<bf16*>(smem_fab);
  bf16* ky_s = kx_s + p.off_ky;
  bf16* a_s = kx_s + p.off_a;
  bf16* u_s = kx_s + p.off_u;
  bf16* bb_s = kx_s + p.off_bb;
  // column sums of k_x and k_y (f32), kept past the epilogue's aliasing
  float* sx = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_fab) + p.stats_bytes) -
              (p.hp + p.wp);
  float* sy = sx + p.hp;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int tid = threadIdx.x, hd = blockIdx.x, s = blockIdx.y;
  const size_t sn = static_cast<size_t>(s) * n + hd;
  const bf16* us = u + static_cast<size_t>(s) * h * w * c;

  load_u_resident(us, p, u_s, h, w, c);
  load_kx(kx, sn, p, kx_s, h);
  zero_a_tail(p, a_s, h);
  for (int m = tid; m < w; m += kTcThreads) sy[m] = 0.f;
  lns::cp_async_wait<0>();
  __syncthreads();
  for (int j = tid; j < h; j += kTcThreads) {
    float a = 0.f;
    for (int i = 0; i < h; ++i) a += ld(kx_s[i * p.ldk + j]);
    sx[j] = a;
  }
  // the Gram in 16 x 32 blocks: block warp % 8 + 8 k, over half of each
  // tile's rows (warp / 8 says which)
  const int cn = (c + 31) / 32, blocks = (c / 16) * cn, half = warp / kTL, kh = kTL * p.hp / 2;
  float gacc[kGramUnits][4][4] = {};
  // this thread's elements of a k_y tile [8][wp], fetched a tile ahead
  __nv_bfloat162 kyr = fetch_ky_pair(ky, sn, p, 0, w);
  for (int l0 = 0; l0 < w; l0 += kTL) {
    store_ky_pair(kyr, p, ky_s);
    __syncthreads();
    if (l0 + kTL < w) kyr = fetch_ky_pair(ky, sn, p, l0 + kTL, w);
    for (int m = tid; m < w; m += kTcThreads) {
      float a = sy[m];
      for (int l = 0; l < kTL; ++l) a += ld(ky_s[l * p.ldy + m]);
      sy[m] = a;
    }
    tile_a_bb<KF>(us, p, kx_s, ky_s, a_s, u_s, bb_s, h, w, c);
#pragma unroll 2
    for (int ks = half * kh; ks < (half + 1) * kh; ks += 16) {
#pragma unroll
      for (int k = 0; k < kGramUnits; ++k) {
        const int blk = warp % kTL + kTL * k;
        if (blk >= blocks) continue;
        const int m0 = blk / cn * 16, n0 = blk % cn * 32;
        uint32_t af[4], bfr[4];
        lns::ldsm_x4_trans(af, bb_s + lns::at_addr(lane, ks, m0, p.ldc));  // bb^T
        lns::ldsm_x4_trans(bfr, bb_s + lns::b_addr(lane, ks, n0, p.ldc));
        lns::mma_bf16(gacc[k][0], af, bfr[0], bfr[1]);
        lns::mma_bf16(gacc[k][1], af, bfr[2], bfr[3]);
        if (n0 + 16 < c) {
          lns::ldsm_x4_trans(bfr, bb_s + lns::b_addr(lane, ks, n0 + 16, p.ldc));
          lns::mma_bf16(gacc[k][2], af, bfr[0], bfr[1]);
          lns::mma_bf16(gacc[k][3], af, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  // mean_c = sum_px sx[j] sy[m] u[px, :] / N: partial sums over pixels for 8
  // channels per thread, from the resident u (else from L2); none where the
  // block's mean is given
  const int c8n = c / 8, groups = kTcThreads / c8n;
  float mc[8] = {};
  if (!mean_b && tid < groups * c8n) {
    const int c8 = tid % c8n * 8, dj = groups / w, dm = groups % w;
    int j = tid / c8n / w, m = tid / c8n % w;  // pixel px = j w + m
#pragma unroll 4
    for (int px = tid / c8n; px < h * w; px += groups) {
      const uint4 v = p.resident
          ? *reinterpret_cast<const uint4*>(u_s + (j * p.wp + m) * p.ldc + c8)
          : *reinterpret_cast<const uint4*>(us + (static_cast<size_t>(j) * p.sj + m * p.sm) * c + c8);
      const bf16* vb = reinterpret_cast<const bf16*>(&v);
      const float wgt = sx[j] * sy[m];
#pragma unroll
      for (int q = 0; q < 8; ++q) mc[q] = fmaf(wgt, ld(vb[q]), mc[q]);
      j += dj;
      m += dm;
      if (m >= w) {
        m -= w;
        ++j;
      }
    }
  }
  __syncthreads();  // every read of u (above) and of bb ends before G overwrites them

  // f32 epilogue on every thread; its arrays alias everything but sx, sy
  float* g_s = reinterpret_cast<float*>(smem_fab);  // [c, c]
  float* win_s = g_s + c * c;                       // [c, d]
  float* w1_s = win_s + c * d;                      // [d, o]: W_o1, then diag(inv) W_o1
  float* meanc = w1_s + d * o;                      // [c]
  float* mean_d = meanc + c;                        // [d]
  float* inv_d = mean_d + d;                        // [d]
  float* part = inv_d + d;                          // partial sums
  for (int pass = 0; pass < 2; ++pass) {  // the first half's sums, then the second's added
    if (half == pass) {
#pragma unroll
      for (int k = 0; k < kGramUnits; ++k) {
        const int blk = warp % kTL + kTL * k;
        if (blk >= blocks) continue;
        const int r = blk / cn * 16 + g, n0 = blk % cn * 32 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (n0 + nt * 8 < c) {
            float* gr = g_s + r * c + n0 + nt * 8;
            const float* v = gacc[k][nt];
            gr[0] = pass ? gr[0] + v[0] : v[0];
            gr[1] = pass ? gr[1] + v[1] : v[1];
            gr[8 * c] = pass ? gr[8 * c] + v[2] : v[2];
            gr[8 * c + 1] = pass ? gr[8 * c + 1] + v[3] : v[3];
          }
      }
    }
    __syncthreads();
  }
#pragma unroll 4
  for (int e = tid; e < c * d; e += kTcThreads)
    win_s[e] = ld(w_in[(static_cast<size_t>(e / d) * n + hd) * d + e % d]);
  const float* w1h = w1 + static_cast<size_t>(hd) * d * o;
#pragma unroll 4
  for (int e = tid; e < d * o / 4; e += kTcThreads)
    reinterpret_cast<float4*>(w1_s)[e] = reinterpret_cast<const float4*>(w1h)[e];
  if (!mean_b && tid < groups * c8n)
#pragma unroll
    for (int q = 0; q < 8; ++q) part[tid / c8n * c + tid % c8n * 8 + q] = mc[q];
  __syncthreads();
  const float inv_n = 1.f / static_cast<float>(h * w);
  for (int cc = tid; cc < c; cc += kTcThreads) {  // or the block's (fab_block_mean_bf16)
    float a = 0.f;
    if (!mean_b)
      for (int gi = 0; gi < groups; ++gi) a += part[gi * c + cc];
    meanc[cc] = mean_b ? mean_b[sn * c + cc] : a * inv_n;
  }
  __syncthreads();
  // E[phi^2] = W_in^T G W_in / N: 4 x 2 blocks of (G W_in)[ci, dd] per thread,
  // reduced over ci in a fixed order through `part` [c / 4][d]
  const int dq = (d + 1) / 2;
  for (int e = tid; e < c / 4 * dq; e += kTcThreads) {
    const int ci0 = e / dq * 4, dd0 = e % dq * 2;
    float acc[4][2] = {};
#pragma unroll 4
    for (int cj = 0; cj < c; ++cj) {
      const float4 gv = *reinterpret_cast<const float4*>(g_s + cj * c + ci0);  // G symmetric
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      float wv[2];
#pragma unroll
      for (int b2 = 0; b2 < 2; ++b2) wv[b2] = dd0 + b2 < d ? win_s[cj * d + dd0 + b2] : 0.f;
#pragma unroll
      for (int a2 = 0; a2 < 4; ++a2)
#pragma unroll
        for (int b2 = 0; b2 < 2; ++b2) acc[a2][b2] = fmaf(ga[a2], wv[b2], acc[a2][b2]);
    }
#pragma unroll
    for (int b2 = 0; b2 < 2; ++b2)
      if (dd0 + b2 < d) {
        float sum = 0.f;
#pragma unroll
        for (int a2 = 0; a2 < 4; ++a2)
          sum = fmaf(win_s[(ci0 + a2) * d + dd0 + b2], acc[a2][b2], sum);
        part[ci0 / 4 * d + dd0 + b2] = sum;
      }
  }
  __syncthreads();
  for (int dd = tid; dd < d; dd += kTcThreads) {
    float mean = 0.f, ex2 = 0.f;
#pragma unroll 8
    for (int ci = 0; ci < c; ++ci) mean = fmaf(meanc[ci], win_s[ci * d + dd], mean);
    for (int k = 0; k < c / 4; ++k) ex2 += part[k * d + dd];
    const float var = fmaxf(ex2 * inv_n - mean * mean, 0.f);
    mean_d[dd] = mean;
    inv_d[dd] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int e = tid; e < d * o; e += kTcThreads) w1_s[e] *= inv_d[e / o];  // diag(inv) W_o1
  __syncthreads();
  // m = W_in (diag(inv) W_o1), 4 x 2 blocks per thread, in bf16
  bf16* mo = m_out + sn * c * o;
  const int oq = o / 2;
  for (int e = tid; e < c / 4 * oq; e += kTcThreads) {
    const int ci0 = e / oq * 4, oo0 = e % oq * 2;
    float acc[4][2] = {};
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      const float2 v1 = *reinterpret_cast<const float2*>(w1_s + dd * o + oo0);
#pragma unroll
      for (int a2 = 0; a2 < 4; ++a2) {
        const float wa = win_s[(ci0 + a2) * d + dd];
        acc[a2][0] = fmaf(wa, v1.x, acc[a2][0]);
        acc[a2][1] = fmaf(wa, v1.y, acc[a2][1]);
      }
    }
#pragma unroll
    for (int a2 = 0; a2 < 4; ++a2)
      *reinterpret_cast<uint32_t*>(mo + (ci0 + a2) * o + oo0) =
          lns::pack_bf16(acc[a2][0], acc[a2][1]);
  }
  for (int oo = tid; oo < o; oo += kTcThreads) {  // bias = (mean diag(inv)) W_o1
    float acc = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < d; ++dd) acc = fmaf(mean_d[dd], w1_s[dd * o + oo], acc);
    bias_out[sn * o + oo] = acc;
  }
}

// MT = hp / 16: m16 tiles of this warp's column in the bb . m product; each
// block covers oc = 8 NT columns of o. The next head's k_y tile, bias and m
// (and for hp <= 64 its k_x; larger k_x would take too many registers) are
// fetched into registers while this head's bb . m runs. KF: as tile_a_bb.
template <int MT, int KF>
__global__ void __launch_bounds__(kTcThreads, 1)
fab_apply_bf16(const bf16* __restrict__ u, const bf16* __restrict__ kx,
               const bf16* __restrict__ ky, const bf16* __restrict__ m_in,
               const float* __restrict__ bias_in, bf16* __restrict__ out, int n, int h, int w,
               int c, int o, Plan p) {
  constexpr int NT = MT <= 2 ? 8 : 4;
  constexpr int OC = NT * 8;  // == p.oc
  constexpr int NW = NT / 2;  // n8 tiles of o per warp: warps col, col + 8 split OC
  constexpr bool kKxAhead = MT <= 4;
  constexpr int KXR = kKxAhead ? (16 * MT * 16 * MT + kTcThreads - 1) / kTcThreads : 1;
  constexpr int MR = (kMaxC * OC / 8 + kTcThreads - 1) / kTcThreads;  // 8 m's per thread
  extern __shared__ uint4 smem_fab[];
  bf16* kx_s = reinterpret_cast<bf16*>(smem_fab);
  bf16* ky_s = kx_s + p.off_ky;
  bf16* a_s = kx_s + p.off_a;
  bf16* u_s = kx_s + p.off_u;
  bf16* bb_s = kx_s + p.off_bb;
  bf16* m_s = a_s;  // [c][OC + 8], once a is consumed
  float* bsum = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_fab) + p.apply_bytes) - OC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int col = warp % kTL, n8 = warp / kTL * NW;  // this warp's column and first n8 tile
  const int tid = threadIdx.x, l0 = blockIdx.x * kTL, o0 = blockIdx.y * OC, s = blockIdx.z;
  const bf16* us = u + static_cast<size_t>(s) * h * w * c;
  const bf16 zero = __float2bfloat16(0.f);

  bf16 kxr[KXR];
  __nv_bfloat162 kyr;
  float br;
  uint4 mr[MR];
  auto fetch = [&](int hd) {  // this thread's share of head hd's inputs
    const size_t sn = static_cast<size_t>(s) * n + hd;
    if constexpr (kKxAhead) {
#pragma unroll
      for (int k = 0; k < KXR; ++k) {
        const int e = tid + k * kTcThreads, i = e / p.hp, j = e % p.hp;
        kxr[k] = i < h && j < h ? kx[(sn * h + i) * h + j] : zero;
      }
    }
    kyr = fetch_ky_pair(ky, sn, p, l0, w);
    br = tid < OC && o0 + tid < o ? bias_in[sn * o + o0 + tid] : 0.f;
#pragma unroll
    for (int k = 0; k < MR; ++k) {
      const int e = tid + k * kTcThreads, cc = e / (OC / 8), c8 = e % (OC / 8) * 8;
      mr[k] = cc < c && o0 + c8 < o
          ? *reinterpret_cast<const uint4*>(m_in + (sn * c + cc) * o + o0 + c8)
          : make_uint4(0, 0, 0, 0);
    }
  };

  load_u_resident(us, p, u_s, h, w, c);
  if (tid < OC) bsum[tid] = 0.f;
  float acc[MT][NW][4] = {};
  fetch(0);
  for (int hd = 0; hd < n; ++hd) {
    if constexpr (kKxAhead) {
#pragma unroll
      for (int k = 0; k < KXR; ++k) {  // k_x, zero-padded to hp x hp
        const int e = tid + k * kTcThreads;
        if (e < p.hp * p.hp) kx_s[e / p.hp * p.ldk + e % p.hp] = kxr[k];
      }
    } else {
      load_kx(kx, static_cast<size_t>(s) * n + hd, p, kx_s, h);
    }
    store_ky_pair(kyr, p, ky_s);  // rows l0..l0+7
    if (tid < OC) bsum[tid] += br;
    zero_a_tail(p, a_s, h);  // m overwrote it
    lns::cp_async_wait<0>();
    __syncthreads();
    tile_a_bb<KF>(us, p, kx_s, ky_s, a_s, u_s, bb_s, h, w, c);
#pragma unroll
    for (int k = 0; k < MR; ++k) {  // m_n, columns o0..o0+OC
      const int e = tid + k * kTcThreads, cc = e / (OC / 8), c8 = e % (OC / 8) * 8;
      if (cc < c) *reinterpret_cast<uint4*>(m_s + cc * p.ldm + c8) = mr[k];
    }
    if (hd + 1 < n) fetch(hd + 1);
    __syncthreads();
    // acc[(l = col, i), o] += bb[(l, i), :] . m[:, o]
    for (int ks = 0; ks < c; ks += 16) {
      uint32_t bfr[NW / 2][4];
#pragma unroll
      for (int np = 0; np < NW / 2; ++np)
        lns::ldsm_x4_trans(bfr[np], m_s + lns::b_addr(lane, ks, (n8 + 2 * np) * 8, p.ldm));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        lns::ldsm_x4(af, bb_s + lns::a_addr(lane, col * p.hp + mt * 16, ks, p.ldc));
#pragma unroll
        for (int np = 0; np < NW / 2; ++np) {
          lns::mma_bf16(acc[mt][2 * np], af, bfr[np][0], bfr[np][1]);
          lns::mma_bf16(acc[mt][2 * np + 1], af, bfr[np][2], bfr[np][3]);
        }
      }
    }
    __syncthreads();  // before the next head refills k_x, k_y, a (and the ring)
  }
  // out = bf16(bf16(acc) - bf16(sum of the heads' biases)): the head sum
  // rounded once, the bias subtracted in bf16, as _batched_gram_core does;
  // staged [8 hp][OC + 8]
  bf16* st = a_s;
  using lns::rnd;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
      const int oc = (n8 + nt) * 8 + 2 * t;
      const float b0 = rnd<bf16>(bsum[oc]), b1 = rnd<bf16>(bsum[oc + 1]);
      const float* v = acc[mt][nt];
      bf16* r = st + (col * p.hp + mt * 16 + g) * p.ldm + oc;
      *reinterpret_cast<uint32_t*>(r) = lns::pack_bf16(rnd<bf16>(v[0]) - b0, rnd<bf16>(v[1]) - b1);
      *reinterpret_cast<uint32_t*>(r + 8 * p.ldm) =
          lns::pack_bf16(rnd<bf16>(v[2]) - b0, rnd<bf16>(v[3]) - b1);
    }
  __syncthreads();
  for (int e = tid; e < h * kTL * (OC / 8); e += kTcThreads) {  // 16-byte stores
    const int c8 = e % (OC / 8) * 8, il = e / (OC / 8), l = il % kTL, i = il / kTL;
    if (l0 + l >= w || o0 + c8 >= o) continue;
    const size_t px = static_cast<size_t>(s) * h * w + i * p.oi + (l0 + l) * p.ol;
    *reinterpret_cast<uint4*>(out + px * o + o0 + c8) =
        *reinterpret_cast<const uint4*>(st + (l * p.hp + i) * p.ldm + c8);
  }
}

template <typename K>
cudaError_t prepare(K kernel, int bytes) {
  cudaError_t e = lns::allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int MT, int KF>
int launch_apply_bf16(const bf16* u, const bf16* kx, const bf16* ky, const bf16* m,
                      const float* bias, bf16* out, int b, int n, int h, int w, int c, int o,
                      const Plan& p, cudaStream_t stream) {
  cudaError_t e = prepare(fab_apply_bf16<MT, KF>, p.apply_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + kTL - 1) / kTL, (o + p.oc - 1) / p.oc, b);
  fab_apply_bf16<MT, KF><<<grid, kTcThreads, p.apply_bytes, stream>>>(u, kx, ky, m, bias, out, n,
                                                                    h, w, c, o, p);
  return cudaGetLastError();
}

// The block's mean inputs (all null: mean_c from u alone) and its scratch.
struct MeanFrom {
  const bf16* x;
  const float *coef, *sx, *sy;
  float* mean;  // [b, n, c]
};

template <int KF>
int launch_bf16_kf(const bf16* u, const bf16* kx, const bf16* ky, const bf16* w_in,
                   const float* w1, const float* mean_b, bf16* m, float* bias, bf16* out, int b,
                   int n, int h, int w, int c, int d, int o, float eps, const Plan& p,
                   cudaStream_t stream) {
  cudaError_t e = prepare(fab_stats_bf16<KF>, p.stats_bytes);
  if (e != cudaSuccess) return e;
  fab_stats_bf16<KF><<<dim3(n, b), kTcThreads, p.stats_bytes, stream>>>(
      u, kx, ky, w_in, w1, mean_b, m, bias, n, h, w, c, d, o, eps, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
#define LNS_APPLY(MT) \
  launch_apply_bf16<MT, KF>(u, kx, ky, m, bias, out, b, n, h, w, c, o, p, stream)
  switch (p.hp / 16) {
    case 1: return LNS_APPLY(1);
    case 2: return LNS_APPLY(2);
    case 3: return LNS_APPLY(3);
    case 4: return LNS_APPLY(4);
    case 5: return LNS_APPLY(5);
    case 6: return LNS_APPLY(6);
    case 7: return LNS_APPLY(7);
    default: return LNS_APPLY(8);
  }
#undef LNS_APPLY
}

int launch_bf16(const bf16* u, const bf16* kx, const bf16* ky, const bf16* w_in, const float* w1,
                const MeanFrom& mf, bf16* m, float* bias, bf16* out, int b, int n, int h, int w,
                int c, int d, int o, float eps, cudaStream_t stream) {
  if (bf16_limit(h, w, c, d, o)) return cudaErrorInvalidValue;
  if (!mf.x != !mf.coef || !mf.x != !mf.sx || !mf.x != !mf.sy || !mf.x != !mf.mean)
    return cudaErrorInvalidValue;
  if (mf.x) {
    const int bytes = block_mean_smem(n, h, w, c);
    cudaError_t e = lns::allow_smem(fab_block_mean_bf16, bytes);
    if (e != cudaSuccess) return e;
    fab_block_mean_bf16<<<dim3(b, (n + kHC - 1) / kHC), kMeanThreads, bytes, stream>>>(
        mf.x, mf.coef, mf.sx, mf.sy, mf.mean, n, h, w, c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const Plan p = plan_for(h, w, c, d, o);
  if (w > h) {  // the transposed field: k_x applied first
    std::swap(h, w);
    std::swap(kx, ky);
  }
  return p.wp > 64 ? launch_bf16_kf<8>(u, kx, ky, w_in, w1, mf.mean, m, bias, out, b, n, h, w, c,
                                       d, o, eps, p, stream)
                   : launch_bf16_kf<4>(u, kx, ky, w_in, w1, mf.mean, m, bias, out, b, n, h, w, c,
                                       d, o, eps, p, stream);
}

}  // namespace

// nullptr when the bf16 kernels take this shape, else the limit it breaks
extern "C" const char* lns_fab_core_bf16_limit(int h, int w, int c, int d, int o) {
  return bf16_limit(h, w, c, d, o);
}

// x, coef, sx, sy: the block's mean inputs, mean_ws their [b, n, c] f32
// scratch (bf16 only; all null for mean_c from u alone).
extern "C" int lns_fab_core(int dtype, const void* u, const void* kx, const void* ky,
                            const void* w_in, const void* w_o1, const void* x, const void* coef,
                            const void* sx, const void* sy, void* mean_ws, void* m, void* bias,
                            void* out,
                            int b, int n, int h, int w, int c, int d, int o, float eps,
                            void* stream) {
  const float* w1 = static_cast<const float*>(w_o1);
  float* bf = static_cast<float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (x || coef || sx || sy || mean_ws) return cudaErrorInvalidValue;
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
                       static_cast<bf16*>(m), bf, static_cast<bf16*>(out), b, n, h, w, c, d, o,
                       eps, st);
  return cudaErrorInvalidValue;
}

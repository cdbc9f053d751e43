// Head-major axial apply, with an optional InstanceNorm or its statistics: one
// source for two TPU kernels.
//
// Replaces lns_tpu/pallas_kernels/axial_fused.py: fab_axial_in_fused
// (_fab_kernel) and lns_tpu/pallas_kernels/axial_attention.py:
// axial_kernel_apply_headmajor (_axial_kernel). Shapes (row-major, G = samples
// x heads):
//   kx [G, H, H]   ky [G, W, W]   phi [G, H, W, d]   ->   out [G, H, W, d]   (all T)
// Per g:  out[i, l, :] = sum_m ky[l, m] sum_j kx[i, j] phi[j, m, :]
// with each apply summed in f32 and rounded to T, as both TPU kernels round:
// fab_axial_in_fused applies rows (kx) first, axial_kernel_apply_headmajor
// columns (ky) first (kRowsFirst). After a rows-first apply, kMode:
//   kNorm   each d channel normalised over (H, W) (InstanceNorm, as the TPU
//           kernel): f32 statistics, two-pass for f32; for bf16 / f16 the
//           mean of the squares rounded to T, minus the squared mean,
//           clamped at 0; then (y - mean) * inv in T arithmetic;
//   kStats  out un-normalised, plus f32 sums per (g, d) of y and of the f32
//           square of the rounded y into stats [G, d, 2] (the d-space FAB
//           core folds the norm into its out-projection from these, as
//           FABlock2D._batched_core does).
//
// What bounds it on an H100: bytes. At the NS2d encoder's FAB (16x16, d 64,
// bf16) the two applies are 2 (H + W) = 64 FLOP per element against 4 bytes
// moved (read once, written once): 16 FLOP per byte, far under the card's
// bf16 ridge of ~295. The work is to keep loads in flight and take the
// arithmetic off the critical path.
//
// Design, bf16 / f16 (axial_tc). One block of 8 warps owns a (g, tile of dt
// channels) and keeps the whole zero-padded H x W plane of those channels
// in shared memory as one slab [hp][wp][ldd] (sides padded to 16, rows of 8
// channels, odd multiples of 16 bytes apart: conflict-free ldmatrix). The
// slab arrives as 16-byte cp.async copies; kx and ky sit beside it, padded
// with zeros. Both applies run on tensor cores (mma.sync m16n8k16, f32
// accumulators, ldmatrix / ldmatrix.trans operands) and work in place:
//   rows     kx [hp x hp] . slab [hp x (w dt)], a warp per 16 columns (pixel,
//            channel), all hp rows held in registers, then written back;
//   columns  per row i: ky [wp x wp] . slab_i [wp x dt], a warp per (row,
//            16 channels) (8 when dt = 8), written back the same way;
// each rounded to T where the TPU kernel rounds. The norm's sums come from
// the rounded values in registers: warp shuffles, then per-warp partials
// added in a fixed order (bitwise repeatable, no atomics). The store reads
// the slab as 16-byte vectors, normalises them in registers (kNorm) and
// writes 16-byte vectors. dt in {8, 16, 32, 64} (lns_axial_plan); channels
// past d are zero-filled and not stored, so any d is taken (d not a
// multiple of 8 loads and stores element by element).
//
// f32 (axial_f32) keeps CUDA-core FMAs: a (g, d-tile) block holds two slabs
// of dt channels (any divisor of d), apply A -> B -> A. f32 has no
// tensor-core form at the TPU kernel's precision.
//
// Limits, stated once in axial_limit: bf16 / f16 sides up to 128 and a
// block of dt = 8 within 227 KB of shared memory; f32 a plane of one
// channel (two slabs) within it.

#include <algorithm>
#include <cstdio>

#include "common.cuh"
#include "mma.cuh"

namespace {

using lns::cvt;
using lns::ld;
using lns::rnd;

enum Mode { kPlain = 0, kNorm = 1, kStats = 2 };

// ---- f32: CUDA-core FMAs --------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRT = 4;  // outputs along the applied axis per thread

// dst[a, f, :] = sum_k K[a, k] src[k, f, :] over the slab, where the applied
// axis has length L (K is [L, L]) and stride sa, the other axis length F and
// stride sf, and the dt channels are contiguous (stride 1).
__device__ void apply_axis(const float* __restrict__ K, const float* __restrict__ src,
                           float* __restrict__ dst, int L, int F, int sa, int sf, int dt) {
  const int a_tiles = (L + kRT - 1) / kRT;
  const int items = a_tiles * F * dt;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int dd = e % dt, f = (e / dt) % F, a0 = (e / (dt * F)) * kRT;
    const float* sp = src + f * sf + dd;
    float acc[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) acc[r] = 0.f;
    for (int k = 0; k < L; ++k) {
      const float v = sp[k * sa];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
        if (a0 + r < L) acc[r] = fmaf(K[(a0 + r) * L + k], v, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (a0 + r < L) dst[(a0 + r) * sa + f * sf + dd] = acc[r];
  }
}

size_t f32_bytes(int h, int w, int dt) {
  return sizeof(float) * (static_cast<size_t>(h) * h + w * w + 2 * kThreads + 2 * dt +
                          2 * static_cast<size_t>(h) * w * dt);
}

// the largest divisor dt of d (at most one per thread) whose block fits in
// half the shared memory (two blocks per SM), else in all of it; 0: none
int f32_dt(int h, int w, int d) {
  for (size_t budget : {lns::kMaxDynamicSmem / 2, lns::kMaxDynamicSmem})
    for (int dt = std::min(d, kThreads); dt > 0; --dt)
      if (d % dt == 0 && f32_bytes(h, w, dt) <= budget) return dt;
  return 0;
}

template <bool kRowsFirst, int kMode>
__global__ void __launch_bounds__(kThreads)
axial_f32(const float* __restrict__ kx, const float* __restrict__ ky,
          const float* __restrict__ phi, float* __restrict__ out, float* __restrict__ stats,
          int tiles, int h, int w, int d, int ps, int dt, float eps) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x, tid = threadIdx.x, hw = h * w;
  float* kx_s = reinterpret_cast<float*>(smem4);  // [h, h]
  float* ky_s = kx_s + h * h;                     // [w, w]
  float* red_a = ky_s + w * w;                    // [nt]
  float* red_b = red_a + nt;                      // [nt]
  float* mean_s = red_b + nt;                     // [dt]
  float* inv_s = mean_s + dt;                     // [dt]
  float* slab_a = inv_s + dt;                     // [h, w, dt]
  float* slab_b = slab_a + static_cast<size_t>(hw) * dt;

  const size_t g = blockIdx.x / tiles;
  const int t0 = blockIdx.x % tiles * dt;
  for (int i = tid; i < h * h; i += nt) kx_s[i] = kx[g * h * h + i];
  for (int i = tid; i < w * w; i += nt) ky_s[i] = ky[g * w * w + i];
  const size_t base = g / (ps / d) * hw * ps + g % (ps / d) * d + t0;  // see axial_tc
  const float* src = phi + base;
  for (int e = tid; e < hw * dt; e += nt) slab_a[e] = src[static_cast<size_t>(e / dt) * ps + e % dt];
  __syncthreads();
  // rows: contract the h axis (stride w * dt); columns: the w axis (stride dt)
  if (kRowsFirst) {
    apply_axis(kx_s, slab_a, slab_b, h, w, w * dt, dt, dt);
    __syncthreads();
    apply_axis(ky_s, slab_b, slab_a, w, h, dt, w * dt, dt);
  } else {
    apply_axis(ky_s, slab_a, slab_b, w, h, dt, w * dt, dt);
    __syncthreads();
    apply_axis(kx_s, slab_b, slab_a, h, w, w * dt, dt, dt);
  }
  __syncthreads();

  float* dst = out + base;
  if (kMode != kPlain) {
    // per channel dd: `parts` threads each sum a strided share of the pixels
    const int parts = nt / dt, dd = tid % dt, p = tid / dt;
    const float inv_n = 1.f / static_cast<float>(hw);
    if (p < parts) {
      float s = 0.f, s2 = 0.f;
      for (int px = p; px < hw; px += parts) {
        const float v = slab_a[px * dt + dd];
        s += v;
        s2 += v * v;
      }
      red_a[tid] = s;
      red_b[tid] = s2;
    }
    __syncthreads();
    if (tid < dt) {
      float a = 0.f, b = 0.f;
      for (int q = 0; q < parts; ++q) {
        a += red_a[q * dt + tid];
        b += red_b[q * dt + tid];
      }
      if (kMode == kStats) {
        stats[(g * d + t0 + tid) * 2] = a;
        stats[(g * d + t0 + tid) * 2 + 1] = b;
      }
      mean_s[tid] = a * inv_n;
    }
    __syncthreads();
    if (kMode == kNorm) {  // two-pass variance: sum of squares about the mean
      if (p < parts) {
        const float m = mean_s[dd];
        float c2 = 0.f;
        for (int px = p; px < hw; px += parts) {
          const float v = slab_a[px * dt + dd] - m;
          c2 = fmaf(v, v, c2);
        }
        red_b[tid] = c2;
      }
      __syncthreads();
      if (tid < dt) {
        float b = 0.f;
        for (int q = 0; q < parts; ++q) b += red_b[q * dt + tid];
        inv_s[tid] = rsqrtf(b * inv_n + eps);
      }
      __syncthreads();
      for (int e = tid; e < hw * dt; e += nt) {
        const int c = e % dt;
        dst[static_cast<size_t>(e / dt) * ps + c] = (slab_a[e] - mean_s[c]) * inv_s[c];
      }
      return;
    }
  }
  for (int e = tid; e < hw * dt; e += nt) dst[static_cast<size_t>(e / dt) * ps + e % dt] = slab_a[e];
}

// ---- bf16 / f16: tensor cores ----------------------------------------------

constexpr int kTcThreads = 256, kTcWarps = kTcThreads / 32;
constexpr int kMaxSide = 128, kMaxTiles = kMaxSide / 16;  // m16 tiles of a side
constexpr int kTileChoices[] = {64, 32, 16, 8};           // dt, largest first

int round16(int v) { return (v + 15) / 16 * 16; }

// Shared-memory layout of axial_tc, in T elements: kx [hp][ldk] | ky [wp][ldw]
// | slab [hp][rs] (pixel (j, m), channel dd at j rs + m ldd + dd), then f32
// partial sums [warps][2][dt] and mean, inv [2][dt]. Every row stride is an
// odd multiple of 16 bytes and every region starts on a 16-byte boundary.
struct TcPlan {
  int hp, wp, dt, ldd, rs, ldk, ldw;
  int off_ky, off_slab, bytes;
};

TcPlan tc_plan(int h, int w, int dt) {
  TcPlan p;
  p.hp = round16(h);
  p.wp = round16(w);
  p.dt = dt;
  p.ldd = dt == 8 ? 8 : dt + 8;
  p.rs = p.wp * p.ldd + 8;
  p.ldk = p.hp + 8;
  p.ldw = p.wp + 8;
  p.off_ky = p.hp * p.ldk;
  p.off_slab = p.off_ky + p.wp * p.ldw;
  p.bytes = 2 * (p.off_slab + p.hp * p.rs) + 4 * (2 * kTcWarps * dt + 2 * dt);
  return p;
}

// The kernels' limits, stated once: nullptr when they take the shape, else
// the limit it breaks (for the launcher, and the wrapper's message).
const char* axial_limit(int dtype, int h, int w, int d) {
  static thread_local char msg[160];
  const int limit = static_cast<int>(lns::kMaxDynamicSmem);
  if (h < 1 || w < 1 || d < 1) {
    snprintf(msg, sizeof msg, "h, w, d >= 1, got %dx%d d%d", h, w, d);
  } else if (dtype == 0) {
    if (f32_dt(h, w, d)) return nullptr;
    snprintf(msg, sizeof msg, "shared memory per block within %d bytes, needs %zu (an f32 "
             "%dx%d plane, two slabs of one channel)", limit, f32_bytes(h, w, 1), h, w);
  } else if (h > kMaxSide || w > kMaxSide) {
    snprintf(msg, sizeof msg, "h, w in [1, %d], got %dx%d", kMaxSide, h, w);
  } else {
    const int need = tc_plan(h, w, 8).bytes;
    if (need <= limit) return nullptr;
    snprintf(msg, sizeof msg, "shared memory per block within %d bytes, needs %d (a %dx%d "
             "plane of 8 channels)", limit, need, h, w);
  }
  return msg;
}

// dt for a 16-bit shape: `want` when it is a choice that fits, else (want 0)
// the largest choice up to d rounded up to a power of two (at least 8) whose
// block fits twice on an SM, else the largest that fits once; 0: none.
int tc_dt(int h, int w, int d, int want) {
  int cap = 8;
  while (cap < d && cap < 64) cap *= 2;
  const int limit = static_cast<int>(lns::kMaxDynamicSmem);
  if (want) {
    for (int dt : kTileChoices)
      if (dt == want && tc_plan(h, w, dt).bytes <= limit) return dt;
    return 0;
  }
  for (int budget : {limit / 2 - 1024, limit})
    for (int dt : kTileChoices)
      if (dt <= cap && tc_plan(h, w, dt).bytes <= budget) return dt;
  return 0;
}

// slab[i][n] = rnd_T(sum_j kx[i][j] slab[j][n]) for every column n = (pixel m
// < w, channel) of the slab, in place: a warp owns 16 columns and holds all
// hp rows of them in registers until its last read of them.
template <typename T>
__device__ __forceinline__ void apply_rows(const T* kx_s, T* slab, const TcPlan& p, int w) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int mts = p.hp / 16, chunks = (w * p.dt + 15) / 16;
  for (int c = warp; c < chunks; c += kTcWarps) {
    const int n0 = 16 * c / p.dt * p.ldd + 16 * c % p.dt;  // dt = 8: two pixels
    float acc[kMaxTiles][2][4] = {};
    for (int ks = 0; ks < mts; ++ks) {
      uint32_t bfr[4];
      lns::ldsm_x4_trans(bfr, slab + lns::b_addr(lane, ks * 16, n0, p.rs));
#pragma unroll
      for (int mt = 0; mt < kMaxTiles; ++mt)
        if (mt < mts) {
          uint32_t af[4];
          lns::ldsm_x4(af, kx_s + lns::a_addr(lane, mt * 16, ks * 16, p.ldk));
          lns::mma16<T>(acc[mt][0], af, bfr[0], bfr[1]);
          lns::mma16<T>(acc[mt][1], af, bfr[2], bfr[3]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < kMaxTiles; ++mt)
      if (mt < mts)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          T* r = slab + (mt * 16 + g) * p.rs + n0 + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(r) = lns::pack16<T>(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<uint32_t*>(r + 8 * p.rs) =
              lns::pack16<T>(acc[mt][nt][2], acc[mt][nt][3]);
        }
  }
}

// For each row i < h: slab_i[l][:] = rnd_T(sum_m ky[l][m] slab_i[m][:]), in
// place: a warp owns (row, 16 channels; 8 when dt = 8) and holds all wp
// outputs in registers. A warp's channels are the same in every task (8 is a
// multiple of the tasks per row), so with kMode != kPlain it sums the rounded
// outputs per channel into s and their squares into s2 (rounded to T for
// kNorm, as the TPU kernel; in f32 for kStats, as _batched_core): lane (g, t)
// holds channels nt 8 + 2 t + e of its 16.
template <typename T, int kMode>
__device__ __forceinline__ void apply_cols(const T* ky_s, T* slab, const TcPlan& p, int h,
                                           float (&s)[2][2], float (&s2)[2][2]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int mts = p.wp / 16, nq = p.dt == 8 ? 1 : p.dt / 16, nn = p.dt == 8 ? 1 : 2;
  for (int task = warp; task < h * nq; task += kTcWarps) {
    T* row = slab + task / nq * p.rs + task % nq * 16;
    float acc[kMaxTiles][2][4] = {};
    for (int ks = 0; ks < mts; ++ks) {
      uint32_t bfr[4];
      if (nn == 2) {
        lns::ldsm_x4_trans(bfr, row + lns::b_addr(lane, ks * 16, 0, p.ldd));
      } else {
        uint32_t b2[2];
        lns::ldsm_x2_trans(b2, row + (ks * 16 + (lane & 15)) * p.ldd);
        bfr[0] = b2[0];
        bfr[1] = b2[1];
      }
#pragma unroll
      for (int mt = 0; mt < kMaxTiles; ++mt)
        if (mt < mts) {
          uint32_t af[4];
          lns::ldsm_x4(af, ky_s + lns::a_addr(lane, mt * 16, ks * 16, p.ldw));
          lns::mma16<T>(acc[mt][0], af, bfr[0], bfr[1]);
          if (nn == 2) lns::mma16<T>(acc[mt][1], af, bfr[2], bfr[3]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < kMaxTiles; ++mt)
      if (mt < mts)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          if (nt < nn) {
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = rnd<T>(acc[mt][nt][k]);
            T* r = row + (mt * 16 + g) * p.ldd + nt * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(r) = lns::pack16<T>(v[0], v[1]);
            *reinterpret_cast<uint32_t*>(r + 8 * p.ldd) = lns::pack16<T>(v[2], v[3]);
            if (kMode != kPlain)
#pragma unroll
              for (int k = 0; k < 4; ++k) {  // rows l >= w are zero and add nothing
                s[nt][k % 2] += v[k];
                s2[nt][k % 2] += kMode == kNorm ? rnd<T>(v[k] * v[k]) : v[k] * v[k];
              }
          }
  }
}

template <typename T, bool kRowsFirst, int kMode>
__global__ void __launch_bounds__(kTcThreads)
axial_tc(const T* __restrict__ kx, const T* __restrict__ ky, const T* __restrict__ phi,
         T* __restrict__ out, float* __restrict__ stats, int tiles, int h, int w, int d, int ps,
         float eps, TcPlan p) {
  extern __shared__ uint4 smem_ax[];
  T* kx_s = reinterpret_cast<T*>(smem_ax);
  T* ky_s = kx_s + p.off_ky;
  T* slab = kx_s + p.off_slab;
  float* part = reinterpret_cast<float*>(slab + p.hp * p.rs);  // [warps][2][dt]
  float* mean_s = part + 2 * kTcWarps * p.dt;                  // [dt]
  float* inv_s = mean_s + p.dt;                                // [dt]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t g = blockIdx.x / tiles;
  const int d0 = blockIdx.x % tiles * p.dt, dv = min(p.dt, d - d0);  // valid channels
  const size_t hw = static_cast<size_t>(h) * w;
  // phi and out: pixel stride ps, ps / d heads interleaved per pixel ([B, H,
  // W, n, d]; ps = d: head-major [G, H, W, d])
  const size_t base = g / (ps / d) * hw * ps + g % (ps / d) * d + d0;
  const T* src = phi + base;
  T* dst = out + base;
  const T zero = cvt<T>(0.f);
  // the slab, zero outside (h, w, dv): 16-byte copies of 8 channels when rows
  // of 8 start on 16-byte boundaries (8 | d), else element by element
  const bool vec = d % 8 == 0;
  const int pcs = p.dt / 8, lg = __ffs(pcs) - 1;  // pieces of 8 channels per pixel
  if (vec) {
    for (int e = tid; e < p.hp * p.wp * pcs; e += kTcThreads) {
      const int q = e & (pcs - 1), px = e >> lg, m = px % p.wp, j = px / p.wp;
      const bool valid = j < h && m < w && 8 * q < dv;
      lns::cp_async16(slab + j * p.rs + m * p.ldd + 8 * q,
                      valid ? src + (static_cast<size_t>(j) * w + m) * ps + 8 * q : src, valid);
    }
    lns::cp_async_commit();
  } else {
    for (int e = tid; e < p.hp * p.wp * p.dt; e += kTcThreads) {
      const int dd = e % p.dt, px = e / p.dt, m = px % p.wp, j = px / p.wp;
      slab[j * p.rs + m * p.ldd + dd] =
          j < h && m < w && dd < dv ? src[(static_cast<size_t>(j) * w + m) * ps + dd] : zero;
    }
  }
  for (int e = tid; e < p.hp * p.hp; e += kTcThreads) {
    const int i = e / p.hp, j = e % p.hp;
    kx_s[i * p.ldk + j] = i < h && j < h ? kx[(g * h + i) * h + j] : zero;
  }
  for (int e = tid; e < p.wp * p.wp; e += kTcThreads) {
    const int l = e / p.wp, m = e % p.wp;
    ky_s[l * p.ldw + m] = l < w && m < w ? ky[(g * w + l) * w + m] : zero;
  }
  lns::cp_async_wait<0>();
  __syncthreads();

  float s[2][2] = {}, s2[2][2] = {};
  if (kRowsFirst) {
    apply_rows<T>(kx_s, slab, p, w);
    __syncthreads();
    apply_cols<T, kMode>(ky_s, slab, p, h, s, s2);
  } else {
    apply_cols<T, kPlain>(ky_s, slab, p, h, s, s2);
    __syncthreads();
    apply_rows<T>(kx_s, slab, p, w);
  }
  if (kMode != kPlain) {  // per-warp sums over its rows l (lanes g), then over warps
#pragma unroll
    for (int off = 4; off < 32; off *= 2)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] += __shfl_xor_sync(0xffffffffu, s[nt][e], off);
          s2[nt][e] += __shfl_xor_sync(0xffffffffu, s2[nt][e], off);
        }
    const int nq = p.dt == 8 ? 1 : p.dt / 16, nn = p.dt == 8 ? 1 : 2;
    if (lane < 4)
      for (int nt = 0; nt < nn; ++nt)
        for (int e = 0; e < 2; ++e) {
          const int dd = warp % nq * 16 + nt * 8 + 2 * lane + e;
          part[(warp * 2) * p.dt + dd] = s[nt][e];
          part[(warp * 2 + 1) * p.dt + dd] = s2[nt][e];
        }
  }
  __syncthreads();
  if (kMode != kPlain && tid < p.dt) {
    const int nq = p.dt == 8 ? 1 : p.dt / 16;
    float a = 0.f, b = 0.f;
    for (int wr = tid / 16 % nq; wr < kTcWarps; wr += nq) {  // the warps of this channel, in order
      a += part[(wr * 2) * p.dt + tid];
      b += part[(wr * 2 + 1) * p.dt + tid];
    }
    if (kMode == kStats && tid < dv) {
      stats[(g * d + d0 + tid) * 2] = a;
      stats[(g * d + d0 + tid) * 2 + 1] = b;
    }
    if (kMode == kNorm) {
      const float inv_n = 1.f / static_cast<float>(hw), mean = a * inv_n;
      mean_s[tid] = rnd<T>(mean);
      inv_s[tid] = rnd<T>(rsqrtf(fmaxf(b * inv_n - mean * mean, 0.f) + eps));
    }
  }
  if (kMode == kNorm) __syncthreads();

  // store (normalised in registers for kNorm): 16-byte vectors when 8 | d
  if (vec) {
    for (int e = tid; e < static_cast<int>(hw) * pcs; e += kTcThreads) {
      const int q = e & (pcs - 1), px = e >> lg;
      if (8 * q >= dv) continue;
      uint4 v = *reinterpret_cast<const uint4*>(slab + px / w * p.rs + px % w * p.ldd + 8 * q);
      if (kMode == kNorm) {
        T* vb = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int dd = 8 * q + k;
          vb[k] = cvt<T>(rnd<T>(ld(vb[k]) - mean_s[dd]) * inv_s[dd]);
        }
      }
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(px) * ps + 8 * q) = v;
    }
  } else {
    for (int e = tid; e < static_cast<int>(hw) * p.dt; e += kTcThreads) {
      const int dd = e % p.dt, px = e / p.dt;
      if (dd >= dv) continue;
      float y = ld(slab[px / w * p.rs + px % w * p.ldd + dd]);
      if (kMode == kNorm) y = rnd<T>(y - mean_s[dd]) * inv_s[dd];
      dst[static_cast<size_t>(px) * ps + dd] = cvt<T>(y);
    }
  }
}

// ---- launch ---------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  cudaError_t e = lns::allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// prepare(kernel, bytes) only where the kernel's shared-memory limit on this
// device is below `bytes` (`done`: the kernel's own table of the limit set per
// device), so the limit only rises and each launch and plan query of the
// kernel goes through here: the attribute calls cost the host more than the
// launch itself at the small shapes
constexpr int kDevices = 64;
template <typename K>
cudaError_t prepare_once(K kernel, size_t bytes, size_t (&done)[kDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && done[dev] >= bytes) return cudaSuccess;
  e = prepare(kernel, bytes);
  if (e == cudaSuccess && dev < kDevices) done[dev] = bytes;
  return e;
}

template <typename T, bool kRowsFirst, int kMode>
cudaError_t prepare_tc(size_t bytes) {
  static size_t done[kDevices] = {};
  return prepare_once(axial_tc<T, kRowsFirst, kMode>, bytes, done);
}

template <bool kRowsFirst, int kMode>
cudaError_t prepare_f32(size_t bytes) {
  static size_t done[kDevices] = {};
  return prepare_once(axial_f32<kRowsFirst, kMode>, bytes, done);
}

template <typename T, bool kRowsFirst, int kMode>
int launch_tc(const void* kx, const void* ky, const void* phi, void* out, float* stats, int g,
              int h, int w, int d, int ps, int dt, float eps, cudaStream_t stream) {
  const TcPlan p = tc_plan(h, w, dt);
  auto kernel = axial_tc<T, kRowsFirst, kMode>;
  cudaError_t e = prepare_tc<T, kRowsFirst, kMode>(p.bytes);
  if (e != cudaSuccess) return e;
  const int tiles = (d + dt - 1) / dt;
  kernel<<<static_cast<unsigned>(g) * tiles, kTcThreads, p.bytes, stream>>>(
      static_cast<const T*>(kx), static_cast<const T*>(ky), static_cast<const T*>(phi),
      static_cast<T*>(out), stats, tiles, h, w, d, ps, eps, p);
  return cudaGetLastError();
}

template <bool kRowsFirst, int kMode>
int launch_f32(const void* kx, const void* ky, const void* phi, void* out, float* stats, int g,
               int h, int w, int d, int ps, int dt, float eps, cudaStream_t stream) {
  const size_t smem = f32_bytes(h, w, dt);
  auto kernel = axial_f32<kRowsFirst, kMode>;
  cudaError_t e = prepare_f32<kRowsFirst, kMode>(smem);
  if (e != cudaSuccess) return e;
  const int tiles = d / dt;
  kernel<<<static_cast<unsigned>(g) * tiles, kThreads, smem, stream>>>(
      static_cast<const float*>(kx), static_cast<const float*>(ky),
      static_cast<const float*>(phi), static_cast<float*>(out), stats, tiles, h, w, d, ps, dt, eps);
  return cudaGetLastError();
}

template <typename T>
int dispatch_tc(int rows_first, int mode, const void* kx, const void* ky, const void* phi,
                void* out, float* stats, int g, int h, int w, int d, int ps, int dt,
                float eps, cudaStream_t st) {
  if (!rows_first) {
    if (mode != kPlain) return cudaErrorInvalidValue;  // no TPU kernel normalises after that
    return launch_tc<T, false, kPlain>(kx, ky, phi, out, stats, g, h, w, d, ps, dt, eps, st);
  }
  if (mode == kNorm) return launch_tc<T, true, kNorm>(kx, ky, phi, out, stats, g, h, w, d, ps, dt, eps, st);
  if (mode == kStats) return launch_tc<T, true, kStats>(kx, ky, phi, out, stats, g, h, w, d, ps, dt, eps, st);
  return launch_tc<T, true, kPlain>(kx, ky, phi, out, stats, g, h, w, d, ps, dt, eps, st);
}

int dispatch_f32(int rows_first, int mode, const void* kx, const void* ky, const void* phi,
                 void* out, float* stats, int g, int h, int w, int d, int ps, int dt,
                 float eps, cudaStream_t st) {
  if (!rows_first) {
    if (mode != kPlain) return cudaErrorInvalidValue;
    return launch_f32<false, kPlain>(kx, ky, phi, out, stats, g, h, w, d, ps, dt, eps, st);
  }
  if (mode == kNorm) return launch_f32<true, kNorm>(kx, ky, phi, out, stats, g, h, w, d, ps, dt, eps, st);
  if (mode == kStats) return launch_f32<true, kStats>(kx, ky, phi, out, stats, g, h, w, d, ps, dt, eps, st);
  return launch_f32<true, kPlain>(kx, ky, phi, out, stats, g, h, w, d, ps, dt, eps, st);
}

// the d-tile for a shape (`want` 0: the rule; else `want` itself if the
// kernel takes it), 0 when there is none
int plan_dt(int dtype, int h, int w, int d, int want) {
  if (axial_limit(dtype, h, w, d)) return 0;
  if (dtype == 0) {
    if (!want) return f32_dt(h, w, d);
    return want > 0 && want <= kThreads && d % want == 0 &&
                   f32_bytes(h, w, want) <= lns::kMaxDynamicSmem ? want : 0;
  }
  return tc_dt(h, w, d, want);
}

}  // namespace

// nullptr when the kernels take this shape (dtype 0 f32, 1 bf16, 2 f16),
// else the limit it breaks
extern "C" const char* lns_axial_limit(int dtype, int h, int w, int d) {
  return axial_limit(dtype, h, w, d);
}

// The launch for a shape: res = {d-tile, tiles, blocks, shared memory bytes
// per block, blocks resident per SM}; `want` 0 takes the rule's d-tile.
extern "C" int lns_axial_plan(int dtype, int g, int h, int w, int d, int want, int* res) {
  const int dt = plan_dt(dtype, h, w, d, want);
  if (!dt) return cudaErrorInvalidValue;
  const int tiles = (d + dt - 1) / dt;
  int per_sm = 0;
  cudaError_t e;
  if (dtype == 0) {
    const size_t bytes = f32_bytes(h, w, dt);
    e = prepare_f32<true, kNorm>(bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, axial_f32<true, kNorm>, kThreads,
                                                        bytes);
    res[3] = static_cast<int>(bytes);
  } else {
    const TcPlan p = tc_plan(h, w, dt);
    e = prepare_tc<__nv_bfloat16, true, kNorm>(p.bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, axial_tc<__nv_bfloat16, true, kNorm>, kTcThreads, p.bytes);
    res[3] = p.bytes;
  }
  res[0] = dt;
  res[1] = tiles;
  res[2] = g * tiles;
  res[4] = per_sm;
  return e;
}

// mode 0: the applies; 1: + InstanceNorm; 2: + stats [G, d, 2] (rows first
// only). phi and out have pixel stride ps: d for head-major [G, H, W, d],
// n d for [B, H, W, n, d] (G = B n). dt 0 takes the rule's d-tile.
extern "C" int lns_axial_apply(int dtype, int rows_first, int mode, const void* kx,
                               const void* ky, const void* phi, void* out, void* stats, int g,
                               int h, int w, int d, int ps, int dt, float eps, void* stream) {
  dt = plan_dt(dtype, h, w, d, dt);
  if (!dt || g < 1 || ps < d || ps % d || g % (ps / d) || (mode == kStats) != (stats != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(stats);
  if (dtype == 0)
    return dispatch_f32(rows_first, mode, kx, ky, phi, out, sf, g, h, w, d, ps, dt, eps, st);
  if (dtype == 1)
    return dispatch_tc<__nv_bfloat16>(rows_first, mode, kx, ky, phi, out, sf, g, h, w, d, ps, dt,
                                      eps, st);
  if (dtype == 2)
    return dispatch_tc<__half>(rows_first, mode, kx, ky, phi, out, sf, g, h, w, d, ps, dt, eps, st);
  return cudaErrorInvalidValue;
}

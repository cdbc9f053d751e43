// Head-major axial apply, with an optional InstanceNorm: one kernel for two
// TPU kernels.
//
// Replaces lns_tpu/pallas_kernels/axial_fused.py: fab_axial_in_fused
// (_fab_kernel) and lns_tpu/pallas_kernels/axial_attention.py:
// axial_kernel_apply_headmajor (_axial_kernel). Shapes (row-major, G = samples
// x heads):
//   kx [G, H, H]   ky [G, W, W]   phi [G, H, W, d]   ->   out [G, H, W, d]   (all T)
// Per g:  out[i, l, :] = sum_m ky[l, m] sum_j kx[i, j] phi[j, m, :]
// with each apply rounded to T, as both TPU kernels round: fab_axial_in_fused
// applies rows (kx) first, axial_kernel_apply_headmajor columns (ky) first
// (kRowsFirst). With kWithIn, each d channel is then normalised over (H, W)
// (InstanceNorm): f32 statistics, two-pass for f32 and E[x^2] - E[x]^2
// clamped at 0 for bf16, then (y - mean) * inv in T arithmetic.
//
// What bounds it on an H100: at the NS2d encoder's FAB (16x16, d 64, bf16) a
// (g, d-tile) slab is 32 KB and takes 2 x (H + W) FLOP per element, about 16
// FLOP per byte moved, near the CUDA cores' f32 ratio of ~20; the inner loops
// are bound by shared-memory loads (one slab value and kRT kernel values per
// kRT FMAs). Tensor cores are later work.
//
// Design. The TPU kernel packs heads block-diagonally and transposes whole
// slabs between the applies; both are MXU / Mosaic workarounds and are gone.
// On Hopper the applies and the norm are independent per d channel, so one
// block owns a (g, d-tile) and keeps the whole H x W plane of its dt channels
// in shared memory (two slabs in T: every stored value is one the TPU kernel
// rounds to T as well). The first apply writes slab B from slab A, the second
// A from B; the statistics are a reduction inside the block. No cross-block
// reduction, no atomics. The wrapper picks dt (a divisor of d) so that two
// blocks fit on an SM where possible.

#include "common.cuh"

namespace {

using lns::cvt;
using lns::ld;
using lns::rnd;

constexpr int kThreads = 256;
constexpr int kRT = 4;  // outputs along the applied axis per thread

// dst[a, f, :] = rnd_T(sum_k K[a, k] src[k, f, :]) over the slab, where the
// applied axis has length L (K is [L, L]) and stride sa, the other axis length
// F and stride sf, and the dt channels are contiguous (stride 1).
template <typename T>
__device__ void apply_axis(const float* __restrict__ K, const T* __restrict__ src,
                           T* __restrict__ dst, int L, int F, int sa, int sf, int dt) {
  const int a_tiles = (L + kRT - 1) / kRT;
  const int items = a_tiles * F * dt;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int dd = e % dt, f = (e / dt) % F, a0 = (e / (dt * F)) * kRT;
    const T* sp = src + f * sf + dd;
    float acc[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) acc[r] = 0.f;
    for (int k = 0; k < L; ++k) {
      const float v = ld(sp[k * sa]);
#pragma unroll
      for (int r = 0; r < kRT; ++r)
        if (a0 + r < L) acc[r] = fmaf(K[(a0 + r) * L + k], v, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (a0 + r < L) dst[(a0 + r) * sa + f * sf + dd] = cvt<T>(acc[r]);
  }
}

template <typename T, bool kRowsFirst, bool kWithIn>
__global__ void __launch_bounds__(kThreads)
axial_kernel(const T* __restrict__ kx, const T* __restrict__ ky, const T* __restrict__ phi,
             T* __restrict__ out, int h, int w, int d, int dt, float eps) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x, tid = threadIdx.x, hw = h * w;
  float* kx_s = reinterpret_cast<float*>(smem4);  // [h, h]
  float* ky_s = kx_s + h * h;                     // [w, w]
  float* red_a = ky_s + w * w;                    // [nt]
  float* red_b = red_a + nt;                      // [nt]
  float* mean_s = red_b + nt;                     // [dt]
  float* inv_s = mean_s + dt;                     // [dt]
  T* slab_a = reinterpret_cast<T*>(inv_s + dt);   // [h, w, dt]
  T* slab_b = slab_a + static_cast<size_t>(hw) * dt;

  const size_t g = blockIdx.y;
  const int t0 = blockIdx.x * dt;
  for (int i = tid; i < h * h; i += nt) kx_s[i] = ld(kx[g * h * h + i]);
  for (int i = tid; i < w * w; i += nt) ky_s[i] = ld(ky[g * w * w + i]);
  const T* src = phi + g * hw * d + t0;
  for (int e = tid; e < hw * dt; e += nt) slab_a[e] = src[static_cast<size_t>(e / dt) * d + e % dt];
  __syncthreads();
  // rows: contract the h axis (stride w * dt); columns: the w axis (stride dt)
  if (kRowsFirst) {
    apply_axis<T>(kx_s, slab_a, slab_b, h, w, w * dt, dt, dt);
    __syncthreads();
    apply_axis<T>(ky_s, slab_b, slab_a, w, h, dt, w * dt, dt);
  } else {
    apply_axis<T>(ky_s, slab_a, slab_b, w, h, dt, w * dt, dt);
    __syncthreads();
    apply_axis<T>(kx_s, slab_b, slab_a, h, w, w * dt, dt, dt);
  }
  __syncthreads();

  T* dst = out + g * hw * d + t0;
  if (kWithIn) {
    // per channel dd: `parts` threads each sum a strided share of the pixels
    const int parts = nt / dt, dd = tid % dt, p = tid / dt;
    constexpr bool f32 = sizeof(T) == 4;
    const float inv_n = 1.f / static_cast<float>(hw);
    float s = 0.f, s2 = 0.f;
    if (p < parts) {
      for (int px = p; px < hw; px += parts) {
        const float v = ld(slab_a[px * dt + dd]);
        s += v;
        s2 += rnd<T>(v * v);  // the TPU kernel squares in T, then sums in f32
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
      mean_s[tid] = a * inv_n;
      inv_s[tid] = fmaxf(b * inv_n - a * inv_n * (a * inv_n), 0.f);  // bf16 variance
    }
    __syncthreads();
    if (f32) {  // two-pass variance: sum of squares about the mean
      if (p < parts) {
        const float m = mean_s[dd];
        float c2 = 0.f;
        for (int px = p; px < hw; px += parts) {
          const float v = ld(slab_a[px * dt + dd]) - m;
          c2 = fmaf(v, v, c2);
        }
        red_b[tid] = c2;
      }
      __syncthreads();
      if (tid < dt) {
        float b = 0.f;
        for (int q = 0; q < parts; ++q) b += red_b[q * dt + tid];
        inv_s[tid] = b * inv_n;
      }
      __syncthreads();
    }
    if (tid < dt) inv_s[tid] = rsqrtf(inv_s[tid] + eps);
    __syncthreads();
    for (int e = tid; e < hw * dt; e += nt) {
      const int c = e % dt;
      const float y = rnd<T>(ld(slab_a[e]) - rnd<T>(mean_s[c]));
      dst[static_cast<size_t>(e / dt) * d + c] = cvt<T>(y * rnd<T>(inv_s[c]));
    }
  } else {
    for (int e = tid; e < hw * dt; e += nt) dst[static_cast<size_t>(e / dt) * d + e % dt] = slab_a[e];
  }
}

template <typename T, bool kRowsFirst, bool kWithIn>
int launch(const void* kx, const void* ky, const void* phi, void* out, int g, int h, int w,
           int d, int dt, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(h) * h + w * w + 2 * kThreads + 2 * dt) +
                      sizeof(T) * 2 * static_cast<size_t>(h) * w * dt;
  cudaError_t e = lns::allow_smem(axial_kernel<T, kRowsFirst, kWithIn>, smem);
  if (e != cudaSuccess) return e;
  axial_kernel<T, kRowsFirst, kWithIn><<<dim3(d / dt, g), kThreads, smem, stream>>>(
      static_cast<const T*>(kx), static_cast<const T*>(ky), static_cast<const T*>(phi),
      static_cast<T*>(out), h, w, d, dt, eps);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int rows_first, int with_in, const void* kx, const void* ky, const void* phi,
             void* out, int g, int h, int w, int d, int dt, float eps, cudaStream_t st) {
  if (rows_first && with_in) return launch<T, true, true>(kx, ky, phi, out, g, h, w, d, dt, eps, st);
  if (rows_first) return launch<T, true, false>(kx, ky, phi, out, g, h, w, d, dt, eps, st);
  if (!with_in) return launch<T, false, false>(kx, ky, phi, out, g, h, w, d, dt, eps, st);
  return cudaErrorInvalidValue;  // columns first with the norm: no TPU kernel does that
}

}  // namespace

extern "C" int lns_axial_apply(int dtype, int rows_first, int with_in, const void* kx,
                               const void* ky, const void* phi, void* out, int g, int h, int w,
                               int d, int dt, float eps, void* stream) {
  if (dt <= 0 || dt > kThreads || d % dt) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(rows_first, with_in, kx, ky, phi, out, g, h, w, d, dt, eps, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(rows_first, with_in, kx, ky, phi, out, g, h, w, d, dt, eps, st);
  return cudaErrorInvalidValue;
}

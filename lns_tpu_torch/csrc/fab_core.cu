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
// out = sum_heads (bb . m - bias).
//
// What bounds it on an H100: arithmetic (~270 FLOP per byte of u at
// 32x32, c = 64, 8 heads), done here as f32 FMAs on CUDA cores.
//
// Design. A sample's 32x32x64 bb is 256 KB in f32 and does not fit in a
// block's shared memory, so the TPU kernel's one program per sample becomes
// two passes, and bb is never written to device memory:
//   fab_stats_kernel  one block per (head, sample): walks bb in tiles of kTI
//                     rows (row apply from u in L2, column apply from shared),
//                     accumulates the Gram in shared memory, then writes m and
//                     bias for its head (f32 scratch, [b, n, c, o] / [b, n, o]).
//   fab_apply_kernel  one block per (tile of kTI rows, sample): for each head
//                     recomputes the tile of bb, multiplies by m and sums the
//                     heads in shared memory; writes its rows of out once.
// The head sum is a loop inside the block: no atomics, and the result does not
// depend on scheduling. All arithmetic is f32; inputs are read as T and the
// output is rounded to T once.

#include "common.cuh"

namespace {

using lns::cvt;
using lns::ld;

constexpr int kThreads = 256;
constexpr int kTI = 2;  // rows of bb per tile

// t[ii, m, cc] = sum_j kxr[ii, j] u[j, m, cc]; bb[ii, l, cc] = sum_m ky[l, m] t[ii, m, cc]
// for the kTI rows of a tile (rows >= `rows` come out zero). kxr, ky, t, bb in
// shared memory; u is the sample's [h, w, c] in device memory.
template <typename T>
__device__ void tile_bb(const T* __restrict__ u, const float* __restrict__ kxr,
                        const float* __restrict__ ky, float* __restrict__ t,
                        float* __restrict__ bb, int rows, int h, int w, int c) {
  const int wc = w * c;
  for (int e = threadIdx.x; e < wc; e += blockDim.x) {
    float acc[kTI];
#pragma unroll
    for (int ii = 0; ii < kTI; ++ii) acc[ii] = 0.f;
    for (int j = 0; j < h; ++j) {
      const float uv = ld(u[static_cast<size_t>(j) * wc + e]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fab_stats_kernel(const T* __restrict__ u, const T* __restrict__ kx, const T* __restrict__ ky,
                 const T* __restrict__ w_in, const float* __restrict__ w1,
                 float* __restrict__ m_out, float* __restrict__ bias_out, int n, int h, int w,
                 int c, int d, int o, float eps) {
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
  const T* us = u + static_cast<size_t>(s) * h * w * c;
  for (int i = tid; i < h * h; i += nt) kx_s[i] = ld(kx[sn * h * h + i]);
  for (int i = tid; i < w * w; i += nt) ky_s[i] = ld(ky[sn * w * w + i]);
  for (int i = tid; i < c * d; i += nt)
    win_s[i] = ld(w_in[(static_cast<size_t>(i / d) * n + hd) * d + i % d]);
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
      for (int m = 0; m < w; ++m) r = fmaf(sy[m], ld(us[(j * w + m) * c + cc]), r);
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
    tile_bb<T>(us, kxr_s, ky_s, t_s, bb_s, rows, h, w, c);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fab_apply_kernel(const T* __restrict__ u, const T* __restrict__ kx, const T* __restrict__ ky,
                 const float* __restrict__ m_in, const float* __restrict__ bias_in,
                 T* __restrict__ out, int n, int h, int w, int c, int o) {
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
  const T* us = u + static_cast<size_t>(s) * h * w * c;
  const int nacc = kTI * w * o;
  for (int i = tid; i < nacc; i += nt) acc_s[i] = 0.f;
  for (int i = tid; i < o; i += nt) bsum[i] = 0.f;
  for (int hd = 0; hd < n; ++hd) {
    const size_t sn = static_cast<size_t>(s) * n + hd;
    for (int i = tid; i < w * w; i += nt) ky_s[i] = ld(ky[sn * w * w + i]);
    for (int i = tid; i < kTI * h; i += nt) {
      const int ii = i / h;
      kxr_s[i] = ii < rows ? ld(kx[(sn * h + i0 + ii) * h + i % h]) : 0.f;
    }
    for (int i = tid; i < c * o; i += nt) m_s[i] = m_in[sn * c * o + i];
    for (int i = tid; i < o; i += nt) bsum[i] += bias_in[sn * o + i];
    __syncthreads();
    tile_bb<T>(us, kxr_s, ky_s, t_s, bb_s, rows, h, w, c);
    for (int e = tid; e < nacc; e += nt) {
      const int q = e / o, oo = e % o;
      const float* bp = bb_s + q * c;
      float acc = acc_s[e];
      for (int cc = 0; cc < c; ++cc) acc = fmaf(bp[cc], m_s[cc * o + oo], acc);
      acc_s[e] = acc;
    }
    __syncthreads();
  }
  T* os = out + (static_cast<size_t>(s) * h + i0) * w * o;
  for (int e = tid; e < rows * w * o; e += nt) os[e] = cvt<T>(acc_s[e] - bsum[e % o]);
}

template <typename T>
int launch(const void* u, const void* kx, const void* ky, const void* w_in, const float* w1,
           float* m, float* bias, void* out, int b, int n, int h, int w, int c, int d, int o,
           float eps, cudaStream_t stream) {
  const size_t stats_smem =
      sizeof(float) * (static_cast<size_t>(h) * h + w * w + c * d + c * c + 2 * kTI * w * c +
                       kTI * h + h + w + c + 2 * d);
  const size_t apply_smem =
      sizeof(float) * (static_cast<size_t>(w) * w + c * o + 2 * kTI * w * c + kTI * w * o +
                       kTI * h + o);
  cudaError_t e = lns::allow_smem(fab_stats_kernel<T>, stats_smem);
  if (e != cudaSuccess) return e;
  e = lns::allow_smem(fab_apply_kernel<T>, apply_smem);
  if (e != cudaSuccess) return e;
  const T* ut = static_cast<const T*>(u);
  const T* kxt = static_cast<const T*>(kx);
  const T* kyt = static_cast<const T*>(ky);
  fab_stats_kernel<T><<<dim3(n, b), kThreads, stats_smem, stream>>>(
      ut, kxt, kyt, static_cast<const T*>(w_in), w1, m, bias, n, h, w, c, d, o, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fab_apply_kernel<T><<<dim3((h + kTI - 1) / kTI, b), kThreads, apply_smem, stream>>>(
      ut, kxt, kyt, m, bias, static_cast<T*>(out), n, h, w, c, o);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lns_fab_core(int dtype, const void* u, const void* kx, const void* ky,
                            const void* w_in, const void* w_o1, void* m, void* bias, void* out,
                            int b, int n, int h, int w, int c, int d, int o, float eps,
                            void* stream) {
  const float* w1 = static_cast<const float*>(w_o1);
  float* mf = static_cast<float*>(m);
  float* bf = static_cast<float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(u, kx, ky, w_in, w1, mf, bf, out, b, n, h, w, c, d, o, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, kx, ky, w_in, w1, mf, bf, out, b, n, h, w, c, d, o, eps, st);
  return cudaErrorInvalidValue;
}

// The axial-apply pipeline's two kernels: a batched square-by-wide matrix
// product and the h <-> w swap of a head-major tensor.
//
// Replaces lns_tpu/pallas_kernels/axial_pipeline.py: bmm_blockdiag
// (_bmm_kernel) and transpose_hw (_transpose_kernel).
//
// bmm:  kb [BG, M, M] @ x [BG, M, N] -> out [BG, M, N]   (all T; f32 sums,
//       rounded to T once, as the TPU kernel's preferred_element_type=f32 dot).
//       kb is any matrix: the block-diagonal structure of the TPU caller's
//       operand is not used. What bounds it on an H100: FMAs (M = 128 gives
//       ~64 FLOP per byte of x in bf16), done here on CUDA cores in f32 from
//       64 x 64 output tiles with 16-deep slices of both operands in shared
//       memory, 4 x 4 outputs per thread. Tensor cores are later work.
// transpose_hw:  x [BN, H, W, row] -> out [BN, W, H, row], `row` bytes per
//       (h, w) moved unchanged. Pure data movement, bound by bytes: each
//       thread copies vector-sized pieces (16 bytes where the row and the
//       pointers allow), neighbouring threads on neighbouring addresses of an
//       output row. No shared memory is needed: a row of D elements is the
//       contiguous unit on both sides.

#include "common.cuh"

namespace {

using lns::cvt;
using lns::ld;

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bmm_kernel(const T* __restrict__ kb, const T* __restrict__ x, T* __restrict__ out, int m_dim,
           int n_dim) {
  __shared__ float a_s[kBK][kBM + 1];  // kb tile, transposed: a_s[k][m]
  __shared__ float b_s[kBK][kBN];      // x tile: b_s[k][n]
  const size_t bg = blockIdx.z;
  const T* a = kb + bg * m_dim * m_dim;
  const T* b = x + bg * m_dim * n_dim;
  T* c = out + bg * m_dim * n_dim;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < m_dim; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int mm = e / kBK, kk = e % kBK, gm = m0 + mm, gk = k0 + kk;
      a_s[kk][mm] = gm < m_dim && gk < m_dim ? ld(a[static_cast<size_t>(gm) * m_dim + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, nn = e % kBN, gk = k0 + kk, gn = n0 + nn;
      b_s[kk][nn] = gk < m_dim && gn < n_dim ? ld(b[static_cast<size_t>(gk) * n_dim + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < m_dim && gn < n_dim) c[static_cast<size_t>(gm) * n_dim + gn] = cvt<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_bmm(const void* kb, const void* x, void* out, int bg, int m, int n, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, bg);
  bmm_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(kb), static_cast<const T*>(x),
                                           static_cast<T*>(out), m, n);
  return cudaGetLastError();
}

// V: the piece one thread moves (uint4 = 16 bytes down to unsigned char)
template <typename V>
__global__ void __launch_bounds__(kThreads)
transpose_hw_kernel(const V* __restrict__ x, V* __restrict__ out, long long total, int h, int w,
                    int nv) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long r = e / nv;  // output row: ((bn * w + wi) * h + hi)
    const int v = static_cast<int>(e % nv), hi = static_cast<int>(r % h);
    const long long t = r / h;
    const int wi = static_cast<int>(t % w);
    const long long bn = t / w;
    out[e] = x[((bn * h + hi) * w + wi) * nv + v];
  }
}

template <typename V>
int launch_transpose(const void* x, void* out, int bn, int h, int w, int row_bytes,
                     cudaStream_t st) {
  const int nv = row_bytes / static_cast<int>(sizeof(V));
  const long long total = static_cast<long long>(bn) * h * w * nv;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (blocks == 0) return cudaSuccess;
  transpose_hw_kernel<V><<<blocks, kThreads, 0, st>>>(static_cast<const V*>(x),
                                                      static_cast<V*>(out), total, h, w, nv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lns_bmm(int dtype, const void* kb, const void* x, void* out, int bg, int m, int n,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bmm<float>(kb, x, out, bg, m, n, st);
  if (dtype == 1) return launch_bmm<__nv_bfloat16>(kb, x, out, bg, m, n, st);
  return cudaErrorInvalidValue;
}

extern "C" int lns_transpose_hw(int vec_bytes, const void* x, void* out, int bn, int h, int w,
                                int row_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_bytes <= 0 || row_bytes % vec_bytes) return cudaErrorInvalidValue;
  switch (vec_bytes) {
    case 16: return launch_transpose<uint4>(x, out, bn, h, w, row_bytes, st);
    case 8: return launch_transpose<uint2>(x, out, bn, h, w, row_bytes, st);
    case 4: return launch_transpose<unsigned>(x, out, bn, h, w, row_bytes, st);
    case 2: return launch_transpose<unsigned short>(x, out, bn, h, w, row_bytes, st);
    case 1: return launch_transpose<unsigned char>(x, out, bn, h, w, row_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}

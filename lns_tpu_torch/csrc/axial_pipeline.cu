// The axial-apply pipeline's two kernels: a batched square-by-wide matrix
// product and the h <-> w swap of a head-major tensor.
//
// Replaces lns_tpu/pallas_kernels/axial_pipeline.py: bmm_blockdiag
// (_bmm_kernel) and transpose_hw (_transpose_kernel).
//
// bmm:  kb [BG, M, M] @ x [BG, M, N] -> out [BG, M, N]   (all T; f32 sums,
//       rounded to T once, as the TPU kernel's preferred_element_type=f32 dot).
//       kb is any matrix: the block-diagonal structure of the TPU caller's
//       operand is not used. What bounds it on an H100: bytes. At M = 128 it
//       does 64 FLOP per byte of x and out in bf16, below the card's ~295
//       FLOP/B ridge, so reading x and writing out once is the floor; the
//       arithmetic only has to keep up, which CUDA-core FMAs do not.
//   bf16: tensor cores. One block per (bg, 128 x 128 output tile), 8 warps of
//       64 x 32 outputs each (mma.sync m16n8k16, f32 accumulators in
//       registers). The K dimension streams through a 3-stage cp.async ring
//       of 128 x 32 slices of kb and 32 x 128 slices of x, so the loads of
//       the next slices overlap the products of this one. The tile is
//       rounded to bf16 once, staged in shared memory and written with
//       16-byte stores. Shared memory: 3 x (128 x 40 + 32 x 136) bf16 =
//       56,832 bytes per block (the output staging reuses it); two blocks
//       per SM. Any M and N: ragged tiles are zero-filled in shared memory;
//       with M or N not a multiple of 8 (or an operand not 16-byte aligned)
//       lns_bmm selects element-wise loads and stores instead of
//       16-byte ones. The wrapper limits BG to 65,535 (the grid's z).
//   f32: 64 x 64 output tiles on CUDA cores, 16-deep slices of both operands
//       in shared memory, 4 x 4 outputs per thread (the TPU kernel uses
//       HIGHEST precision for f32, which has no bf16 tensor-core form).
// transpose_hw:  x [BN, H, W, row] -> out [BN, W, H, row], `row` bytes per
//       (h, w) moved unchanged. Pure data movement, bound by bytes: each
//       thread copies vector-sized pieces (16 bytes where the row and the
//       pointers allow), neighbouring threads on neighbouring addresses of an
//       output row. No shared memory is needed: a row of D elements is the
//       contiguous unit on both sides.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bmm_f32_kernel(const float* __restrict__ a_g, const float* __restrict__ b_g,
               float* __restrict__ c_g, int m_dim, int n_dim) {
  __shared__ float a_s[kBK][kBM + 1];  // kb tile, transposed: a_s[k][m]
  __shared__ float b_s[kBK][kBN];      // x tile: b_s[k][n]
  const size_t bg = blockIdx.z;
  const float* a = a_g + bg * m_dim * m_dim;
  const float* b = b_g + bg * m_dim * n_dim;
  float* c = c_g + bg * m_dim * n_dim;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < m_dim; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int mm = e / kBK, kk = e % kBK, gm = m0 + mm, gk = k0 + kk;
      a_s[kk][mm] = gm < m_dim && gk < m_dim ? a[static_cast<size_t>(gm) * m_dim + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, nn = e % kBN, gk = k0 + kk, gn = n0 + nn;
      b_s[kk][nn] = gk < m_dim && gn < n_dim ? b[static_cast<size_t>(gk) * n_dim + gn] : 0.f;
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
      if (gm < m_dim && gn < n_dim) c[static_cast<size_t>(gm) * n_dim + gn] = acc[i][j];
    }
  }
}

// bf16 on tensor cores: 128 x 128 output tile per block, K in slices of 32
constexpr int kTM = 128, kTN = 128, kTK = 32, kStages = 3;
constexpr int kLdA = kTK + 8, kLdB = kTN + 8, kLdC = kTN + 8;  // row strides (elements)
constexpr size_t kBmmSmem = sizeof(__nv_bfloat16) * kStages * (kTM * kLdA + kTK * kLdB);
static_assert(sizeof(__nv_bfloat16) * kTM * kLdC <= kBmmSmem, "output staging fits the ring");

// One K slice of kb (rows m0.., cols k0..) and of x (rows k0.., cols n0..)
// into stage `st` of the ring; zeros outside the matrices.
template <bool kVec>
__device__ __forceinline__ void bmm_load_slice(const __nv_bfloat16* __restrict__ a,
                                               const __nv_bfloat16* __restrict__ b,
                                               __nv_bfloat16* sa, __nv_bfloat16* sb, int m0,
                                               int n0, int k0, int m_dim, int n_dim) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kTM * kTK / 8; e += kThreads) {
    const int r = e / (kTK / 8), c8 = (e % (kTK / 8)) * 8, gm = m0 + r, gk = k0 + c8;
    __nv_bfloat16* dst = sa + r * kLdA + c8;
    const __nv_bfloat16* src = a + static_cast<size_t>(gm) * m_dim + gk;
    if (kVec) {
      lns::cp_async16(dst, gm < m_dim && gk < m_dim ? src : a, gm < m_dim && gk < m_dim);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) dst[q] = gm < m_dim && gk + q < m_dim ? src[q] : zero;
    }
  }
  for (int e = threadIdx.x; e < kTK * kTN / 8; e += kThreads) {
    const int r = e / (kTN / 8), c8 = (e % (kTN / 8)) * 8, gk = k0 + r, gn = n0 + c8;
    __nv_bfloat16* dst = sb + r * kLdB + c8;
    const __nv_bfloat16* src = b + static_cast<size_t>(gk) * n_dim + gn;
    if (kVec) {
      lns::cp_async16(dst, gk < m_dim && gn < n_dim ? src : b, gk < m_dim && gn < n_dim);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) dst[q] = gk < m_dim && gn + q < n_dim ? src[q] : zero;
    }
  }
}

// kVec: M and N are multiples of 8 and every pointer is 16-byte aligned, so
// slices move as 16-byte cp.async copies and the tile leaves as 16-byte stores.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
bmm_bf16_kernel(const __nv_bfloat16* __restrict__ a_g, const __nv_bfloat16* __restrict__ b_g,
                __nv_bfloat16* __restrict__ c_g, int m_dim, int n_dim) {
  extern __shared__ uint4 smem_bmm[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem_bmm);  // [kStages][kTM][kLdA]
  __nv_bfloat16* sb = sa + kStages * kTM * kLdA;                     // [kStages][kTK][kLdB]
  const size_t bg = blockIdx.z;
  const __nv_bfloat16* a = a_g + bg * m_dim * m_dim;
  const __nv_bfloat16* b = b_g + bg * m_dim * n_dim;
  __nv_bfloat16* c = c_g + bg * m_dim * n_dim;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // this warp's 64 x 32 outputs
  const int nk = (m_dim + kTK - 1) / kTK;

  float acc[4][4][4] = {};
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk)
      bmm_load_slice<kVec>(a, b, sa + st * kTM * kLdA, sb + st * kTK * kLdB, m0, n0, st * kTK,
                           m_dim, n_dim);
    lns::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    lns::cp_async_wait<kStages - 2>();  // slice kt has landed (this thread's copies)
    __syncthreads();                     // ... and every thread's; slice kt-1 is consumed
    const int pf = kt + kStages - 1;
    if (pf < nk)
      bmm_load_slice<kVec>(a, b, sa + (pf % kStages) * kTM * kLdA,
                           sb + (pf % kStages) * kTK * kLdB, m0, n0, pf * kTK, m_dim, n_dim);
    lns::cp_async_commit();
    const __nv_bfloat16* ta = sa + (kt % kStages) * kTM * kLdA;
    const __nv_bfloat16* tb = sb + (kt % kStages) * kTK * kLdB;
#pragma unroll
    for (int ks = 0; ks < kTK; ks += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        lns::ldsm_x4(af[mt], ta + lns::a_addr(lane, wm + mt * 16, ks, kLdA));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        lns::ldsm_x4_trans(bfr[np], tb + lns::b_addr(lane, ks, wn + np * 16, kLdB));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          lns::mma_bf16(acc[mt][nt], af[mt], bfr[nt / 2][nt % 2 * 2], bfr[nt / 2][nt % 2 * 2 + 1]);
    }
  }
  lns::cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the bf16 tile in it
  __nv_bfloat16* sc = sa;  // [kTM][kLdC]
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wm + mt * 16 + g, col = wn + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(sc + r * kLdC + col) =
          lns::pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<uint32_t*>(sc + (r + 8) * kLdC + col) =
          lns::pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < kTM * kTN / 8; e += kThreads) {
    const int r = e / (kTN / 8), c8 = (e % (kTN / 8)) * 8, gm = m0 + r, gn = n0 + c8;
    if (gm >= m_dim) continue;
    __nv_bfloat16* dst = c + static_cast<size_t>(gm) * n_dim + gn;
    const __nv_bfloat16* src = sc + r * kLdC + c8;
    if (kVec) {
      if (gn < n_dim) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (gn + q < n_dim) dst[q] = src[q];
    }
  }
}

template <bool kVec>
int launch_bmm_bf16(const void* kb, const void* x, void* out, int bg, int m, int n,
                    cudaStream_t st) {
  cudaError_t e = lns::allow_smem(bmm_bf16_kernel<kVec>, kBmmSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM, bg);
  bmm_bf16_kernel<kVec><<<grid, kThreads, kBmmSmem, st>>>(
      static_cast<const __nv_bfloat16*>(kb), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), m, n);
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
  if (dtype == 0) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, bg);
    bmm_f32_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(kb),
                                              static_cast<const float*>(x),
                                              static_cast<float*>(out), m, n);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  // 16-byte pieces where every row of kb, x and out starts on a 16-byte boundary
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = m % 8 == 0 && n % 8 == 0 && aligned(kb) && aligned(x) && aligned(out);
  return vec ? launch_bmm_bf16<true>(kb, x, out, bg, m, n, st)
             : launch_bmm_bf16<false>(kb, x, out, bg, m, n, st);
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

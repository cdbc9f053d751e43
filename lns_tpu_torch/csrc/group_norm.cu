// GroupNorm(G) + affine (+ swish) over channels-last activations [B, S, C],
// one thread-block cluster per sample.
//
// Replaces lns_tpu/pallas_kernels/group_norm.py: fused_group_norm_swish
// (_gn_kernel). It computes what the JAX package's models run,
// lns_tpu.ops.norms.GroupNorm followed by lns_tpu.ops.activations.swish, at
// their rounding points (below), as the plain version
// (kernels/group_norm.py: group_norm_swish_plain) states them in PyTorch.
//
// What bounds it on an H100: bytes. x is read once and y written once; the
// arithmetic per element is a few dozen instructions (the bf16 swish rounds
// after every op), under the card's rate. NS2d's decoder tail (GN(8) +
// swish at 64x64x64, 116 frames) moves 2 x 60.8 MB in bf16: 36 us at 3.35
// TB/s.
//
// Design: one cluster of CL blocks (1, 2, 4 or 8) per sample. Block r holds
// rows [r R, (r + 1) R) of the sample's [S, C] slab (R = ceil(S / CL)) in
// shared memory, so the slab is read from HBM once:
//   1. every thread copies 16-byte vectors (8 bf16 / f16 or 4 f32 channels)
//      with cp.async; V = C / VW threads cover a row, so a thread keeps the
//      same channels for every row it copies;
//   2. it sums its own copies per channel in f32 registers (x, and x^2 for
//      bf16 / f16); the block folds them per channel (warp shuffles where V
//      divides 32, then shared memory in a fixed order) and per group (one
//      warp per group);
//   3. each block stores its group partials into every block of the cluster
//      through distributed shared memory, and every block adds them in rank
//      order: all normalise with the same statistics, and two runs give the
//      same bits (no atomics);
//   4. f32 takes the exact two-pass statistics: with the mean exchanged,
//      each block sums (x - mean)^2 over its shared-memory slice, not HBM,
//      and the cluster exchanges a second time;
//   5. normalise, affine and swish from shared memory; 16-byte stores.
// The plan (cluster_for) takes the smallest CL whose block needs at most
// 76,800 bytes of shared memory (three blocks per SM), then doubles CL while
// the blocks would leave SMs idle. NS2d: 64x64x64 per sample is 512 KB in
// bf16 (CL 8, 64 KB slices, three blocks per SM) and 1 MB in f32 (CL 8,
// 128 KB slices, one block per SM).
//
// The split plan, for a slab that a cluster of 8 cannot hold (SW's 96x192x64
// is 2.36 MB in bf16): x is read twice instead of once, and no block holds
// more than 16 sweeps of rows. A grid over (sample, chunk of R rows):
//   1. gn_partials: each block sums its chunk's rows per channel (x, and x^2
//      for bf16 / f16) in f32 registers, folds them per group as above and
//      writes its [G, 2] partials to a workspace the wrapper allocates;
//   2. f32 only, gn_partials again: each block adds its sample's chunk
//      partials in chunk order into the mean and sums (x - mean)^2 over its
//      chunk, so the statistics stay the exact two-pass ones;
//   3. gn_apply: each block adds its sample's partials in chunk order (every
//      block of a sample the same bits: no atomics, two runs give the same
//      bits), forms the coefficients as the one-pass kernel does, and
//      normalises its chunk from HBM, at the same rounding points.
//
// Rounding. f32 (norms.py:45-54): mean, then the centred variance; y = (x -
// mean) inv scale + bias; swish y / (1 + exp(-y)). bf16 / f16 (norms.py:55-76
// and activations.swish): f32 sums of x and x^2; var = max(E[x^2] - mean^2,
// 0); inv = rsqrt(var + eps); sc = inv scale and sh = bias - mean sc in f32,
// each rounded to T; y = T(T(x sc) + sh); swish y (1 / (1 + exp(-y))) with
// every op rounded to T, through expf and an IEEE reciprocal. The products
// and sums of T run as T x2 instructions, which round once: as f32 carries
// more than twice T's precision plus 2 bits, that gives the same bits as the
// reference's f32 op rounded to T. The _rn intrinsics keep nvcc from fusing
// a product and a sum that the reference rounds apart.
//
// With coef_out (bf16 / f16), the block that holds a sample's first rows
// (the cluster's rank 0, or the split plan's first chunk) also writes the
// sample's sc and sh [2, C], the rounded values as f32: the FAB core forms
// its mean from the GroupNorm(1) output before its last rounding, T(x sc) +
// sh in f32, from them (kernels/fab_core.py).
//
// Limits, stated once (shape_limit; the wrapper raises with its text): C a
// multiple of 8 and of G, with C / VW <= 256 threads; the grid of the split
// plan (B x chunks blocks) within 2^31 - 1; the cluster (or the split plan's
// block) fits on the card (cudaOccupancyMaxActiveClusters). Any S: a slab
// within a cluster of 8 blocks of 227 KB of shared memory takes the one-pass
// kernel, a larger one the split plan.

#include <cooperative_groups.h>

#include <cstdio>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using lns::ld;
using lns::rnd;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kTargetSmem = 76800;  // bytes per block that let three blocks share an SM

struct Params {
  const void* x;       // [B, S, C] T
  const float* scale;  // [C]
  const float* bias;   // [C]
  void* out;           // [B, S, C] T
  int S, C, G, cl, rows;  // rows of the slab per block (cluster) or per chunk (split)
  float eps;
  int chunks;          // chunks per sample: 0 for the one-pass kernel
  float* ws;           // the split plan's partials [2][B, chunks, G, 2]
  float* coef_out;     // bf16 / f16, or null: each sample's sc and sh [B, 2, C]
};

// Rows of per-thread partial sums the block folds through shared memory:
// one per warp where V (threads per row) divides 32, else one per row that
// a sweep of the block covers.
__host__ __device__ inline int part_rows(int V) {
  return V <= 32 && 32 % V == 0 ? kWarps : kThreads / V;
}

// One block's shared memory: the slice of the slab (bytes), then f32
// arrays at these float offsets past it.
struct Layout {
  int slice;
  int part, chan, red, red2, coef;  // [2 part_rows C], [2 C], [CL G 2] x 2, [3 C]
  int bytes;
};

__host__ __device__ inline Layout layout_of(int esize, int S, int C, int G, int cl) {
  Layout l;
  l.slice = (S + cl - 1) / cl * C * esize;  // C esize is a multiple of 16
  l.part = 0;
  l.chan = 2 * part_rows(C * esize / 16) * C;
  l.red = l.chan + 2 * C;
  l.red2 = l.red + 2 * cl * G;
  l.coef = l.red2 + 2 * cl * G;
  l.bytes = l.slice + 4 * (l.coef + 3 * C);
  return l;
}

// Per-channel block sums of two sets of per-thread partials (a, q) into
// chan[0, C) and chan[C, 2C); the thread owns channels (tid % V) VW + k.
template <int VW>
__device__ void channel_sums(float (&a)[VW], float (&q)[VW], int C, int V, float* part,
                             float* chan) {
  const int tid = threadIdx.x, lane = tid % 32, nrow = part_rows(V);
  const bool fold = V <= 32 && 32 % V == 0;
  if (fold) {  // lanes l, l + V, ... own the same channels
    for (int off = V; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
        q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
      }
    }
  }
  const int row = fold ? tid / 32 : tid / V;
  if (fold ? lane < V : row < nrow) {
    float* pa = part + row * C + (tid % V) * VW;
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      pa[k] = a[k];
      pa[nrow * C + k] = q[k];
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float sa = 0.f, sq = 0.f;
    for (int r = 0; r < nrow; ++r) {
      sa += part[r * C + c];
      sq += part[(nrow + r) * C + c];
    }
    chan[c] = sa;
    chan[C + c] = sq;
  }
}

// Fold chan's per-channel sums into per-group sums (a warp per group) and
// store them into slot [rank][g] of `red` in every block of the cluster.
__device__ void send_groups(cg::cluster_group& cluster, const float* chan, float* red, int C,
                            int G, int cl, int rank) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, cpg = C / G;
  for (int g = warp; g < G; g += kWarps) {
    float a = 0.f, q = 0.f;
    for (int k = lane; k < cpg; k += 32) {
      a += chan[g * cpg + k];
      q += chan[C + g * cpg + k];
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane < cl)  // lane r stores into the block of rank r
      *reinterpret_cast<float2*>(cluster.map_shared_rank(red + 2 * (rank * G + g), lane)) =
          make_float2(a, q);
  }
}

// Two values of T in one register, and conversions to and from float2.
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Pair<__half> { using type = __half2; };
template <typename P> __device__ __forceinline__ P pack(float a, float b);
template <> __device__ __forceinline__ __nv_bfloat162 pack(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ __half2 pack(float a, float b) {
  return __floats2half2_rn(a, b);
}
__device__ __forceinline__ float2 unpack(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 unpack(__half2 v) { return __half22float2(v); }

// Slot j of group g summed over the cluster's ranks, in rank order.
__device__ __forceinline__ float rank_sum(const float* red, int G, int cl, int g, int j) {
  float s = 0.f;
  for (int r = 0; r < cl; ++r) s += red[2 * (r * G + g) + j];
  return s;
}

// bf16 / f16: a channel's sc = inv scale and sh = bias - mean sc, each
// rounded to T, from its group's f32 sums of x and x^2 over n elements.
template <typename T>
__device__ __forceinline__ void low_coef(float sum, float sumsq, float n, float eps, float scale,
                                         float bias, float* sc, float* sh) {
  const float mean = __fdiv_rn(sum, n);
  const float ex2 = __fdiv_rn(sumsq, n);
  const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
  const float s = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), scale);
  *sc = rnd<T>(s);
  *sh = rnd<T>(__fsub_rn(bias, __fmul_rn(mean, s)));
}

// Normalise, affine (+ swish) this thread's rows of xs (the block's slice
// in shared memory, or its chunk in HBM) into yg, from coef: f32 [mean C]
// [mul C] [add C]; bf16 / f16 [sc C] [sh C]. 16-byte loads and stores.
template <typename T, bool kSwish>
__device__ __forceinline__ void normalise(const T* xs, T* yg, const float* coef, int C, int c0,
                                          int row0, int nrows, int pstep) {
  constexpr int VW = 16 / sizeof(T);
  if constexpr (std::is_same<T, float>::value) {
    float mean[VW], mul[VW], add[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      mean[k] = coef[c0 + k];
      mul[k] = coef[C + c0 + k];
      add[k] = coef[2 * C + c0 + k];
    }
    for (int r = row0; r < nrows; r += pstep) {
      float4 v = *reinterpret_cast<const float4*>(xs + static_cast<size_t>(r) * C + c0);
      float* e = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        float y = fmaf(e[k] - mean[k], mul[k], add[k]);
        if (kSwish) y = y / (1.f + expf(-y));
        e[k] = y;
      }
      *reinterpret_cast<float4*>(yg + static_cast<size_t>(r) * C + c0) = v;
    }
  } else {
    // pairs of T: the x2 instructions round once, which gives the bits of
    // the f32 op rounded to T (f32 carries more than 2 p + 2 bits of T's p)
    using P = typename Pair<T>::type;
    P sc[VW / 2], sh[VW / 2];
#pragma unroll
    for (int j = 0; j < VW / 2; ++j) {
      sc[j] = pack<P>(coef[c0 + 2 * j], coef[c0 + 2 * j + 1]);
      sh[j] = pack<P>(coef[C + c0 + 2 * j], coef[C + c0 + 2 * j + 1]);
    }
    const P one = pack<P>(1.f, 1.f);
    for (int r = row0; r < nrows; r += pstep) {
      uint4 v = *reinterpret_cast<const uint4*>(xs + static_cast<size_t>(r) * C + c0);
      P* e = reinterpret_cast<P*>(&v);
#pragma unroll
      for (int j = 0; j < VW / 2; ++j) {
        P y = __hadd2_rn(__hmul2_rn(e[j], sc[j]), sh[j]);
        if (kSwish) {  // y (1 / (1 + exp(-y))), every op rounded to T
          const float2 t = unpack(y);
          const float2 d = unpack(__hadd2_rn(one, pack<P>(expf(-t.x), expf(-t.y))));
          y = __hmul2_rn(y, pack<P>(__frcp_rn(d.x), __frcp_rn(d.y)));
        }
        e[j] = y;
      }
      *reinterpret_cast<uint4*>(yg + static_cast<size_t>(r) * C + c0) = v;
    }
  }
}

// At most 80 registers a thread, so three blocks fit on an SM.
template <typename T, bool kSwish>
__global__ void __launch_bounds__(kThreads, 3) gn_kernel(Params p) {
  constexpr int VW = 16 / sizeof(T);
  constexpr bool kTwoPass = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C, G = p.G, cl = p.cl, cpg = C / G, tid = threadIdx.x;
  const int V = C / VW, pstep = kThreads / V, row0 = tid / V, c0 = (tid % V) * VW;
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * p.rows;
  // rows this thread walks (threads past pstep V idle)
  const int nrows = row0 < pstep ? max(0, min(p.rows, p.S - r0)) : 0;
  const size_t base = (static_cast<size_t>(blockIdx.x / cl) * p.S + r0) * C;
  const T* xg = static_cast<const T*>(p.x) + base;
  T* yg = static_cast<T*>(p.out) + base;
  const Layout L = layout_of(sizeof(T), p.S, C, G, cl);
  T* xs = reinterpret_cast<T*>(smem4);
  float* fs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + L.slice);
  float* part = fs + L.part;
  float* chan = fs + L.chan;
  float* red = fs + L.red;
  float* red2 = fs + L.red2;
  float* coef = fs + L.coef;

  // 1. this block's rows into shared memory
  for (int r = row0; r < nrows; r += pstep)
    lns::cp_async16(xs + r * C + c0, xg + static_cast<size_t>(r) * C + c0, true);
  lns::cp_async_commit();
  lns::cp_async_wait<0>();  // each thread reads back only its own copies

  // 2. per-channel sums of x (and x^2 for bf16 / f16), then per group
  float a[VW], q[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) a[k] = q[k] = 0.f;
  for (int r = row0; r < nrows; r += pstep) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xs + r * C + c0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float f = ld(e[k]);
      a[k] += f;
      if (!kTwoPass) q[k] = fmaf(f, f, q[k]);
    }
  }
  channel_sums<VW>(a, q, C, V, part, chan);
  cluster.sync();  // chan is complete, and every block of the cluster runs
  // 3. the exchange
  send_groups(cluster, chan, red, C, G, cl, rank);
  cluster.sync();  // every block's partials are in every block's red

  const float n = static_cast<float>(p.S) * cpg;
  if constexpr (kTwoPass) {
    // 4. the centred variance from the shared-memory slice
    for (int c = tid; c < C; c += kThreads) coef[c] = rank_sum(red, G, cl, c / cpg, 0) / n;
    __syncthreads();
    float m[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      m[k] = coef[c0 + k];
      a[k] = q[k] = 0.f;
    }
    for (int r = row0; r < nrows; r += pstep) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + r * C + c0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        const float d = ld(e[k]) - m[k];
        a[k] = fmaf(d, d, a[k]);
      }
    }
    channel_sums<VW>(a, q, C, V, part, chan);
    __syncthreads();
    send_groups(cluster, chan, red2, C, G, cl, rank);
    cluster.sync();
    for (int c = tid; c < C; c += kThreads) {
      const float var = rank_sum(red2, G, cl, c / cpg, 0) / n;
      coef[C + c] = rsqrtf(var + p.eps) * p.scale[c];
      coef[2 * C + c] = p.bias[c];
    }
  } else {
    float* co = p.coef_out && rank == 0 ? p.coef_out + static_cast<size_t>(blockIdx.x / cl) * 2 * C
                                        : nullptr;
    for (int c = tid; c < C; c += kThreads) {
      const int g = c / cpg;
      low_coef<T>(rank_sum(red, G, cl, g, 0), rank_sum(red, G, cl, g, 1), n, p.eps, p.scale[c],
                  p.bias[c], coef + c, coef + C + c);
      if (co) {
        co[c] = coef[c];
        co[C + c] = coef[C + c];
      }
    }
  }
  __syncthreads();

  // 5. normalise, affine (+ swish) from shared memory
  normalise<T, kSwish>(xs, yg, coef, C, c0, row0, nrows, pstep);
}

// ---------------------------------------------------------------------------
// The split plan: two (f32: three) launches over (sample, chunk of rows).

constexpr int kChunkSweeps = 16;  // sweeps of the block's threads over a chunk

// Per-channel sums of the block's thread partials, then per group into
// out[g] (x sum, and the second sum), in a fixed order.
__device__ void chunk_groups(const float* chan, float* out, int C, int G) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, cpg = C / G;
  for (int g = warp; g < G; g += kWarps) {
    float a = 0.f, q = 0.f;
    for (int k = lane; k < cpg; k += 32) {
      a += chan[g * cpg + k];
      q += chan[C + g * cpg + k];
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane == 0) *reinterpret_cast<float2*>(out + 2 * g) = make_float2(a, q);
  }
}

// Slot j of group g summed over the sample's chunks, in chunk order.
__device__ __forceinline__ float chunk_sum(const float* part, int chunks, int G, int g, int j) {
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[2 * (k * G + g) + j];
  return s;
}

// Shared memory of the split kernels: per-thread partials [2 part_rows C],
// per-channel sums [2 C], coefficients [3 C] (floats).
__host__ __device__ inline int split_smem(int esize, int C) {
  return 4 * (2 * part_rows(C * esize / 16) * C + 5 * C);
}

// Pass 1 (kCentred false): sums of x (and x^2 for bf16 / f16) over the
// chunk, into ws[0]. Pass 2 (f32, kCentred true): the sample's mean from
// ws[0], then sums of (x - mean)^2 over the chunk, into ws[1].
template <typename T, bool kCentred>
__global__ void __launch_bounds__(kThreads) gn_partials(Params p) {
  constexpr int VW = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  const int C = p.C, G = p.G, cpg = C / G, tid = threadIdx.x;
  const int V = C / VW, pstep = kThreads / V, row0 = tid / V, c0 = (tid % V) * VW;
  const int sample = blockIdx.x / p.chunks, chunk = blockIdx.x % p.chunks;
  const int r0 = chunk * p.rows;
  const int nrows = row0 < pstep ? max(0, min(p.rows, p.S - r0)) : 0;
  const T* xg = static_cast<const T*>(p.x) + (static_cast<size_t>(sample) * p.S + r0) * C;
  const size_t stride = static_cast<size_t>(gridDim.x) * G * 2;  // one set of partials
  float* part = reinterpret_cast<float*>(smem4);
  float* chan = part + 2 * part_rows(V) * C;
  float* coef = chan + 2 * C;

  float m[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) m[k] = 0.f;
  if (kCentred) {
    const float n = static_cast<float>(p.S) * cpg;
    const float* p1 = p.ws + static_cast<size_t>(sample) * p.chunks * G * 2;
    for (int c = tid; c < C; c += kThreads) coef[c] = chunk_sum(p1, p.chunks, G, c / cpg, 0) / n;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < VW; ++k) m[k] = coef[c0 + k];
  }
  float a[VW], q[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) a[k] = q[k] = 0.f;
  for (int r = row0; r < nrows; r += pstep) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xg + static_cast<size_t>(r) * C + c0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float f = ld(e[k]);
      if (kCentred) {
        const float d = f - m[k];
        a[k] = fmaf(d, d, a[k]);
      } else {
        a[k] += f;
        if (!std::is_same<T, float>::value) q[k] = fmaf(f, f, q[k]);
      }
    }
  }
  channel_sums<VW>(a, q, C, V, part, chan);
  __syncthreads();
  chunk_groups(chan, p.ws + (kCentred ? stride : 0) + static_cast<size_t>(blockIdx.x) * G * 2,
               C, G);
}

// Pass 3: the coefficients from the sample's chunk partials (every block of
// a sample adds them in the same order), then normalise, affine (+ swish)
// the chunk's rows from HBM.
template <typename T, bool kSwish>
__global__ void __launch_bounds__(kThreads) gn_apply(Params p) {
  constexpr int VW = 16 / sizeof(T);
  constexpr bool kTwoPass = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int C = p.C, G = p.G, cpg = C / G, tid = threadIdx.x;
  const int V = C / VW, pstep = kThreads / V, row0 = tid / V, c0 = (tid % V) * VW;
  const int sample = blockIdx.x / p.chunks, chunk = blockIdx.x % p.chunks;
  const int r0 = chunk * p.rows;
  const int nrows = row0 < pstep ? max(0, min(p.rows, p.S - r0)) : 0;
  const size_t base = (static_cast<size_t>(sample) * p.S + r0) * C;
  const T* xg = static_cast<const T*>(p.x) + base;
  T* yg = static_cast<T*>(p.out) + base;
  const size_t stride = static_cast<size_t>(gridDim.x) * G * 2;
  const float* p1 = p.ws + static_cast<size_t>(sample) * p.chunks * G * 2;
  float* coef = reinterpret_cast<float*>(smem4) + 2 * part_rows(V) * C + 2 * C;
  const float n = static_cast<float>(p.S) * cpg;
  for (int c = tid; c < C; c += kThreads) {
    const int g = c / cpg;
    if (kTwoPass) {
      const float var = chunk_sum(p1 + stride, p.chunks, G, g, 0) / n;
      coef[c] = chunk_sum(p1, p.chunks, G, g, 0) / n;
      coef[C + c] = rsqrtf(var + p.eps) * p.scale[c];
      coef[2 * C + c] = p.bias[c];
    } else {
      low_coef<T>(chunk_sum(p1, p.chunks, G, g, 0), chunk_sum(p1, p.chunks, G, g, 1), n, p.eps,
                  p.scale[c], p.bias[c], coef + c, coef + C + c);
      if (p.coef_out && chunk == 0) {
        p.coef_out[static_cast<size_t>(sample) * 2 * C + c] = coef[c];
        p.coef_out[static_cast<size_t>(sample) * 2 * C + C + c] = coef[C + c];
      }
    }
  }
  __syncthreads();
  normalise<T, kSwish>(xg, yg, coef, C, c0, row0, nrows, pstep);
}

int esize_of(int dtype) { return dtype == 0 ? 4 : 2; }

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Blocks per sample: the smallest power of two up to 8 whose blocks need at
// most kTargetSmem bytes each (else 8), doubled while B CL blocks would
// leave SMs idle and each block keeps at least one row.
int cluster_for(int esize, int B, int S, int C, int G) {
  int cl = 1;
  while (cl < kMaxCluster && layout_of(esize, S, C, G, cl).bytes > kTargetSmem) cl *= 2;
  const int sms = sm_count();
  while (cl < kMaxCluster && B * cl < sms && S >= 2 * cl) cl *= 2;
  return cl;
}

// Whether one sample's slab fits in a cluster of kMaxCluster blocks (the
// one-pass kernel); else the split plan takes it.
bool one_pass(int esize, int S, int C, int G) {
  const long long slice = (S + kMaxCluster - 1LL) / kMaxCluster * C * esize;
  return slice <= static_cast<long long>(lns::kMaxDynamicSmem) &&
         layout_of(esize, S, C, G, kMaxCluster).bytes <= static_cast<int>(lns::kMaxDynamicSmem);
}

// The split plan's rows per chunk: kChunkSweeps sweeps of the block.
int chunk_rows(int esize, int C) { return kChunkSweeps * (kThreads / (C * esize / 16)); }

// The kernel's limits, stated once: nullptr when it takes the shape, else
// the limit the shape breaks.
const char* shape_limit(int dtype, int B, int S, int C, int G) {
  static thread_local char msg[400];
  if (dtype < 0 || dtype > 2) return "dtype float32, bfloat16 or float16";
  const int esize = esize_of(dtype), vw = 16 / esize;
  if (B < 1 || S < 1) {
    snprintf(msg, sizeof msg, "B and the spatial size >= 1, got %d, %d", B, S);
  } else if (C % 8 || G < 1 || C % G || C / vw > kThreads) {
    snprintf(msg, sizeof msg, "C a multiple of 8 and of G, with C <= %d (16-byte vectors of %d "
             "channels over %d threads), got C %d, G %d", vw * kThreads, vw, kThreads, C, G);
  } else if (!one_pass(esize, S, C, G) &&
             static_cast<long long>(B) * ((S + chunk_rows(esize, C) - 1) / chunk_rows(esize, C))
                 > 2147483647LL) {
    snprintf(msg, sizeof msg, "the split plan's grid (B x chunks of %d rows) within 2^31 - 1 "
             "blocks, got B %d, S %d", chunk_rows(esize, C), B, S);
  } else {
    return nullptr;
  }
  return msg;
}

// Launch gn_kernel<T, kSwish> on `stream` (n null), or count the clusters of
// this launch the card holds at once (into n).
template <typename T, bool kSwish>
cudaError_t launch(const Params& p, int B, cudaStream_t stream, int* n) {
  const int smem = layout_of(sizeof(T), p.S, p.C, p.G, p.cl).bytes;
  cudaError_t e = lns::allow_smem(gn_kernel<T, kSwish>, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.cl);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (n) return cudaOccupancyMaxActiveClusters(n, gn_kernel<T, kSwish>, &cfg);
  e = cudaLaunchKernelEx(&cfg, gn_kernel<T, kSwish>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Launch the split plan's kernels in order on `stream` (n null), or count
// the blocks of its last kernel the card holds at once (into n).
template <typename T, bool kSwish>
cudaError_t launch_split(const Params& p, int B, cudaStream_t stream, int* n) {
  constexpr bool kTwoPass = std::is_same<T, float>::value;
  const int smem = split_smem(sizeof(T), p.C), blocks = B * p.chunks;
  cudaError_t e = lns::allow_smem(gn_partials<T, false>, smem);
  if (e == cudaSuccess && kTwoPass) e = lns::allow_smem(gn_partials<T, true>, smem);
  if (e == cudaSuccess) e = lns::allow_smem(gn_apply<T, kSwish>, smem);
  if (e != cudaSuccess) return e;
  if (n) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_apply<T, kSwish>, kThreads,
                                                      smem);
    *n = per_sm * sm_count();
    return e;
  }
  if (p.ws == nullptr) return cudaErrorInvalidValue;
  gn_partials<T, false><<<blocks, kThreads, smem, stream>>>(p);
  if (kTwoPass) gn_partials<T, true><<<blocks, kThreads, smem, stream>>>(p);
  gn_apply<T, kSwish><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, bool swish, const Params& p, int B, cudaStream_t stream, int* n) {
  const bool split = p.chunks > 0;
  switch (dtype * 2 + swish) {
    case 0: return split ? launch_split<float, false>(p, B, stream, n)
                         : launch<float, false>(p, B, stream, n);
    case 1: return split ? launch_split<float, true>(p, B, stream, n)
                         : launch<float, true>(p, B, stream, n);
    case 2: return split ? launch_split<__nv_bfloat16, false>(p, B, stream, n)
                         : launch<__nv_bfloat16, false>(p, B, stream, n);
    case 3: return split ? launch_split<__nv_bfloat16, true>(p, B, stream, n)
                         : launch<__nv_bfloat16, true>(p, B, stream, n);
    case 4: return split ? launch_split<__half, false>(p, B, stream, n)
                         : launch<__half, false>(p, B, stream, n);
    case 5: return split ? launch_split<__half, true>(p, B, stream, n)
                         : launch<__half, true>(p, B, stream, n);
    default: return cudaErrorInvalidValue;
  }
}

// A Params with the shape and the plan, no tensors.
Params plan_params(int dtype, int B, int S, int C, int G) {
  Params p{};
  p.S = S;
  p.C = C;
  p.G = G;
  const int esize = esize_of(dtype);
  if (one_pass(esize, S, C, G)) {
    p.cl = cluster_for(esize, B, S, C, G);
    p.rows = (S + p.cl - 1) / p.cl;
  } else {
    p.cl = 1;
    p.rows = chunk_rows(esize, C);
    p.chunks = (S + p.rows - 1) / p.rows;
  }
  return p;
}

// Shared memory bytes per block of the plan.
int smem_of(int dtype, const Params& p) {
  return p.chunks ? split_smem(esize_of(dtype), p.C)
                  : layout_of(esize_of(dtype), p.S, p.C, p.G, p.cl).bytes;
}

}  // namespace

// nullptr when the kernel of this dtype (0 f32, 1 bf16, 2 f16) takes the
// shape, else the limit it breaks; also when the cluster (the split plan's
// block) fits on no part of the card (cudaOccupancyMaxActiveClusters).
extern "C" const char* lns_group_norm_limit(int dtype, int B, int S, int C, int G) {
  if (const char* msg = shape_limit(dtype, B, S, C, G)) return msg;
  static thread_local char msg[200];
  const Params p = plan_params(dtype, B, S, C, G);
  int n = 0;
  const cudaError_t e = dispatch(dtype, true, p, B, nullptr, &n);
  if (e != cudaSuccess || n < 1) {
    snprintf(msg, sizeof msg, "a cluster of %d blocks of %d bytes of shared memory that the card "
             "can hold (cudaOccupancyMaxActiveClusters: %d, %s)", p.cl, smem_of(dtype, p), n,
             cudaGetErrorString(e));
    return msg;
  }
  return nullptr;
}

// Bytes of workspace the launch of this shape needs (0: the one-pass kernel
// needs none; the split plan one or, in f32, two sets of [B, chunks, G, 2]
// f32 partials).
extern "C" long long lns_group_norm_workspace(int dtype, int B, int S, int C, int G) {
  if (shape_limit(dtype, B, S, C, G)) return -1;
  const Params p = plan_params(dtype, B, S, C, G);
  return static_cast<long long>(dtype == 0 ? 2 : 1) * B * p.chunks * G * 2 * sizeof(float);
}

// The launch for this shape: out = {blocks per sample (the cluster; 1 in the
// split plan), blocks, shared memory bytes per block, clusters the card
// holds at once, rows of the slab per block, chunks per sample (0: the
// one-pass kernel; else the split plan, whose blocks each take one chunk)}.
extern "C" int lns_group_norm_plan(int dtype, int B, int S, int C, int G, int* out) {
  if (shape_limit(dtype, B, S, C, G)) return cudaErrorInvalidValue;
  const Params p = plan_params(dtype, B, S, C, G);
  out[0] = p.cl;
  out[1] = B * (p.chunks ? p.chunks : p.cl);
  out[2] = smem_of(dtype, p);
  out[3] = 0;
  out[4] = p.rows;
  out[5] = p.chunks;
  return dispatch(dtype, true, p, B, nullptr, &out[3]);
}

extern "C" int lns_group_norm(int dtype, const void* x, const void* scale, const void* bias,
                              void* out, void* workspace, void* coef_out, int B, int S, int C,
                              int G, float eps, int swish, void* stream) {
  if (coef_out && dtype == 0) return cudaErrorInvalidValue;
  if (shape_limit(dtype, B, S, C, G)) return cudaErrorInvalidValue;
  Params p = plan_params(dtype, B, S, C, G);
  p.x = x;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.eps = eps;
  p.ws = static_cast<float*>(workspace);
  p.coef_out = static_cast<float*>(coef_out);
  return dispatch(dtype, swish != 0, p, B, static_cast<cudaStream_t>(stream), nullptr);
}

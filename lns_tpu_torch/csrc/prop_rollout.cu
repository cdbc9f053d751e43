// Fused latent rollout: `steps` SimpleCNN propagator applications in one
// kernel launch.
//
// Replaces lns_tpu/pallas_kernels/prop_rollout.py: fused_rollout
// (_rollout_kernel). Each step:
//   h = z @ in_w + in_b
//   n_block x [ t = GN1(h); t = gelu(conv3(t)); t = gelu(conv3_dil(t));
//               h = h + conv3(t);  f = GN1(h); h = h + gelu(f @ ffn0) @ ffn1 ]
//   z = GN(groups)(h) @ out_w + out_b
// and z is carried to the next step.
//
// What bounds it on an H100: tensor-core arithmetic in principle (~183
// MFLOP per sample-step at NS2d's 8x8 latent, C 128: 0.17 ms for B32 x 29
// steps at 989 TFLOP/s; the bytes, z0, the outputs and the weights once,
// take ~1.4 us). In practice latency: every op of a step needs the whole
// previous op of the same sample (GN statistics, 3x3 taps), so a sample's
// work is a chain of ~20 small products per step, and the batch alone
// (32 samples) cannot fill 132 SMs.
//
// bf16 design (rollout_bf16_kernel): one thread-block cluster of CL blocks
// per sample (CL = 8 for B <= 8 and C a multiple of 128, else 4 for C a
// multiple of 64, else 2: 128 blocks at NS2d's B32). Block r owns output
// channels [r C/CL, (r+1) C/CL) of every layer but the last. Each product is
// an implicit GEMM on tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulators): M = positions in 16-row tiles, N = the block's C/CL
// channels, K = 9 C (3x3) or C / C_lat (1x1). The A operand is read with
// ldmatrix straight from the full-width input in shared memory, one row
// address per lane: a 3x3 tap is the source row tap_row(y, x, dy, dx)
// (circular axes wrap, zero-padded axes and rows past H*W point at an
// all-zero row), so the gather costs a few integer adds per tap and all
// four padding modes share one path. Each layer's output slice is stored,
// rounded to bf16, into the next input buffer of every block of the
// cluster through distributed shared memory, then the cluster synchronises.
// Two full-width buffers F0 / F1 ping-pong: a layer reads one and writes
// the other, and the barrier after it ends every read of the buffer the
// next layer writes. The residual stream h stays in its owner block (the
// convs' and the FFN's residual epilogues are local). GN(1) sums f32
// partials over each block's slice and exchanges them through DSMEM (every
// block adds them in rank order, so all use the same statistics);
// GN(groups)'s groups lie inside a slice. The out-projection (N = C_lat) is
// split by rows instead: block r computes the 16-row tiles r, r + CL, ...
// for all C_lat columns and stores them into every block's carry, which
// lives in columns [0, C_lat) of F1. Each block streams only its slice of
// the weights (0.71 MB of 2.85 MB per step at C 128, CL 4, resident in L2
// across the 32 clusters) through a 4-stage cp.async ring of one 3x3 tap
// (C x C/CL) per stage, continuous across layers and steps, so the next
// layer's first taps load during this layer's products. Per step: 20
// cluster barriers at n_block 3. No atomics: two runs give the same bits.
//
// What the measurements on the card taught (PERF.md): the code must stay
// small and branch-free in the product loop. Each warp runs the same NT
// 16-row tiles (a template parameter, 1, 2, 3 or 5 by shape; tiles past
// H*W read the zero row), a step is a loop over one call site of product()
// with the epilogue chosen at run time, and no integer division runs per
// chunk or per element. Seven inlined products with a predicated 5-tile
// loop made 31,296 instructions and ran 4x slower. At NT <= 2 two blocks
// may share an SM, so B32's 32 clusters of 4 run in one wave (at one block
// per SM the card holds 30).
//
// Shared memory per block (bf16 elements unless said): F0, F1 (H W + 1) x
// (C + 8) each; h H W x (C/CL + 8); the ring 4 x C x (C/CL + 8); f32: the
// GN partials of up to 8 peers, per-warp sums, per-group statistics and
// per-channel mean, inv, scale, bias. Row strides are odd multiples of 16
// bytes (conflict-free ldmatrix). NS2d 8x8, C 128, CL 4: 82,336 bytes. SW
// 12x24, C 128, C_lat 64: 222,112 bytes at CL 4 (2 x 78,608 + 11,520 + 4 x
// 10,240 + 896), 196,128 at CL 8, of 232,448. Limits, stated once in
// bf16_limit (the wrapper raises with its text, and the launcher refuses):
// C a multiple of 32 with C/CL <= 128; C_lat a multiple of 16 up to min(C,
// 128); C/groups dividing C/CL; at most 5 row tiles per warp (H W <= 320
// at C 128, CL 4); shared memory as above.
//
// f32 (rollout_kernel<float>, the check path): one block per sample runs
// all steps with f32 FMAs on CUDA cores; the carry, the residual stream
// and two scratch activations are f32 ([H*W+1, C] each; the extra row is
// all zeros), 4 (3 (H W + 1) C + (H W + 1) C_lat) bytes per sample. They
// live in shared memory when that and the GN scratch (4 (4 C + 1024)
// bytes) fit in 227 KB (NS2d's 8x8: 83,520 bytes); else in a global-memory
// workspace that the wrapper allocates, one slice per sample (SW's 12x24 at
// C 128, C_lat 64: 517,888 bytes, which stays in L2 at a check's small B),
// and shared memory keeps the GN scratch alone. The same code runs both:
// every access is through a generic pointer, and __syncthreads() orders a
// block's global writes as it does its shared ones. Thread (co, position
// group) owns one output channel for a run of positions and keeps their
// accumulators in registers.
//
// Rounding (both): products accumulate in f32 and are rounded to the
// activation dtype, then the bias (rounded the same way) is added and the
// sum rounded; GELU is computed in f32 and rounded; residual adds are
// rounded; GN statistics are f32 single-pass with the variance clamped at 0.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdio>

#include "common.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using lns::cvt;
using lns::ld;
using lns::rnd;

constexpr int kThreads = 512;
constexpr int kMaxPerThread = 16;  // accumulators one thread keeps in a conv

struct Geo {
  int H, W, P;
  int wrap_y, wrap_x;
};

struct Params {
  const void* z0;       // [B, P, C_lat] T
  const void* in_w;     // [C_lat, C] T
  const float* in_b;    // [C]
  const float* gn_s;    // [n_block, 2, C]
  const float* gn_b;    // [n_block, 2, C]
  const void* conv_w;   // [n_block, 3, 9, C, C] T (HWIO per conv)
  const float* conv_b;  // [n_block, 3, C]
  const void* ffn_w;    // [n_block, 2, C, C] T
  const float* out_gn_s;  // [C]
  const float* out_gn_b;  // [C]
  const void* out_w;    // [C, C_lat] T
  const float* out_b;   // [C_lat]
  void* out;            // [steps, B, P, C_lat] T
  int B, C_lat, C, n_block, dilation, groups, steps;
  Geo geo;
  int cl;               // blocks per sample (bf16)
  float* ws;            // f32: the activations [B][3 (P+1) C + (P+1) C_lat], or null
};

// Source row of output position p through tap offset (dy, dx); P is the zero row.
__device__ __forceinline__ int tap_src(const Geo& g, int p, int dy, int dx) {
  int y = p / g.W + dy, x = p % g.W + dx;
  if (y < 0 || y >= g.H) {
    if (!g.wrap_y) return g.P;
    y = ((y % g.H) + g.H) % g.H;
  }
  if (x < 0 || x >= g.W) {
    if (!g.wrap_x) return g.P;
    x = ((x % g.W) + g.W) % g.W;
  }
  return y * g.W + x;
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// f32: one block per sample, FMAs on CUDA cores.

enum Epilogue { kPlain = 0, kGelu = 1, kResidual = 2 };

// out[p, co] (=|+=) sum_taps sum_ci in[src(p, tap), ci] * w[tap, ci, co], with
// bias and epilogue. in/out are [P+1, cin/cout] f32 in shared memory.
template <typename T, int EPI>
__device__ void conv(const Geo& g, const float* __restrict__ in, int cin,
                     float* __restrict__ out, int cout, const T* __restrict__ w,
                     const float* __restrict__ bias, int taps, int dil) {
  const int ngroups = blockDim.x / cout;
  const int co = threadIdx.x % cout;
  const int grp = threadIdx.x / cout;
  const int per = (g.P + ngroups - 1) / ngroups;  // positions of this thread group
  const float b = bias ? rnd<T>(bias[co]) : 0.f;
  // the group's positions in runs of at most kMaxPerThread accumulators
  for (int j0 = 0; j0 < per; j0 += kMaxPerThread) {
    const int cnt = min(kMaxPerThread, per - j0);
    const int p0 = grp * per + j0;
    float acc[kMaxPerThread];
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;
    for (int t = 0; t < taps; ++t) {
      const int dy = taps == 9 ? (t / 3 - 1) * dil : 0;
      const int dx = taps == 9 ? (t % 3 - 1) * dil : 0;
      int src[kMaxPerThread];
#pragma unroll
      for (int j = 0; j < kMaxPerThread; ++j) {
        const int p = p0 + j;
        src[j] = (j < cnt && p < g.P) ? tap_src(g, p, dy, dx) * cin : g.P * cin;
      }
      const T* wt = w + static_cast<size_t>(t) * cin * cout + co;
      for (int ci = 0; ci < cin; ci += 4) {
        const float w0 = ld(wt[(ci + 0) * cout]);
        const float w1 = ld(wt[(ci + 1) * cout]);
        const float w2 = ld(wt[(ci + 2) * cout]);
        const float w3 = ld(wt[(ci + 3) * cout]);
#pragma unroll
        for (int j = 0; j < kMaxPerThread; ++j) {
          if (j < cnt) {
            const float4 v = *reinterpret_cast<const float4*>(in + src[j] + ci);
            acc[j] = fmaf(v.x, w0, acc[j]);
            acc[j] = fmaf(v.y, w1, acc[j]);
            acc[j] = fmaf(v.z, w2, acc[j]);
            acc[j] = fmaf(v.w, w3, acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int p = p0 + j;
      if (j < cnt && p < g.P) {
        float v = rnd<T>(acc[j]);
        if (bias) v = rnd<T>(v + b);
        if (EPI == kGelu) v = rnd<T>(gelu(v));
        if (EPI == kResidual) v = rnd<T>(out[p * cout + co] + v);
        out[p * cout + co] = v;
      }
    }
  }
  __syncthreads();
}

// y = GroupNorm(G)(x) with f32 single-pass statistics (variance clamped at
// 0), affine, rounded to T. x, y: [P, C] in shared memory; red holds
// 2 * blockDim floats, chan 2 * C, stats 2 * G.
template <typename T>
__device__ void group_norm(const float* __restrict__ x, float* __restrict__ y,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           int P, int C, int G, float eps, float* red, float* chan,
                           float* stats) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ngroups = nt / C;
  const int c = tid % C, grp = tid / C;
  // per (thread group, channel) partial sums over positions
  float s1 = 0.f, s2 = 0.f;
  if (grp < ngroups) {
    for (int p = grp; p < P; p += ngroups) {
      const float v = x[p * C + c];
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
  red[tid] = s1;
  red[nt + tid] = s2;
  __syncthreads();
  // per channel
  for (int cc = tid; cc < C; cc += nt) {
    float a = 0.f, q = 0.f;
    for (int k = 0; k < ngroups; ++k) {
      a += red[k * C + cc];
      q += red[nt + k * C + cc];
    }
    chan[cc] = a;
    chan[C + cc] = q;
  }
  __syncthreads();
  // per group: one warp sums its group's channels
  const int cg = C / G, warp = tid / 32, lane = tid % 32;
  for (int gi = warp; gi < G; gi += nt / 32) {
    float a = 0.f, q = 0.f;
    for (int cc = gi * cg + lane; cc < (gi + 1) * cg; cc += 32) {
      a += chan[cc];
      q += chan[C + cc];
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      const float n = static_cast<float>(P) * cg;
      const float mean = a / n;
      const float var = fmaxf(q / n - mean * mean, 0.f);
      stats[gi] = mean;
      stats[G + gi] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int i = tid; i < P * C; i += nt) {
    const int cc = i % C, gi = cc / cg;
    const float v = (x[i] - stats[gi]) * stats[G + gi];
    y[i] = rnd<T>(v * scale[cc] + bias[cc]);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rollout_kernel(Params prm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Geo g = prm.geo;
  const int P = g.P, C = prm.C, CL = prm.C_lat;
  const int rows = P + 1;
  const int b = blockIdx.x, tid = threadIdx.x;
  // the activations: this sample's slice of the workspace, or shared memory
  float* act = prm.ws ? prm.ws + static_cast<size_t>(b) * rows * (3 * C + CL) : smem;
  float* h = act;                 // residual stream [P+1, C]
  float* t1 = h + rows * C;       // scratch        [P+1, C]
  float* t2 = t1 + rows * C;      // scratch        [P+1, C]
  float* z = t2 + rows * C;       // latent carry   [P+1, C_lat]
  float* red = prm.ws ? smem : z + rows * CL;  // 2 * kThreads
  float* chan = red + 2 * kThreads;   // 2 * C
  float* stats = chan + 2 * C;        // 2 * C (2 * groups used)

  const T* z0 = static_cast<const T*>(prm.z0) + static_cast<size_t>(b) * P * CL;
  for (int i = tid; i < P * CL; i += blockDim.x) z[i] = ld(z0[i]);
  for (int i = tid; i < CL; i += blockDim.x) z[P * CL + i] = 0.f;
  for (int i = tid; i < C; i += blockDim.x) h[P * C + i] = t1[P * C + i] = t2[P * C + i] = 0.f;
  __syncthreads();

  const T* in_w = static_cast<const T*>(prm.in_w);
  const T* conv_w = static_cast<const T*>(prm.conv_w);
  const T* ffn_w = static_cast<const T*>(prm.ffn_w);
  const T* out_w = static_cast<const T*>(prm.out_w);
  const size_t cc2 = static_cast<size_t>(C) * C;
  T* out = static_cast<T*>(prm.out);

  for (int step = 0; step < prm.steps; ++step) {
    conv<T, kPlain>(g, z, CL, h, C, in_w, prm.in_b, 1, 1);
    for (int i = 0; i < prm.n_block; ++i) {
      const T* cw = conv_w + static_cast<size_t>(i) * 3 * 9 * cc2;
      const float* cb = prm.conv_b + static_cast<size_t>(i) * 3 * C;
      const float* gs = prm.gn_s + static_cast<size_t>(i) * 2 * C;
      const float* gb = prm.gn_b + static_cast<size_t>(i) * 2 * C;
      const T* fw = ffn_w + static_cast<size_t>(i) * 2 * cc2;
      group_norm<T>(h, t1, gs, gb, P, C, 1, 1e-5f, red, chan, stats);
      conv<T, kGelu>(g, t1, C, t2, C, cw, cb, 9, 1);
      conv<T, kGelu>(g, t2, C, t1, C, cw + 9 * cc2, cb + C, 9, prm.dilation);
      conv<T, kResidual>(g, t1, C, h, C, cw + 18 * cc2, cb + 2 * C, 9, 1);
      group_norm<T>(h, t1, gs + C, gb + C, P, C, 1, 1e-5f, red, chan, stats);
      conv<T, kGelu>(g, t1, C, t2, C, fw, nullptr, 1, 1);
      conv<T, kResidual>(g, t2, C, h, C, fw + cc2, nullptr, 1, 1);
    }
    group_norm<T>(h, t1, prm.out_gn_s, prm.out_gn_b, P, C, prm.groups, 1e-6f, red, chan, stats);
    conv<T, kPlain>(g, t1, C, z, CL, out_w, prm.out_b, 1, 1);
    T* o = out + (static_cast<size_t>(step) * prm.B + b) * P * CL;
    for (int i = tid; i < P * CL; i += blockDim.x) o[i] = cvt<T>(z[i]);
  }
}

bool fits(int cout) { return cout > 0 && kThreads % cout == 0; }

// Bytes of one sample's f32 activations (h, two scratch, the carry).
size_t f32_act_bytes(int P, int C_lat, int C) {
  return static_cast<size_t>(P + 1) * (3 * C + C_lat) * sizeof(float);
}

// Whether the f32 activations live in the workspace (not shared memory).
bool f32_in_workspace(int P, int C_lat, int C) {
  return f32_act_bytes(P, C_lat, C) + (2 * kThreads + 4 * C) * sizeof(float) >
         lns::kMaxDynamicSmem;
}

size_t f32_smem(int P, int C_lat, int C) {
  return (f32_in_workspace(P, C_lat, C) ? 0 : f32_act_bytes(P, C_lat, C)) +
         (2 * kThreads + 4 * C) * sizeof(float);
}

// The f32 kernel's limits: nullptr when it takes the shape. Any H W: the
// activations of a sample that shared memory cannot hold go to the
// workspace.
const char* f32_limit(int P, int C_lat, int C, int groups) {
  static thread_local char msg[200];
  if (C % 4 || C_lat % 4 || !fits(C) || !fits(C_lat)) {
    snprintf(msg, sizeof msg, "C and C_lat multiples of 4 dividing %d (a thread per output "
             "channel), got C %d, C_lat %d", kThreads, C, C_lat);
  } else if (groups <= 0 || C % groups) {
    snprintf(msg, sizeof msg, "groups dividing C, got %d", groups);
  } else if (P < 1) {
    snprintf(msg, sizeof msg, "H W >= 1, got %d", P);
  } else {
    return nullptr;
  }
  return msg;
}

// ---------------------------------------------------------------------------
// bf16: a cluster of blocks per sample, products on tensor cores.

constexpr int kBfThreads = 256;
constexpr int kBfWarps = kBfThreads / 32;
constexpr int kStages = 4;       // weight ring stages
constexpr int kMaxTiles = 5;     // 16-row tiles one warp accumulates in a product
constexpr int kMaxCluster = 8;

// 16-row tiles per warp the bf16 kernel is built for (template NT): the
// smallest of 1, 2, 3, 5 that covers a shape; every warp runs NT tiles, the
// ones past H*W reading the zero row, so the product loop has no branches.
__host__ __device__ inline int tiles_for(int need) {
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 3 ? 3 : need <= kMaxTiles ? kMaxTiles : 0;
}

// The bf16 kernel's shared-memory layout, on the host and the device alike.
struct Plan {
  int cl, ns;    // blocks per sample, output channels per block (C / cl)
  int ldf, ldh;  // row strides (elements): full-width buffers, the h slice
  int stage;     // elements per ring stage: C k-rows of an ns-column slice
  int kc_out;    // k-rows per stage of the out-projection: the largest multiple
                 // of 16 dividing C whose rows of C_lat + 8 fit a stage
  int smem;      // bytes per block
};

__host__ __device__ inline Plan make_plan(int P, int C_lat, int C, int cl) {
  Plan p;
  p.cl = cl;
  p.ns = C / cl;
  p.ldf = C + 8;
  p.ldh = p.ns + 8;
  p.stage = C * (p.ns + 8);
  p.kc_out = C - C % 16;
  while (p.kc_out > 16 && (C % p.kc_out || p.kc_out * (C_lat + 8) > p.stage)) p.kc_out -= 16;
  p.smem = 2 * (2 * (P + 1) * p.ldf + P * p.ldh + kStages * p.stage) +
           4 * (2 * kMaxCluster + 2 * kBfWarps + 6 * p.ns);
  return p;
}

// One product of a step: out[p, n] = sum_{tap, ci} in[src(p, tap), ci] *
// w[tap * cin + ci, n], n < ncols; its weight streams kc k-rows per stage
// (kc divides cin).
struct Gemm {
  const bf16* w;  // row 0 of the block's columns of the weight
  int ldw;        // row stride of w in device memory
  int taps, cin, ncols, kc, dil;
};

// Product g of a step for the block of rank `rank`: 0 the in-projection,
// 1 + 5 i + j block i's three convs (j < 3) and two FFN matrices, 1 + 5
// n_block the out-projection (all C_lat columns; the blocks split its rows).
__device__ Gemm gemm_of(const Params& p, const Plan& pl, int rank, int g) {
  const int col0 = rank * pl.ns;
  const size_t cc2 = static_cast<size_t>(p.C) * p.C;
  if (g == 0) return {static_cast<const bf16*>(p.in_w) + col0, p.C, 1, p.C_lat, pl.ns, p.C_lat, 1};
  if (g == 1 + 5 * p.n_block)
    return {static_cast<const bf16*>(p.out_w), p.C_lat, 1, p.C, p.C_lat, pl.kc_out, 1};
  const int i = (g - 1) / 5, j = (g - 1) % 5;
  if (j < 3)
    return {static_cast<const bf16*>(p.conv_w) + (3 * i + j) * 9 * cc2 + col0, p.C, 9, p.C,
            pl.ns, p.C, j == 1 ? p.dilation : 1};
  return {static_cast<const bf16*>(p.ffn_w) + (2 * i + j - 3) * cc2 + col0, p.C, 1, p.C, pl.ns,
          p.C, 1};
}

// Source row of the A row at (y, x) through tap offset (dy, dx): circular
// axes wrap, zero-padded axes and rows past H*W (y < 0) give the zero row P.
// No division: a chunk's rows are gathered at the cost of a few adds.
__device__ __forceinline__ int tap_row(const Geo& g, int y, int x, int dy, int dx) {
  if (y < 0) return g.P;
  y += dy;
  x += dx;
  if (y < 0 || y >= g.H) {
    if (!g.wrap_y) return g.P;
    while (y < 0) y += g.H;
    while (y >= g.H) y -= g.H;
  }
  if (x < 0 || x >= g.W) {
    if (!g.wrap_x) return g.P;
    while (x < 0) x += g.W;
    while (x >= g.W) x -= g.W;
  }
  return y * g.W + x;
}

// Per-block state of the bf16 kernel.
struct Ctx {
  Plan pl;
  int rank, col0;
  int ty[kMaxTiles], tx[kMaxTiles];  // (y, x) of this lane's A row in the convs'
                                     // tiles; y < 0 past H*W
  bf16 *f0, *f1;  // full-width buffers [P+1, ldf]; row P stays zero
  bf16* ring;     // weight ring, kStages x stage
  bf16* hs;       // residual stream, this block's channels [P, ldh]
  float* red;     // GN(1) partials (s1, s2) of every block, by rank
  float* wsum;    // per-warp partial sums
  float* gstat;   // per-group mean, then inv, of this block's groups
  float* cstat;   // per-channel mean, inv, scale, bias of a GN
  int used, issued;  // weight chunks consumed and issued
  // the weight stream's next chunk: product ig of step is, with ileft chunks
  // left from isrc on (ikc rows of incols, row stride ildw), and this
  // thread's share of a chunk's 16-byte copies (rows ir0, ir0 + irstep, ...
  // at column 8 iv)
  int is, ig, ileft, ildw, incols, ikc, iv, ir0, irstep;
  const bf16* isrc;
};

// Point the weight stream at product x.ig of its step.
__device__ void stream_begin(Ctx& x, const Params& p) {
  const Gemm m = gemm_of(p, x.pl, x.rank, x.ig);
  const int vec = m.ncols / 8;
  x.isrc = m.w;
  x.ileft = m.taps * (m.cin / m.kc);
  x.ildw = m.ldw;
  x.incols = m.ncols;
  x.ikc = m.kc;
  x.iv = threadIdx.x % vec;
  x.irstep = kBfThreads / vec;
  x.ir0 = threadIdx.x < x.irstep * vec ? threadIdx.x / vec : m.kc;
}

// Issue the next chunk of the weight stream, if the rollout has one left,
// into its ring slot; commit a (possibly empty) group either way.
__device__ void issue_next(Ctx& x, const Params& p) {
  if (x.is < p.steps) {
    bf16* dst = x.ring + (x.issued % kStages) * x.pl.stage + x.iv * 8;
    const bf16* src = x.isrc + x.iv * 8;
    for (int r = x.ir0; r < x.ikc; r += x.irstep)
      lns::cp_async16(dst + r * (x.incols + 8), src + static_cast<size_t>(r) * x.ildw, true);
    x.isrc += static_cast<size_t>(x.ikc) * x.ildw;
    if (--x.ileft == 0) {
      if (++x.ig == 2 + 5 * p.n_block) {
        x.ig = 0;
        ++x.is;
      }
      stream_begin(x, p);
    }
  }
  ++x.issued;
  lns::cp_async_commit();
}

enum BfEpilogue {
  kSetH,     // h = v                       (in-projection)
  kAddH,     // h = h + v                   (third conv, second FFN matrix)
  kGeluAll,  // dst[p, col0 + n] = gelu(v) in every block (first two convs, first FFN)
  kOutZ,     // dst[p, n] = v in every block (the carry), and to device memory
};

// One product over NT of the 16-row tiles first + i * stride (i < count)
// per warp: its weight chunks are consumed from the ring as they arrive;
// the A operand is gathered from `in` (a full-width buffer) by tap. The
// epilogue rounds where the plain version does and stores per epi. Warp w
// takes the 16 columns (w % ngr) and every (8 / ngr)-th tile. 3x3 products
// use the convs' tiles (first 0, stride 1), whose rows Ctx holds as (y, x).
template <int NT>
__device__ void product(Ctx& x, const Params& p, cg::cluster_group& cluster, const Gemm& m,
                        const bf16* in, int first, int stride, int count, const float* bias,
                        int epi, bf16* dst, bf16* gout) {
  const Geo& g = p.geo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ngr = m.ncols / 16, lanes_m = kBfWarps / ngr;
  const int ng = warp % ngr, ml = warp / ngr;
  const bool active = warp < lanes_m * ngr && ml < count;
  float acc[NT][2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k / 4][k % 4] = 0.f;
  int srow[NT];
  const int nch = m.taps * (m.cin / m.kc);
  for (int c = 0, tap = 0, k0 = 0; c < nch; ++c) {
    lns::cp_async_wait<kStages - 2>();  // this chunk's copies have landed ...
    __syncthreads();                     // ... for every thread; the oldest slot is free
    issue_next(x, p);
    const bf16* slot = x.ring + (x.used % kStages) * x.pl.stage;
    ++x.used;
    if (active) {
      if (k0 == 0) {  // this lane's source rows for the new tap
        const int dy = (tap / 3 - 1) * m.dil, dx = (tap % 3 - 1) * m.dil;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int pos = (first + (ml + j * lanes_m) * stride) * 16 + (lane & 15);
          srow[j] = (m.taps == 9 ? tap_row(g, x.ty[j], x.tx[j], dy, dx) : min(pos, g.P)) * x.pl.ldf;
        }
      }
      const bf16* arow = in + k0 + ((lane >> 4) << 3);
      const bf16* brow = slot + lns::b_addr(lane, 0, ng * 16, m.ncols + 8);
      for (int kk = 0; kk < m.kc; kk += 16) {
        uint32_t bw[4];
        lns::ldsm_x4_trans(bw, brow + kk * (m.ncols + 8));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t a[4];
          lns::ldsm_x4(a, arow + srow[j] + kk);
          lns::mma_bf16(acc[j][0], a, bw[0], bw[1]);
          lns::mma_bf16(acc[j][1], a, bw[2], bw[3]);
        }
      }
    }
    k0 += m.kc;
    if (k0 == m.cin) {
      k0 = 0;
      ++tap;
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int tile = first + (ml + j * lanes_m) * stride;
#pragma unroll
    for (int hn = 0; hn < 2; ++hn) {
      const int n = ng * 16 + hn * 8 + 2 * (lane & 3);
      const float b0 = bias ? rnd<bf16>(bias[n]) : 0.f;
      const float b1 = bias ? rnd<bf16>(bias[n + 1]) : 0.f;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int pos = tile * 16 + (lane >> 2) + rh * 8;
        if (pos >= g.P) continue;  // rows past H*W are never stored
        float v0 = rnd<bf16>(acc[j][hn][2 * rh]), v1 = rnd<bf16>(acc[j][hn][2 * rh + 1]);
        if (bias) {
          v0 = rnd<bf16>(v0 + b0);
          v1 = rnd<bf16>(v1 + b1);
        }
        if (epi == kGeluAll) {
          v0 = rnd<bf16>(gelu(v0));
          v1 = rnd<bf16>(gelu(v1));
        }
        if (epi == kSetH || epi == kAddH) {
          uint32_t* hp = reinterpret_cast<uint32_t*>(x.hs + pos * x.pl.ldh + n);
          if (epi == kAddH) {
            const __nv_bfloat162 old = *reinterpret_cast<const __nv_bfloat162*>(hp);
            v0 = rnd<bf16>(__low2float(old) + v0);
            v1 = rnd<bf16>(__high2float(old) + v1);
          }
          *hp = lns::pack_bf16(v0, v1);
        } else {
          const uint32_t packed = lns::pack_bf16(v0, v1);
          bf16* d = dst + pos * x.pl.ldf + (epi == kGeluAll ? x.col0 : 0) + n;
          for (int r = 0; r < x.pl.cl; ++r)
            *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(d, r)) = packed;
          if (epi == kOutZ) *reinterpret_cast<uint32_t*>(gout + pos * p.C_lat + n) = packed;
        }
      }
    }
  }
}

// Normalise this block's slice of h with its groups' statistics in gstat
// (groups of gsize channels), affine, rounded to bf16, into dst of every
// block of the cluster; then the cluster synchronises.
__device__ void norm_to_all(Ctx& x, const Params& p, cg::cluster_group& cluster, int gsize,
                            const float* scale, const float* bias, bf16* dst) {
  const int ns = x.pl.ns, ngl = ns / gsize, tid = threadIdx.x;
  for (int c = tid; c < ns; c += kBfThreads) {  // per channel: mean, inv, scale, bias
    const int gi = c / gsize;
    x.cstat[c] = x.gstat[gi];
    x.cstat[ns + c] = x.gstat[ngl + gi];
    x.cstat[2 * ns + c] = scale[c];
    x.cstat[3 * ns + c] = bias[c];
  }
  __syncthreads();
  const int nv = ns / 8, v = tid % nv, pstep = kBfThreads / nv;
  const float* cs = x.cstat + v * 8;
  for (int pos = tid / nv; pos < p.geo.P && tid < pstep * nv; pos += pstep) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x.hs + pos * x.pl.ldh + v * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    uint4 outv;
    bf16* o = reinterpret_cast<bf16*>(&outv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float t = (__bfloat162float(e[k]) - cs[k]) * cs[ns + k];
      o[k] = __float2bfloat16(t * cs[2 * ns + k] + cs[3 * ns + k]);
    }
    bf16* d = dst + pos * x.pl.ldf + x.col0 + v * 8;
    for (int r = 0; r < x.pl.cl; ++r)
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(d, r)) = outv;
  }
  cluster.sync();
}

__device__ __forceinline__ void warp_sum2(float& a, float& q) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
}

// GroupNorm(1) of the residual stream into dst of every block: f32 partial
// sums over this block's slice, exchanged through DSMEM and added in rank
// order by every block, so all use the same mean and variance.
__device__ void gn1_to_all(Ctx& x, const Params& p, cg::cluster_group& cluster,
                           const float* scale, const float* bias, bf16* dst) {
  const int P = p.geo.P, tid = threadIdx.x;
  const int nv = x.pl.ns / 8, v = tid % nv, pstep = kBfThreads / nv;
  float s1 = 0.f, s2 = 0.f;
  for (int pos = tid / nv; pos < P && tid < pstep * nv; pos += pstep) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x.hs + pos * x.pl.ldh + v * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float f = __bfloat162float(e[k]);
      s1 += f;
      s2 = fmaf(f, f, s2);
    }
  }
  warp_sum2(s1, s2);
  if (tid % 32 == 0) {
    x.wsum[tid / 32] = s1;
    x.wsum[kBfWarps + tid / 32] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, q = 0.f;
    for (int w = 0; w < kBfWarps; ++w) {
      a += x.wsum[w];
      q += x.wsum[kBfWarps + w];
    }
    for (int r = 0; r < x.pl.cl; ++r)
      *reinterpret_cast<float2*>(cluster.map_shared_rank(x.red + 2 * x.rank, r)) =
          make_float2(a, q);
  }
  cluster.sync();  // every block's partials are in every block's red
  if (tid == 0) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < x.pl.cl; ++r) {
      a += x.red[2 * r];
      q += x.red[2 * r + 1];
    }
    const float n = static_cast<float>(P) * p.C;
    const float mean = a / n;
    x.gstat[0] = mean;
    x.gstat[1] = rsqrtf(fmaxf(q / n - mean * mean, 0.f) + 1e-5f);
  }
  __syncthreads();
  norm_to_all(x, p, cluster, x.pl.ns, scale, bias, dst);
}

// GroupNorm(groups) of the residual stream into dst of every block: each
// group's C / groups channels lie inside one block's slice.
__device__ void gng_to_all(Ctx& x, const Params& p, cg::cluster_group& cluster,
                           const float* scale, const float* bias, bf16* dst) {
  const int P = p.geo.P, gsize = p.C / p.groups, ngl = x.pl.ns / gsize;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int gi = warp; gi < ngl; gi += kBfWarps) {
    float a = 0.f, q = 0.f;
    const bf16* hg = x.hs + gi * gsize;
    for (int pos = lane; pos < P; pos += 32) {
      for (int k = 0; k < gsize; ++k) {
        const float f = __bfloat162float(hg[pos * x.pl.ldh + k]);
        a += f;
        q = fmaf(f, f, q);
      }
    }
    warp_sum2(a, q);
    if (lane == 0) {
      const float n = static_cast<float>(P) * gsize;
      const float mean = a / n;
      x.gstat[gi] = mean;
      x.gstat[ngl + gi] = rsqrtf(fmaxf(q / n - mean * mean, 0.f) + 1e-6f);
    }
  }
  __syncthreads();
  norm_to_all(x, p, cluster, gsize, scale, bias, dst);
}

// At NT <= 2 two blocks fit on an SM at NS2d's shape, so the 32 clusters of
// B32 run in one wave (at one block per SM the card holds 30 clusters of 4).
template <int NT>
__global__ void __launch_bounds__(kBfThreads, NT <= 2 ? 2 : 1) rollout_bf16_kernel(Params p) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geo& g = p.geo;
  const int P = g.P, C = p.C, mt = (P + 15) / 16;
  Ctx x;
  x.pl = make_plan(P, p.C_lat, C, p.cl);
  x.rank = static_cast<int>(cluster.block_rank());
  x.col0 = x.rank * x.pl.ns;
  const int ldf = x.pl.ldf;
  x.f0 = reinterpret_cast<bf16*>(smem4);
  x.f1 = x.f0 + (P + 1) * ldf;
  x.ring = x.f1 + (P + 1) * ldf;
  x.hs = x.ring + kStages * x.pl.stage;
  x.red = reinterpret_cast<float*>(x.hs + P * x.pl.ldh);
  x.wsum = x.red + 2 * kMaxCluster;
  x.gstat = x.wsum + 2 * kBfWarps;
  x.cstat = x.gstat + 2 * x.pl.ns;
  {  // (y, x) of this lane's A row in each of its conv tiles
    const int ngr = x.pl.ns / 16, ml = (threadIdx.x / 32) / ngr, lanes_m = kBfWarps / ngr;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int pos = (ml + j * lanes_m) * 16 + (threadIdx.x & 15);
      x.ty[j] = pos < P ? pos / g.W : -1;
      x.tx[j] = pos < P ? pos - (pos / g.W) * g.W : 0;
    }
  }
  x.used = x.issued = x.is = x.ig = 0;
  stream_begin(x, p);

  // the zero rows, and z0 into the carry's columns of F1
  const int b = blockIdx.x / p.cl;
  for (int i = threadIdx.x; i < ldf; i += kBfThreads)
    x.f0[P * ldf + i] = x.f1[P * ldf + i] = __float2bfloat16(0.f);
  const bf16* z0 = static_cast<const bf16*>(p.z0) + static_cast<size_t>(b) * P * p.C_lat;
  const int zv = p.C_lat / 8;
  for (int i = threadIdx.x; i < P * zv; i += kBfThreads) {
    const int pos = i / zv, v = i - pos * zv;
    *reinterpret_cast<uint4*>(x.f1 + pos * ldf + v * 8) =
        *reinterpret_cast<const uint4*>(z0 + pos * p.C_lat + v * 8);
  }
  for (int s = 0; s < kStages - 1; ++s) issue_next(x, p);
  cluster.sync();  // every block of the cluster runs before the first DSMEM store

  // A step is a program of products (gemm_of's order), each with the norm
  // before it; one call site each keeps the kernel's code small. Buffers:
  // the carry is in F1; every norm writes F0; the convs ping-pong F0 -> F1
  // -> F0 -> h, the FFN F0 -> F1 -> h.
  const int n_prod = 2 + 5 * p.n_block;
  const int out_count = x.rank < mt ? (mt - x.rank + p.cl - 1) / p.cl : 0;
  bf16* out = static_cast<bf16*>(p.out);
  for (int step = 0; step < p.steps; ++step) {
    for (int gi = 0; gi < n_prod; ++gi) {
      const int i = (gi - 1) / 5, j = gi - 1 - 5 * i;  // block i's product j
      int epi = kGeluAll, first = 0, stride = 1, count = mt;
      const bf16* in = j == 1 || j == 4 ? x.f1 : x.f0;
      bf16* dst = j == 1 ? x.f0 : x.f1;
      const float* bias = nullptr;
      if (gi == 0) {
        epi = kSetH;
        in = x.f1;
        bias = p.in_b + x.col0;
      } else if (gi == n_prod - 1) {
        gng_to_all(x, p, cluster, p.out_gn_s + x.col0, p.out_gn_b + x.col0, x.f0);
        epi = kOutZ;
        in = x.f0;
        dst = x.f1;
        bias = p.out_b;
        first = x.rank;
        stride = p.cl;
        count = out_count;
      } else {
        if (j == 0 || j == 3) {
          const int k = (2 * i + (j == 3)) * C + x.col0;
          gn1_to_all(x, p, cluster, p.gn_s + k, p.gn_b + k, x.f0);
        }
        if (j < 3) bias = p.conv_b + (3 * i + j) * C + x.col0;
        if (j == 2 || j == 4) epi = kAddH;
      }
      product<NT>(x, p, cluster, gemm_of(p, x.pl, x.rank, gi), in, first, stride, count, bias,
                  epi, dst, out + (static_cast<size_t>(step) * p.B + b) * P * p.C_lat);
      if (epi == kGeluAll || epi == kOutZ)
        cluster.sync();  // the output is in every block (after the last step, no
                         // block touches another's shared memory)
      else
        __syncthreads();
    }
  }
  lns::cp_async_wait<0>();
}

// Blocks per sample: 8 while B x 8 blocks fill at most half the SMs, else
// 4, else 2; C / CL must be a multiple of 16. (On the H100, 8 beat 4 by
// ~10 % at NS2d's and ~30 % at SW's latent for B <= 8, and lost at B16,
// where 128 blocks of 8 share SMs or, at SW, need two waves.)
int cluster_for(int B, int C) {
  if (B <= 8 && C % 128 == 0) return 8;
  return C % 64 == 0 ? 4 : 2;
}

// 16-row tiles per warp a shape needs (the convs', and the out-projection's
// share of a block), as built (tiles_for), or 0 past kMaxTiles.
int tiles_needed(int P, int C_lat, int C, int cl) {
  const int mt = (P + 15) / 16;
  const int lanes_m = kBfWarps / (C / cl / 16), lanes_o = kBfWarps / (C_lat / 16);
  const int conv = (mt + lanes_m - 1) / lanes_m;
  const int outp = ((mt + cl - 1) / cl + lanes_o - 1) / lanes_o;
  return tiles_for(std::max(conv, outp));
}

// The bf16 kernel's limits, stated once: nullptr when it takes the shape,
// else the limit the shape breaks.
const char* bf16_limit(int B, int H, int W, int C_lat, int C, int groups) {
  static thread_local char msg[240];
  const int P = H * W, cl = cluster_for(B, C), ns = C / cl;
  if (B < 1 || H < 1 || W < 1) {
    snprintf(msg, sizeof msg, "B, H, W >= 1, got %d, %d, %d", B, H, W);
  } else if (C % 32 || ns > 16 * kBfWarps) {
    snprintf(msg, sizeof msg, "C a multiple of 32 with C/%d <= %d (a cluster of %d blocks, each "
             "C/%d channels), got C %d", cl, 16 * kBfWarps, cl, cl, C);
  } else if (C_lat % 16 || C_lat < 16 || C_lat > C || C_lat > 16 * kBfWarps) {
    snprintf(msg, sizeof msg, "C_lat a multiple of 16 in [16, min(C, %d)], got %d",
             16 * kBfWarps, C_lat);
  } else if (groups < 1 || C % groups || ns % (C / groups)) {
    snprintf(msg, sizeof msg, "groups dividing C with C/groups dividing C/%d = %d, got %d", cl, ns,
             groups);
  } else if (tiles_needed(P, C_lat, C, cl) == 0) {
    const int lanes_m = kBfWarps / (ns / 16), lanes_o = kBfWarps / (C_lat / 16);
    snprintf(msg, sizeof msg, "H*W <= %d (%d row tiles of 16 per warp), got %d",
             std::min(16 * kMaxTiles * lanes_m, 16 * cl * kMaxTiles * lanes_o), kMaxTiles, P);
  } else if (make_plan(P, C_lat, C, cl).smem > static_cast<int>(lns::kMaxDynamicSmem)) {
    snprintf(msg, sizeof msg, "shared memory per block within %zu bytes, needs %d",
             lns::kMaxDynamicSmem, make_plan(P, C_lat, C, cl).smem);
  } else {
    return nullptr;
  }
  return msg;
}

cudaLaunchConfig_t bf16_config(int blocks, int cl, int smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBfThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch the bf16 kernel built for NT tiles per warp on `stream` (n null), or
// count the clusters of this launch the card holds at once (into n).
template <int NT>
cudaError_t run_bf16(const Params& prm, cudaStream_t stream, int* n) {
  const Plan pl = make_plan(prm.geo.P, prm.C_lat, prm.C, prm.cl);
  cudaError_t e = lns::allow_smem(rollout_bf16_kernel<NT>, pl.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bf16_config(prm.B * prm.cl, prm.cl, pl.smem, stream, &attr);
  if (n) return cudaOccupancyMaxActiveClusters(n, rollout_bf16_kernel<NT>, &cfg);
  e = cudaLaunchKernelEx(&cfg, rollout_bf16_kernel<NT>, prm);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Params& prm, cudaStream_t stream, int* n) {
  switch (tiles_needed(prm.geo.P, prm.C_lat, prm.C, prm.cl)) {
    case 1: return run_bf16<1>(prm, stream, n);
    case 2: return run_bf16<2>(prm, stream, n);
    case 3: return run_bf16<3>(prm, stream, n);
    case kMaxTiles: return run_bf16<kMaxTiles>(prm, stream, n);
    default: return cudaErrorInvalidValue;
  }
}

// A Params that carries only a shape (for the occupancy query).
Params shape_params(int B, int H, int W, int C_lat, int C) {
  Params prm{};
  prm.B = B;
  prm.C_lat = C_lat;
  prm.C = C;
  prm.geo = Geo{H, W, H * W, 0, 0};
  prm.cl = cluster_for(B, C);
  return prm;
}

}  // namespace

// nullptr when the kernel of this dtype (0 f32, 1 bf16) takes the shape,
// else the limit it breaks; for bf16 also when a cluster fits on no part of
// the card (cudaOccupancyMaxActiveClusters).
extern "C" const char* lns_prop_rollout_limit(int dtype, int B, int H, int W, int C_lat, int C,
                                              int groups) {
  if (dtype == 0) return f32_limit(H * W, C_lat, C, groups);
  if (dtype != 1) return "dtype float32 or bfloat16";
  if (const char* msg = bf16_limit(B, H, W, C_lat, C, groups)) return msg;
  static thread_local char msg[200];
  const Params prm = shape_params(B, H, W, C_lat, C);
  int n = 0;
  const cudaError_t e = dispatch_bf16(prm, nullptr, &n);
  if (e != cudaSuccess || n < 1) {
    snprintf(msg, sizeof msg, "a cluster of %d blocks of %d bytes of shared memory that the card "
             "can hold (cudaOccupancyMaxActiveClusters: %d, %s)", prm.cl,
             make_plan(H * W, C_lat, C, prm.cl).smem, n, cudaGetErrorString(e));
    return msg;
  }
  return nullptr;
}

// The bf16 launch for this shape: out = {blocks per sample, blocks, shared
// memory bytes per block, clusters the card holds at once, 16-row tiles per
// warp}.
extern "C" int lns_prop_rollout_plan(int B, int H, int W, int C_lat, int C, int groups,
                                     int* out) {
  if (bf16_limit(B, H, W, C_lat, C, groups)) return cudaErrorInvalidValue;
  const Params prm = shape_params(B, H, W, C_lat, C);
  out[0] = prm.cl;
  out[1] = B * prm.cl;
  out[2] = make_plan(H * W, C_lat, C, prm.cl).smem;
  out[3] = 0;
  out[4] = tiles_needed(H * W, C_lat, C, prm.cl);
  return dispatch_bf16(prm, nullptr, &out[3]);
}

// Bytes of workspace the launch of this shape needs: for f32 the
// activations of B samples when shared memory cannot hold one sample's;
// else 0.
extern "C" long long lns_prop_rollout_workspace(int dtype, int B, int H, int W, int C_lat,
                                                int C) {
  if (dtype != 0 || !f32_in_workspace(H * W, C_lat, C)) return 0;
  return static_cast<long long>(B) * f32_act_bytes(H * W, C_lat, C);
}

extern "C" int lns_prop_rollout(int dtype, const void* z0, const void* in_w, const void* in_b,
                                const void* gn_s, const void* gn_b, const void* conv_w,
                                const void* conv_b, const void* ffn_w, const void* out_gn_s,
                                const void* out_gn_b, const void* out_w, const void* out_b,
                                void* out, void* workspace, int B, int H, int W, int C_lat, int C,
                                int n_block, int dilation, int wrap_y, int wrap_x, int groups,
                                int steps, void* stream) {
  const int P = H * W;
  Params prm{z0, in_w, static_cast<const float*>(in_b), static_cast<const float*>(gn_s),
             static_cast<const float*>(gn_b), conv_w, static_cast<const float*>(conv_b),
             ffn_w, static_cast<const float*>(out_gn_s), static_cast<const float*>(out_gn_b),
             out_w, static_cast<const float*>(out_b), out, B, C_lat, C, n_block, dilation,
             groups, steps, Geo{H, W, P, wrap_y, wrap_x}, 1, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (f32_limit(P, C_lat, C, groups)) return cudaErrorInvalidValue;
    if (f32_in_workspace(P, C_lat, C)) {
      if (workspace == nullptr) return cudaErrorInvalidValue;
      prm.ws = static_cast<float*>(workspace);
    }
    const size_t smem = f32_smem(P, C_lat, C);
    cudaError_t e = lns::allow_smem(rollout_kernel<float>, smem);
    if (e != cudaSuccess) return e;
    rollout_kernel<float><<<B, kThreads, smem, st>>>(prm);
    return cudaGetLastError();
  }
  if (dtype == 1) {
    if (bf16_limit(B, H, W, C_lat, C, groups)) return cudaErrorInvalidValue;
    prm.cl = cluster_for(B, C);
    return dispatch_bf16(prm, st, nullptr);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* lns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

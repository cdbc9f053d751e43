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
// steps, 1.37 ms for B256 x 29, at 989 TFLOP/s; the bytes, z0, the outputs
// and the weights once, take ~1.4 us). Every op of a step needs the whole
// previous op of the same sample (GN statistics, 3x3 taps), so a sample's
// work is a chain of ~20 small products per step. Two bf16 plans, each its
// own kernel body (they share Geo / tap_row, gelu and the rounding
// helpers; their GN is the same arithmetic), chosen by the launcher from
// the shape (uses_samples):
//
//  - the cluster plan (rollout_bf16_kernel) for a batch the card holds in
//    one wave: too few samples to fill 132 SMs, so each sample's chain is
//    split across a cluster of blocks; bound by the chain's latency
//    (barriers, exchanges, the weight stream per block), not arithmetic;
//  - the sample plan (rollout_bf16_kernel_samples) for a batch larger than
//    the clusters the cluster plan holds at once (B256 at NS2d: 8 waves of
//    the cluster plan): blocks own whole samples and share one weight
//    stream, the whole batch in one wave; bound in principle by the
//    tensor cores' rate and the weights' L2 traffic (multicast halves it),
//    on the H100 at about a third of that bound, held by each warpgroup's
//    chain of dependent products and its epilogues' latency (PERF.md).
//
// The rule (uses_samples): the sample plan where the shape fits it (C 128,
// H W <= 64, C_lat 16: NS2d's latent) and B is more than
// cudaOccupancyMaxActiveClusters of the cluster plan's launch (asked once
// per device and shape); else the cluster plan.
//
// A third bf16 body, the FiLM plan (rollout_film_kernel, its own entry
// point lns_prop_rollout_film), runs the conditional propagator
// (CondSimpleCNN) on the sample plan's design: its notes are at the body,
// below the sample plan's launcher.
//
// Sample-plan design (rollout_bf16_kernel_samples): a block of three
// warpgroups owns kSampWGs = 2 samples, one per consumer warpgroup, and
// computes all C output channels of every layer: each product is one m64 x
// C tile (M = H W <= 64 rows of the sample, the rows past H W reading the
// zero row and never stored) on wgmma with A from registers and B, a C x C
// weight matrix (one 3x3 tap, or an FFN matrix) in shared memory: K = C in
// 8 m64n128k16 steps. A 3x3 tap's A fragments are gathered with ldmatrix
// as in the cluster plan (tap_row per lane); the FFN's intermediate and
// the norms' outputs stay in registers in the accumulators' layout, which
// is also the A fragments' (a product's output is the next product's A as
// it stands); the convs' inputs go through shared memory (F, one buffer
// per sample, written in place once a warpgroup's reads are done), and so
// does the residual stream h, each thread touching only its own values.
// GN(1) and GN(groups) reduce over a sample inside its warpgroup (shuffles,
// partials in shared memory, named barriers): no cluster barrier and no
// exchange of activations. The weights stream once per step for every
// sample of a cluster of kSampCluster blocks: one thread of the producer
// warpgroup keeps a ring of C x C chunks (32 KB each: C rows x 2 x 64
// columns, MN-major, 128-byte swizzle) full by TMA, each chunk loaded by
// one block and multicast to every block of the cluster; each consumer
// warp releases a stage in every block of the cluster (mbarriers). in_w
// and out_w (out_w padded to 64 columns) stay in shared memory for the
// whole launch. NS2d B256: 128 blocks of 224,992 bytes (a ring of 4), one
// wave, 87 chunks (2.85 MB) a step per cluster.
//
// Cluster-plan design (rollout_bf16_kernel): one thread-block cluster of CL
// blocks per sample (CL = 8 for B <= 8 and C a multiple of 128, else 4 for C a
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
// Rounding (every kernel): products accumulate in f32 and are rounded to the
// activation dtype, then the bias (rounded the same way) is added and the
// sum rounded; GELU is computed in f32 and rounded; residual adds are
// rounded; GN statistics are f32 single-pass with the variance clamped at 0.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdio>
#include <mutex>
#include <vector>

#include "common.cuh"
#include "hopper.cuh"
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

// ---------------------------------------------------------------------------
// bf16, the sample plan: a block owns whole samples; a cluster of blocks
// shares one weight stream (TMA multicast); products on wgmma.

constexpr int kSampWGs = 2;                         // consumer warpgroups = samples per block
constexpr int kSampThreads = 128 * (kSampWGs + 1);  // and one producer warpgroup
constexpr int kSampC = 128;                         // the C it is built for: N of m64n128k16
constexpr int kSampRows = 64;                       // a sample is one m64 tile: H W <= 64
constexpr int kSampLat = 16;                        // C_lat: K of the in-projection's one k16
                                                    // step, the carry one A fragment
constexpr int kSampLdf = kSampC + 8;                // row stride (elements) of the conv input F
constexpr int kSampCluster = 2;                     // blocks sharing one weight stream
constexpr int kSampMaxRing = 6;                     // ring stages at most
constexpr int kChunk = kSampC * kSampC * 2;         // bytes of a C x C matrix (a 3x3 tap or
constexpr int kHalf = kChunk / 2;                   // an FFN matrix): two 64-column halves
constexpr int kChunksPerBlock = 29;                 // 3 x 9 conv taps and 2 FFN matrices
// a warpgroup's GroupNorm scratch (floats): GN(1) partials [2][4 warps][2]
// (double-buffered), GN(groups)'s per-column (mean, inv) [C][2]
constexpr int kGnFloats = 2 * 4 * 2 + kSampC * 2;

// The sample plan's shared memory, byte offsets from the first 1024-byte
// boundary: the ring [ring][2 halves][C rows][64] (MN-major B operands,
// 128-byte swizzle, as TMA writes them), out_w [C rows][64] (columns past
// C_lat zero), in_w [2 halves][C_lat rows][64], then per sample F [P+1][C+8]
// (row P zero) and h [64][C+8], per warpgroup the GN scratch, the barriers
// full[ring], empty[ring].
struct SampPlan {
  int cl, ring;  // blocks per cluster, ring stages
  int off_out, off_in, off_f, off_h, off_gn, off_bar;
  int smem;      // bytes per block, with the alignment's slack
};

SampPlan make_samp_plan(int P) {
  SampPlan s;
  s.cl = kSampCluster;
  const int fixed = kSampC * 128 + 2 * kSampLat * 128 + kSampWGs * (P + 1) * kSampLdf * 2 +
                    kSampWGs * kSampRows * kSampLdf * 2 + kSampWGs * kGnFloats * 4;
  s.ring = std::min(kSampMaxRing, (static_cast<int>(lns::kMaxDynamicSmem) - 1024 - fixed -
                                   16 * kSampMaxRing) / kChunk);
  s.off_out = s.ring * kChunk;
  s.off_in = s.off_out + kSampC * 128;
  s.off_f = s.off_in + 2 * kSampLat * 128;
  s.off_h = s.off_f + kSampWGs * (P + 1) * kSampLdf * 2;
  s.off_gn = s.off_h + kSampWGs * kSampRows * kSampLdf * 2;
  s.off_bar = s.off_gn + kSampWGs * kGnFloats * 4;
  s.smem = 1024 + s.off_bar + 16 * s.ring;
  return s;
}

// Blocks of a sample-plan launch: B / kSampWGs, whole clusters.
int samp_blocks(int B, int cl) {
  const int blocks = (B + kSampWGs - 1) / kSampWGs;
  return (blocks + cl - 1) / cl * cl;
}

// Values of a warpgroup's m64 x C tile are handled in pairs, as the wgmma
// accumulators hold them: pair p (< 32) of thread (warp q, lane 4 g + u) is
// row r0 + 8 (p % 2) (r0 = 16 q + g), columns 64 (p / 16) + 8 ((p % 16) / 2)
// + 2 u and the next, accumulators acc[2 p] and acc[2 p + 1]. A
// Frag holds 32 pairs as packed bf16, pair p at [p / 4][p % 4]: the four
// pairs of [k] are the A fragment of columns 16 k .. 16 k + 15 (wgmma with
// A from registers), so a product's output is the next product's A as it
// stands. The residual stream h lives in shared memory ([64 rows][C + 8]
// per sample, rows past H W zero) in the same places, and each thread reads
// and writes only its own pairs there (hword), so h needs no barrier.
using Frag = uint32_t[8][4];

struct Lane {
  int lane, q, u, r0;
  int ay, ax;  // (y, x) of the row this lane addresses for ldmatrix (16 q + lane % 16);
               // ay < 0 past H W
};

__device__ __forceinline__ int pair_row(const Lane& L, int p) { return L.r0 + 8 * (p & 1); }
__device__ __forceinline__ int pair_col(const Lane& L, int p) {
  return 64 * (p >> 4) + 8 * ((p & 15) >> 1) + 2 * L.u;
}
// pair p of this thread in a sample's [rows][C + 8] buffer (h or F)
__device__ __forceinline__ uint32_t& hword(bf16* hs, const Lane& L, int p) {
  return *reinterpret_cast<uint32_t*>(hs + pair_row(L, p) * kSampLdf + pair_col(L, p));
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// columns c, c + 1 of an f32 bias, each rounded to bf16
__device__ __forceinline__ float2 bias2(const float* b, int c) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(b + c));
  return make_float2(rnd<bf16>(v.x), rnd<bf16>(v.y));
}

// The weight stream: chunk f (in the order the consumers take them) lies in
// stage f % depth.
struct Ring {
  const uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int depth, cl;
};

// acc += a . W, W the stream's chunk f (K = C in 8 k16 steps, each one
// m64n128 wgmma over both 64-column halves), A in registers; then the warp
// releases the chunk's stage in every block of the cluster. Straight-line
// between the fences, so ptxas keeps the 8 wgmma in flight together.
__device__ __forceinline__ void chunk_product(float (&acc)[64], const Frag& a, const Ring& r,
                                              int f, int lane) {
  const int st = f % r.depth;
  const uint8_t* slot = r.base + st * kChunk;
  lns::wgmma_fence_regs(acc);
  lns::mbar_wait(&r.full[st], (f / r.depth) & 1);
  lns::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    lns::wgmma_n128_rs<1>(acc, a[ks], lns::desc_mnmajor_wide(slot + ks * 2048, kHalf));
  lns::wgmma_commit();
  lns::wgmma_wait<0>();
  lns::wgmma_fence_regs(acc);
  if (r.cl > 1) {
    if (lane < r.cl) lns::mbar_arrive_cluster(&r.empty[st], lane);
  } else if (lane == 0) {
    lns::mbar_arrive(&r.empty[st]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}

// acc = the 3x3 conv (dilation dil) of the sample's F, its taps the stream's
// chunks f .. f + 8: each lane's ldmatrix row is tap_row of its (y, x).
__device__ void conv_taps(float (&acc)[64], const bf16* F, const Geo& g, int dil, const Lane& L,
                          const Ring& r, int& f) {
  zero(acc);
#pragma unroll 1
  for (int t = 0; t < 9; ++t, ++f) {
    const int dy = (t / 3 - 1) * dil, dx = (t % 3 - 1) * dil;
    const bf16* arow = F + tap_row(g, L.ay, L.ax, dy, dx) * kSampLdf + ((L.lane >> 4) << 3);
    Frag a;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) lns::ldsm_x4(a[ks], arow + ks * 16);
    chunk_product(acc, a, r, f, L.lane);
  }
}

// GroupNorm(1)'s (mean, inv) of the sample's residual stream: f32
// single-pass statistics over its P rows (rows past P hold zeros), the
// variance clamped at 0; red [4 warps][2].
__device__ float2 gn1_stats(bf16* hs, float* red, int P, const Lane& L, int bar) {
  float a = 0.f, q = 0.f;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const float2 v = unpack2(hword(hs, L, p));
    a += v.x;
    a += v.y;
    q = fmaf(v.x, v.x, q);
    q = fmaf(v.y, v.y, q);
  }
  warp_sum2(a, q);
  if (L.lane == 0) {
    red[2 * L.q] = a;
    red[2 * L.q + 1] = q;
  }
  lns::bar_sync(bar, 128);
  a = red[0] + red[2] + red[4] + red[6];
  q = red[1] + red[3] + red[5] + red[7];
  const float n = static_cast<float>(P) * kSampC, mean = a / n;
  return make_float2(mean, rsqrtf(fmaxf(q / n - mean * mean, 0.f) + 1e-5f));
}

// GroupNorm(groups)'s per-column (mean, inv) into cst [C][2] (groups of gs
// channels: gs divides C / 4 = 32 by bf16_limit, so a group's columns are
// lanes of one warp): thread wt sums column wt of h over the P rows, then
// the group's lanes add their sums.
__device__ void gng_stats(const bf16* hs, float* cst, int P, int gs, int wt, int bar) {
  lns::bar_sync(bar, 128);  // every thread's h is in place
  float a = 0.f, q = 0.f;
  for (int row = 0; row < P; ++row) {
    const float v = __bfloat162float(hs[row * kSampLdf + wt]);
    a += v;
    q = fmaf(v, v, q);
  }
  for (int off = 1; off < gs; off <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  const float n = static_cast<float>(P) * gs, mean = a / n;
  cst[2 * wt] = mean;
  cst[2 * wt + 1] = rsqrtf(fmaxf(q / n - mean * mean, 0.f) + 1e-6f);
  lns::bar_sync(bar, 128);
}

// o = the normalised residual stream, (x - mean) inv scale + bias rounded
// to bf16, in h's layout: (mean, inv) per column from cst (PER_COL) or mi.
template <bool PER_COL>
__device__ __forceinline__ void gn_apply(bf16* hs, Frag& o, float2 mi, const float* cst,
                                         const float* scale, const float* bias, const Lane& L) {
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const int c = pair_col(L, p);
    const float2 v = unpack2(hword(hs, L, p));
    const float2 s = __ldg(reinterpret_cast<const float2*>(scale + c));
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
    float2 m0 = mi, m1 = mi;
    if (PER_COL) {
      m0 = *reinterpret_cast<const float2*>(cst + 2 * c);
      m1 = *reinterpret_cast<const float2*>(cst + 2 * c + 2);
    }
    const float t0 = (v.x - m0.x) * m0.y, t1 = (v.y - m1.x) * m1.y;
    o[p >> 2][p & 3] = lns::pack_bf16(t0 * s.x + b.x, t1 * s.y + b.y);
  }
}

// the pairs of o in rows < P into the sample's F
__device__ __forceinline__ void store_f(bf16* F, const Frag& o, int P, const Lane& L) {
#pragma unroll
  for (int p = 0; p < 32; ++p)
    if (pair_row(L, p) < P) hword(F, L, p) = o[p >> 2][p & 3];
}

// o = bf16(gelu(bf16(bf16(acc) + bias))) (bias null: none)
__device__ __forceinline__ void gelu_pairs(const float (&acc)[64], const float* bias, Frag& o,
                                           const Lane& L) {
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const float2 b = bias ? bias2(bias, pair_col(L, p)) : make_float2(0.f, 0.f);
    float v0 = rnd<bf16>(acc[2 * p]), v1 = rnd<bf16>(acc[2 * p + 1]);
    if (bias) {
      v0 = rnd<bf16>(v0 + b.x);
      v1 = rnd<bf16>(v1 + b.y);
    }
    o[p >> 2][p & 3] = lns::pack_bf16(gelu(v0), gelu(v1));
  }
}

// h = bf16(bf16(acc) + bias) (ADD: h = bf16(h + that)); rows past P stay zero
template <bool ADD>
__device__ __forceinline__ void residual_pairs(const float (&acc)[64], const float* bias,
                                               bf16* hs, int P, const Lane& L) {
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const float2 b = bias ? bias2(bias, pair_col(L, p)) : make_float2(0.f, 0.f);
    float v0 = rnd<bf16>(acc[2 * p]), v1 = rnd<bf16>(acc[2 * p + 1]);
    if (bias) {
      v0 = rnd<bf16>(v0 + b.x);
      v1 = rnd<bf16>(v1 + b.y);
    }
    if (ADD) {
      const float2 old = unpack2(hword(hs, L, p));
      v0 += old.x;
      v1 += old.y;
    }
    hword(hs, L, p) = pair_row(L, p) < P ? lns::pack_bf16(v0, v1) : 0u;
  }
}

// One block runs kSampWGs samples (warpgroup w the sample blockIdx.x *
// kSampWGs + w; past B it computes on zeros and stores nothing) through
// every step; warpgroup kSampWGs produces: one thread keeps the ring of
// weight chunks full, each chunk loaded by TMA once per cluster, by block f
// % cl, multicast to every block. The consumer warpgroups run each product
// as one m64 x C wgmma tile (A from registers), the norms and epilogues on
// their own registers and their sample's shared memory, synchronising only
// among themselves (named barrier 1 + w); they meet the other warpgroups
// only at the ring's stages.
__global__ void __launch_bounds__(kSampThreads, 1)
rollout_bf16_kernel_samples(const __grid_constant__ CUtensorMap map_conv,
                            const __grid_constant__ CUtensorMap map_ffn, Params p, SampPlan sp) {
  extern __shared__ uint8_t smem_raw[];
  // the first 1024-byte boundary, reached by pointer arithmetic on smem_raw
  // so that the compiler keeps every access below in the shared window
  // (LDS / STS with 32-bit addresses, not generic 64-bit ones)
  uint8_t* base = smem_raw + ((1024 - (lns::smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int C = kSampC, C_lat = kSampLat;
  const Geo& g = p.geo;
  const int P = g.P, tid = threadIdx.x;
  uint8_t* ring = base;
  uint8_t* out_s = base + sp.off_out;
  uint8_t* in_s = base + sp.off_in;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + sp.off_bar);
  uint64_t* empty = full + sp.ring;

  if (tid == 0) {
    for (int i = 0; i < sp.ring; ++i) {
      lns::mbar_init(&full[i], 1);
      lns::mbar_init(&empty[i], sp.cl * kSampWGs * 4);  // every consumer warp of the cluster
    }
    lns::mbar_fence_init();
  }
  {  // in_w and out_w into their swizzled layouts; the zero rows of F
    const bf16* in_w = static_cast<const bf16*>(p.in_w);
    for (int i = tid; i < C_lat * (C / 8); i += kSampThreads) {
      const int r = i / (C / 8), c8 = i % (C / 8);
      uint8_t* d = in_s + (c8 / 8) * C_lat * 128 + r * 128 + (((c8 % 8) ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(in_w + r * C + 8 * c8);
    }
    const bf16* out_w = static_cast<const bf16*>(p.out_w);
    for (int i = tid; i < C * 8; i += kSampThreads) {
      const int r = i / 8, c8 = i % 8;
      *reinterpret_cast<uint4*>(out_s + r * 128 + ((c8 ^ (r & 7)) << 4)) =
          8 * c8 < C_lat ? *reinterpret_cast<const uint4*>(out_w + r * C_lat + 8 * c8)
                         : make_uint4(0, 0, 0, 0);
    }
    bf16* f0 = reinterpret_cast<bf16*>(base + sp.off_f);
    for (int i = tid; i < kSampWGs * C / 2; i += kSampThreads) {
      bf16* zero_row = f0 + ((i / (C / 2)) * (P + 1) + P) * kSampLdf;
      reinterpret_cast<uint32_t*>(zero_row)[i % (C / 2)] = 0u;
    }
    lns::fence_async_shared();  // the weights' stores, visible to wgmma
  }
  __syncthreads();
  if (sp.cl > 1) lns::cluster_sync();  // every block's barriers exist before a multicast lands

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == kSampWGs) {
    // producer: the chunks of every step in order, each stage refilled once
    // every consumer warp of the cluster has released it; its warpgroup
    // gives registers to the consumers (an SM quadrant holds two consumer
    // warps and one producer warp: 2 x 224 + 56 of its 512 per lane)
    lns::setmaxnreg_dec<56>();
    if (tid == kSampWGs * 128) {
      const uint32_t rank = sp.cl > 1 ? lns::cluster_rank() : 0;
      const uint16_t mask = static_cast<uint16_t>((1 << sp.cl) - 1);
      const int per_step = kChunksPerBlock * p.n_block;
      int f = 0;
      for (int step = 0; step < p.steps; ++step)
        for (int c = 0; c < per_step; ++c, ++f) {
          const int st = f % sp.ring;
          if (f >= sp.ring) lns::mbar_wait(&empty[st], ((f / sp.ring) - 1) & 1);
          lns::mbar_expect_tx(&full[st], kChunk);
          if (f % sp.cl != static_cast<int>(rank)) continue;  // another block loads this chunk
          const int i = c / kChunksPerBlock, j = c - kChunksPerBlock * i;
          const CUtensorMap* map = j < 27 ? &map_conv : &map_ffn;
          const int c2 = j < 27 ? j % 9 : 2 * i + j - 27, c3 = j < 27 ? 3 * i + j / 9 : 0;
          for (int hf = 0; hf < 2; ++hf) {
            uint8_t* dst = ring + st * kChunk + hf * kHalf;
            if (sp.cl > 1)
              lns::tma_load_multicast(dst, map, &full[st], 64 * hf, 0, c2, c3, mask);
            else
              lns::tma_load(dst, map, &full[st], 64 * hf, 0, c2, c3);
          }
        }
    }
  } else {
    lns::setmaxnreg_inc<224>();
    const int wg = role, wt = tid % 128, bar = 1 + wg;
    Lane L;
    L.lane = wt % 32;
    L.q = wt / 32;
    L.u = L.lane % 4;
    L.r0 = 16 * L.q + L.lane / 4;
    {
      const int row = 16 * L.q + (L.lane & 15);
      L.ay = row < P ? row / g.W : -1;
      L.ax = row < P ? row % g.W : 0;
    }
    bf16* F = reinterpret_cast<bf16*>(base + sp.off_f) + wg * (P + 1) * kSampLdf;
    bf16* hs = reinterpret_cast<bf16*>(base + sp.off_h) + wg * kSampRows * kSampLdf;
    float* red1 = reinterpret_cast<float*>(base + sp.off_gn) + wg * kGnFloats;  // [2][4][2]
    float* cst = red1 + 16;                                                     // [C][2]
    const Ring r{ring, full, empty, sp.ring, sp.cl};
    const int b = blockIdx.x * kSampWGs + wg;
    const bool live = b < p.B;

    // z0 as the in-projection's A fragments (rows past P, and samples past B, zero)
    uint32_t z[4];
    {
      const bf16* z0 = static_cast<const bf16*>(p.z0) + static_cast<size_t>(b) * P * C_lat;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = L.r0 + 8 * (e & 1), col = 8 * (e >> 1) + 2 * L.u;
        z[e] = live && row < P ? *reinterpret_cast<const uint32_t*>(z0 + row * C_lat + col) : 0u;
      }
    }
    bf16* out = static_cast<bf16*>(p.out);
    const int gs = C / p.groups;
    int f = 0, n1 = 0;
    Frag a;
    float acc[64];
    for (int step = 0; step < p.steps; ++step) {
      // h = z @ in_w + in_b
      zero(acc);
      lns::wgmma_fence_regs(acc);
      lns::wgmma_fence();
      lns::wgmma_n128_rs<1>(acc, z, lns::desc_mnmajor_wide(in_s, C_lat * 128));
      lns::wgmma_commit();
      lns::wgmma_wait<0>();
      lns::wgmma_fence_regs(acc);
      residual_pairs<false>(acc, p.in_b, hs, P, L);

#pragma unroll 1
      for (int i = 0; i < p.n_block; ++i) {
        const float* gs_ = p.gn_s + 2 * i * C;
        const float* gb_ = p.gn_b + 2 * i * C;
        const float* cb = p.conv_b + 3 * i * C;
        // t = GN1(h) into F; the barrier in gn1_stats ends the last conv's reads of F
        float2 mi = gn1_stats(hs, red1 + 8 * (n1++ & 1), P, L, bar);
        gn_apply<false>(hs, a, mi, nullptr, gs_, gb_, L);
        store_f(F, a, P, L);
        lns::bar_sync(bar, 128);
        // t = gelu(conv3(t)); t = gelu(conv3_dil(t)), each in place in F
#pragma unroll 1
        for (int j = 0; j < 2; ++j) {
          conv_taps(acc, F, g, j ? p.dilation : 1, L, r, f);
          gelu_pairs(acc, cb + j * C, a, L);
          lns::bar_sync(bar, 128);  // every warp's reads of F are done
          store_f(F, a, P, L);
          lns::bar_sync(bar, 128);
        }
        // h = h + conv3(t)
        conv_taps(acc, F, g, 1, L, r, f);
        residual_pairs<true>(acc, cb + 2 * C, hs, P, L);
        // h = h + gelu(GN1(h) @ ffn0) @ ffn1, all in registers
        mi = gn1_stats(hs, red1 + 8 * (n1++ & 1), P, L, bar);
        gn_apply<false>(hs, a, mi, nullptr, gs_ + C, gb_ + C, L);
        zero(acc);
        chunk_product(acc, a, r, f++, L.lane);
        gelu_pairs(acc, nullptr, a, L);
        zero(acc);
        chunk_product(acc, a, r, f++, L.lane);
        residual_pairs<true>(acc, nullptr, hs, P, L);
      }
      // z = GN(groups)(h) @ out_w + out_b (out_w padded to 64 columns)
      gng_stats(hs, cst, P, gs, wt, bar);
      gn_apply<true>(hs, a, make_float2(0.f, 0.f), cst, p.out_gn_s, p.out_gn_b, L);
      float az[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) az[i] = 0.f;
      lns::wgmma_fence_regs(az);
      lns::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        lns::wgmma_n64_rs<1>(az, a[ks], lns::desc_mnmajor(out_s + ks * 2048));
      lns::wgmma_commit();
      lns::wgmma_wait<0>();
      lns::wgmma_fence_regs(az);
      bf16* o = out + (static_cast<size_t>(step) * p.B + b) * P * C_lat;
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // the n8 column blocks of C_lat
        const int c = 8 * k + 2 * L.u;
        const float2 bz = bias2(p.out_b, c);
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = L.r0 + 8 * rh;
          const float v0 = rnd<bf16>(rnd<bf16>(az[4 * k + 2 * rh]) + bz.x);
          const float v1 = rnd<bf16>(rnd<bf16>(az[4 * k + 2 * rh + 1]) + bz.y);
          const uint32_t v = row < P ? lns::pack_bf16(v0, v1) : 0u;
          z[2 * k + rh] = v;
          if (live && row < P) *reinterpret_cast<uint32_t*>(o + row * C_lat + c) = v;
        }
      }
    }
  }
  if (sp.cl > 1) lns::cluster_sync();  // no block leaves while its cluster may reach it
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

cudaError_t cluster_plan_at_once(int B, int H, int W, int C_lat, int C, int* n);

// The rule that chooses the bf16 plan, stated once: the sample plan where
// the shape fits it (C 128, the N of one m64n128k16 wgmma; H W <= 64, one
// m64 tile a sample; C_lat 16, NS2d's) and the batch is more than the
// clusters the cluster plan holds at once (its launch would take more than
// one wave); else the cluster plan. Shapes outside bf16_limit take neither.
bool uses_samples(int B, int H, int W, int C_lat, int C) {
  int n = 0;
  return C == kSampC && H * W <= kSampRows && C_lat == kSampLat &&
         cluster_plan_at_once(B, H, W, C_lat, C, &n) == cudaSuccess && B > n;
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

// Clusters of the cluster plan's launch at this shape that the card holds at
// once (cudaOccupancyMaxActiveClusters), asked once per device and shape.
cudaError_t cluster_plan_at_once(int B, int H, int W, int C_lat, int C, int* n) {
  struct Seen {
    int dev, P, C_lat, C, cl, n;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const Params prm = shape_params(B, H, W, C_lat, C);
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen)
    if (s.dev == dev && s.P == H * W && s.C_lat == C_lat && s.C == C && s.cl == prm.cl) {
      *n = s.n;
      return cudaSuccess;
    }
  e = dispatch_bf16(prm, nullptr, n);
  if (e == cudaSuccess) seen.push_back({dev, H * W, C_lat, C, prm.cl, *n});
  return e;
}

// Launch the sample-plan kernel on `stream` (n null), or count the clusters
// of this launch the card holds at once (into n). The weights stream
// through two tensor maps: conv_w as [3 n_block convs][9 taps][C in][C
// out], ffn_w as [2 n_block][C][C], boxes of C rows x 64 output columns.
cudaError_t run_samples(const Params& prm, cudaStream_t stream, int* n) {
  const SampPlan sp = make_samp_plan(prm.geo.P);
  cudaError_t e = lns::allow_smem(rollout_bf16_kernel_samples, sp.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = bf16_config(samp_blocks(prm.B, sp.cl), sp.cl, sp.smem, stream, &attr);
  cfg.blockDim = dim3(kSampThreads);
  if (n) return cudaOccupancyMaxActiveClusters(n, rollout_bf16_kernel_samples, &cfg);
  const uint64_t C = prm.C, nb = prm.n_block;
  const uint32_t box = static_cast<uint32_t>(C);
  CUtensorMap map_conv, map_ffn;
  e = lns::make_map(&map_conv, prm.conv_w, {C, C, 9, 3 * nb}, {C * 2, C * C * 2, 9 * C * C * 2},
                    {64, box, 1, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&map_ffn, prm.ffn_w, {C, C, 2 * nb, 1},
                      {C * 2, C * C * 2, 2 * nb * C * C * 2}, {64, box, 1, 1});
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, rollout_bf16_kernel_samples, map_conv, map_ffn, prm, sp);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, the FiLM plan (rollout_film_kernel): every step of the conditional
// propagator (CondSimpleCNN, the conditional two-phase family's) in one
// launch, on the sample plan's design.
//
// It replaces no Pallas kernel: the JAX package steps its conditional
// propagator as modules (lns_tpu/models/latent_dynamics.py:
// _pallas_rollout_ok), and so did the port, at ~25 elementwise, cast and
// norm passes per block per step over the [B, H W, C] activation (about
// 945 ms of the ~1.02 s predict at B2048 x 78 on an H100, PERF.md). Each
// step:
//   h = z @ in_w + in_b
//   n_block x [ t = gelu(conv3(GN1(h)));  u = (bf16(conv3_dil(t)) + bias) + e  (f32)
//               g = conv3(bf16(gelu(GN1(u))))  (GN1 and gelu in f32)
//               t = GN1((h + g)(1 + c))  (f32);  h = bf16(h + g) + gelu(t @ ffn0) @ ffn1 ]
//   z = GN(32)(h) @ out_w + out_b
// with e, c [n_block, B, C] f32 each sample's projection and FiLM scale
// (CondSimpleCNN.conditioning, once per predict). It rounds where the
// module step does: a product and its bias each to bf16, u and the FiLM
// branch unrounded in f32, x + g rounded where it is the residual and read
// unrounded by the FiLM product, the bf16 GELU as ops.activations.gelu
// computes it (erfc, its result rounded before the last product); every
// GroupNorm's statistics single-pass in f32, the bf16 ones (conv1.0, GN(32))
// applied as the module's kernel 3 does (sc and sh rounded to bf16), the
// f32 ones (cond_conv1.0, ffn.0) as the plain version's _gn.
//
// What bounds it on an H100: the products, ~0.40 GFLOP a sample-step at
// 7x15, C 128, n_block 4 (twelve 3x3 convs, eight C x C matrices, the two
// projections): ~65 ms for B2048 x 78 steps at 989 TFLOP/s (~79 ms with
// the rows padded to two m64 tiles); and the weights' L2 traffic, 29 C x C
// chunks (32 KB) per block per step for every sample, ~310 GB a predict at
// clusters of 2 (~50 ms at L2 rates). Device memory sees z0, the outputs
// and the weights once.
//
// Design: a block of three warpgroups owns one sample at a time and walks
// the batch persistently (passes of gridDim.x samples, the grid sized so
// that every pass is as full as the batch allows): each step's 29 n_block
// chunks stream through the sample plan's mbarrier ring, loaded once per
// cluster of kFilmCluster blocks by TMA multicast, while the activations
// never leave shared memory and registers across all the steps. The
// sample's H W <= 128 rows are two m64 tiles, one per consumer warpgroup
// (rows past H W read the zero row of F and are never stored); each
// product is the warpgroup's m64 x C wgmma chain with A from registers,
// through the sample plan's helpers (conv_taps, chunk_product, the Frag
// and Lane layout). The dilated taps reach across the halves (+-32 rows at
// 7x15, dilation 2), so the conv input F is shared by both warpgroups:
// every write of F and every GroupNorm reduction ends at a named barrier
// over the 256 consumer threads (film_stats, bar 1); GN(32)'s column sums
// meet there too. The f32 stretch (u, its GN and GELU, the FiLM product
// and its GN) stays in the accumulators' registers. The in-projection is 4
// k16 steps with the carry as A (C_lat 64), the out-projection 8 m64n64k16
// steps; in_w and out_w stay in shared memory for the launch.
//
// What the card taught (H100, B2048 x 78; PERF.md): the body takes ~290 ms,
// ~22 % of its bound, and the epilogues hold it, not the tensor cores: a
// copy without the products ran ~165 ms, one without the GELUs ~170 ms.
// Two consumer warps per scheduler, in step at the sample's barriers, hide
// little latency. The GELUs' erfc is therefore branch-free (erfc_abs), the
// consumers take 240 registers (no spills), and a bias is a template
// parameter of an epilogue. Clusters of 4 ran slower (~361 against ~333
// ms), and pipelining a conv's taps (wait<1>) gained nothing.
//
// Shared memory (P = H W): the ring, ring x 32 KB; out_w 16 KB; in_w 16 KB;
// F (P + 1) x (C + 8) bf16 (28,832 bytes at 7x15); h 128 x (C + 8) bf16
// (34,816); the GroupNorm scratch 2,688; the barriers. At 7x15: a ring of
// 4, 231,264 bytes with the alignment's slack (a ring of 3 at H W 128). No
// atomics: two runs give the same bits.

constexpr int kFilmWGs = 2;                          // consumer warpgroups: one m64 half each
constexpr int kFilmThreads = 128 * (kFilmWGs + 1);   // and one producer warpgroup
constexpr int kFilmRows = 64 * kFilmWGs;             // a sample's rows: H W <= 128
constexpr int kFilmLat = 64;                         // C_lat: K of the in-projection, N of
                                                     // the out-projection
constexpr int kFilmGroups = 32;                      // the out-projection's GroupNorm
constexpr int kFilmCluster = 2;                      // blocks sharing one weight stream
constexpr int kFilmMaxRing = 6;
// GN scratch (floats): GN(1) partials [2][8 warps][2] (double-buffered);
// GN(32)'s per-group partials [2 halves][32][2]; per warpgroup the
// per-column (mean, inv) [C][2]
constexpr int kFilmGnFloats = 2 * 8 * 2 + kFilmWGs * kFilmGroups * 2 + kFilmWGs * kSampC * 2;

struct FilmParams {
  const bf16* z0;        // [B, P, C_lat]
  const bf16* in_w;      // [C_lat, C]
  const float* in_b;     // [C]
  const float* gn_s;     // [n_block, 3, C]  (conv1.0, cond_conv1.0, ffn.0)
  const float* gn_b;     // [n_block, 3, C]
  const float* conv_b;   // [n_block, 3, C]  (conv1.1, conv1.3, cond_conv1.2)
  const float* out_gn_s;  // [C]
  const float* out_gn_b;  // [C]
  const bf16* out_w;     // [C, C_lat]
  const float* out_b;    // [C_lat]
  const float* e;        // [n_block, B, C] each sample's projection of the embedding
  const float* c;        // [n_block, B, C] each sample's FiLM scale
  bf16* out;             // [steps, B, P, C_lat]
  int B, n_block, dilation, steps, passes;
  Geo geo;
};

// The FiLM plan's shared memory, byte offsets from the first 1024-byte
// boundary: the ring, out_w [C rows][64] and in_w [2 halves][C_lat rows][64]
// (MN-major, 128-byte swizzle), F [P+1][C+8] (row P zero), h [128][C+8]
// (rows past P zero), the GN scratch, the barriers full[ring], empty[ring].
struct FilmPlan {
  int cl, ring;
  int off_out, off_in, off_f, off_h, off_gn, off_bar;
  int smem;  // bytes per block, with the alignment's slack
};

FilmPlan make_film_plan(int P) {
  FilmPlan s;
  s.cl = kFilmCluster;
  const int fixed = kSampC * 128 + 2 * kFilmLat * 128 + (P + 1) * kSampLdf * 2 +
                    kFilmRows * kSampLdf * 2 + kFilmGnFloats * 4;
  s.ring = std::min(kFilmMaxRing, (static_cast<int>(lns::kMaxDynamicSmem) - 1024 - fixed -
                                   16 * kFilmMaxRing) / kChunk);
  s.off_out = s.ring * kChunk;
  s.off_in = s.off_out + kSampC * 128;
  s.off_f = s.off_in + 2 * kFilmLat * 128;
  s.off_h = s.off_f + (P + 1) * kSampLdf * 2;
  s.off_gn = s.off_h + kFilmRows * kSampLdf * 2;
  s.off_bar = s.off_gn + kFilmGnFloats * 4;
  s.smem = 1024 + s.off_bar + 16 * s.ring;
  return s;
}

// erfc(|y|), branch-free: Numerical Recipes' erfcc (a Chebyshev fit,
// fractional error under 1.2e-7 everywhere), k exp(P(k) - y^2) with k = 1 /
// (1 + |y| / 2). CUDA's erfcf and erff branch on the argument's range,
// which diverges inside a warp: with them the GELUs took ~38 % of the FiLM
// plan's time at B2048 x 78, this form ~10 % less (PERF.md).
__device__ __forceinline__ float erfc_abs(float y) {
  const float t = fabsf(y);
  const float k = __fdividef(1.f, fmaf(0.5f, t, 1.f));
  float p = 0.17087277f;
  p = fmaf(p, k, -0.82215223f);
  p = fmaf(p, k, 1.48851587f);
  p = fmaf(p, k, -1.13520398f);
  p = fmaf(p, k, 0.27886807f);
  p = fmaf(p, k, -0.18628806f);
  p = fmaf(p, k, 0.09678418f);
  p = fmaf(p, k, 0.37409196f);
  p = fmaf(p, k, 1.00002368f);
  p = fmaf(p, k, -1.26551223f);
  return k * __expf(p - t * t);
}

// bf16 GELU as the module computes it (ops.activations.gelu): 0.5 x erfc(-x
// c) with c = bf16(1 / sqrt 2), erfc flushed to 0 below f32's normal range
// and rounded to bf16 before the product; the result is rounded once, by
// the caller's pack_bf16
__device__ __forceinline__ float gelu_bf16(float x) {
  const float y = x * 0.70703125f, m = erfc_abs(y);
  const float e = y > 0.f ? 2.f - m : m;  // erfc(-y)
  return x * rnd<bf16>(e > 1.1754942e-38f ? e : 0.f) * 0.5f;
}

// f32 GELU as torch computes it (F.gelu): x 0.5 (1 + erf(x / sqrt 2)), erf
// rounded to f32 (as 1 - erfc) before the sum
__device__ __forceinline__ float gelu_f32(float x) {
  const float y = x * 0.70710678118654752f, erf_abs = 1.f - erfc_abs(y);
  return x * 0.5f * (y > 0.f ? 1.f + erf_abs : 1.f - erf_abs);
}

// o = bf16(gelu_bf16(bf16(bf16(acc) + bias))) (BIAS false: of bf16(acc)).
// BIAS is a template parameter: a run-time test of the pointer put each
// pair in its own basic block.
template <bool BIAS>
__device__ __forceinline__ void film_gelu_pairs(const float (&acc)[64], const float* bias,
                                                Frag& o, const Lane& L) {
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    float v0 = rnd<bf16>(acc[2 * p]), v1 = rnd<bf16>(acc[2 * p + 1]);
    if (BIAS) {
      const float2 b = bias2(bias, pair_col(L, p));
      v0 = rnd<bf16>(v0 + b.x);
      v1 = rnd<bf16>(v1 + b.y);
    }
    o[p >> 2][p & 3] = lns::pack_bf16(gelu_bf16(v0), gelu_bf16(v1));
  }
}

// GroupNorm(1)'s (mean, inv) over the sample from each consumer thread's
// partial sums (a, q) over its pairs in rows < P: the 8 consumer warps'
// sums meet in red at a named barrier over both warpgroups, and every
// thread adds them in warp order, so both halves use the same statistics.
// The barrier also ends every read of F before it.
__device__ __forceinline__ float2 film_stats(float a, float q, float* red, int P, const Lane& L,
                                             int wg) {
  warp_sum2(a, q);
  if (L.lane == 0) {
    red[2 * (4 * wg + L.q)] = a;
    red[2 * (4 * wg + L.q) + 1] = q;
  }
  lns::bar_sync(1, 2 * 128);
  a = 0.f;
  q = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    a += red[2 * w];
    q += red[2 * w + 1];
  }
  const float n = static_cast<float>(P) * kSampC, mean = a / n;
  return make_float2(mean, rsqrtf(fmaxf(q / n - mean * mean, 0.f) + 1e-5f));
}

// o = the residual stream normalised as the module's bf16 GroupNorm does it
// (kernel 3's bf16 arithmetic, group_norm_swish_plain): sc = inv scale, sh =
// bias - mean sc in f32, each rounded to bf16, then y = bf16(bf16(h sc) +
// sh); (mean, inv) per column from cst (PER_COL) or mi
template <bool PER_COL>
__device__ __forceinline__ void gn_apply_sc(bf16* hs, Frag& o, float2 mi, const float* cst,
                                            const float* scale, const float* bias,
                                            const Lane& L) {
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const int c = pair_col(L, p);
    const float2 v = unpack2(hword(hs, L, p));
    const float2 s = __ldg(reinterpret_cast<const float2*>(scale + c));
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
    float2 m0 = mi, m1 = mi;
    if (PER_COL) {
      m0 = *reinterpret_cast<const float2*>(cst + 2 * c);
      m1 = *reinterpret_cast<const float2*>(cst + 2 * c + 2);
    }
    const float sc0 = __fmul_rn(m0.y, s.x), sc1 = __fmul_rn(m1.y, s.y);
    const float sh0 = rnd<bf16>(__fsub_rn(b.x, __fmul_rn(m0.x, sc0)));
    const float sh1 = rnd<bf16>(__fsub_rn(b.y, __fmul_rn(m1.x, sc1)));
    o[p >> 2][p & 3] = lns::pack_bf16(rnd<bf16>(v.x * rnd<bf16>(sc0)) + sh0,
                                      rnd<bf16>(v.y * rnd<bf16>(sc1)) + sh1);
  }
}

// partial sums (a, q) of the f32 values v in rows < P
__device__ __forceinline__ float2 film_sums(const float (&v)[64], int P, const Lane& L) {
  float a = 0.f, q = 0.f;
#pragma unroll
  for (int p = 0; p < 32; ++p) {  // a select, not a branch per pair
    const bool in = pair_row(L, p) < P;
    const float v0 = in ? v[2 * p] : 0.f, v1 = in ? v[2 * p + 1] : 0.f;
    a += v0;
    a += v1;
    q = fmaf(v0, v0, q);
    q = fmaf(v1, v1, q);
  }
  return make_float2(a, q);
}

// partial sums (a, q) of the sample's residual stream over this thread's
// pairs (rows past P hold zeros)
__device__ __forceinline__ float2 h_sums(bf16* hs, const Lane& L) {
  float a = 0.f, q = 0.f;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const float2 v = unpack2(hword(hs, L, p));
    a += v.x;
    a += v.y;
    q = fmaf(v.x, v.x, q);
    q = fmaf(v.y, v.y, q);
  }
  return make_float2(a, q);
}

// o = the f32 values v normalised, (v - mean) inv scale + bias in f32, then
// (GELU in f32 first) rounded to bf16
template <bool GELU>
__device__ __forceinline__ void film_norm(const float (&v)[64], Frag& o, float2 mi,
                                          const float* scale, const float* bias, const Lane& L) {
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const int c = pair_col(L, p);
    const float2 s = __ldg(reinterpret_cast<const float2*>(scale + c));
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
    float t0 = (v[2 * p] - mi.x) * mi.y * s.x + b.x;
    float t1 = (v[2 * p + 1] - mi.x) * mi.y * s.y + b.y;
    if (GELU) {
      t0 = gelu_f32(t0);
      t1 = gelu_f32(t1);
    }
    o[p >> 2][p & 3] = lns::pack_bf16(t0, t1);
  }
}

// One block runs one sample at a time (the sample pass * gridDim.x +
// blockIdx.x of each pass; past B it computes on zeros and stores
// nothing) through every step: consumer warpgroup w holds rows [64 w, 64 w
// + 64) of every product; warpgroup kFilmWGs produces, one thread keeping
// the ring of weight chunks full (each chunk loaded once per cluster, by
// block f % cl, multicast to every block).
__global__ void __launch_bounds__(kFilmThreads, 1)
rollout_film_kernel(const __grid_constant__ CUtensorMap map_conv,
                    const __grid_constant__ CUtensorMap map_ffn, FilmParams p, FilmPlan sp) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (lns::smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int C = kSampC, C_lat = kFilmLat;
  const Geo& g = p.geo;
  const int P = g.P, tid = threadIdx.x;
  uint8_t* ring = base;
  uint8_t* out_s = base + sp.off_out;
  uint8_t* in_s = base + sp.off_in;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + sp.off_bar);
  uint64_t* empty = full + sp.ring;

  if (tid == 0) {
    for (int i = 0; i < sp.ring; ++i) {
      lns::mbar_init(&full[i], 1);
      lns::mbar_init(&empty[i], sp.cl * kFilmWGs * 4);  // every consumer warp of the cluster
    }
    lns::mbar_fence_init();
  }
  {  // in_w and out_w into their swizzled layouts; the zero row of F
    for (int i = tid; i < C_lat * (C / 8); i += kFilmThreads) {
      const int r = i / (C / 8), c8 = i % (C / 8);
      uint8_t* d = in_s + (c8 / 8) * C_lat * 128 + r * 128 + (((c8 % 8) ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(p.in_w + r * C + 8 * c8);
    }
    for (int i = tid; i < C * 8; i += kFilmThreads) {
      const int r = i / 8, c8 = i % 8;
      *reinterpret_cast<uint4*>(out_s + r * 128 + ((c8 ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(p.out_w + r * C_lat + 8 * c8);
    }
    bf16* f0 = reinterpret_cast<bf16*>(base + sp.off_f);
    for (int i = tid; i < C / 2; i += kFilmThreads)
      reinterpret_cast<uint32_t*>(f0 + P * kSampLdf)[i] = 0u;
    lns::fence_async_shared();  // the weights' stores, visible to wgmma
  }
  __syncthreads();
  if (sp.cl > 1) lns::cluster_sync();  // every block's barriers exist before a multicast lands

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == kFilmWGs) {
    // producer: the chunks of every pass and step in order, each stage
    // refilled once every consumer warp of the cluster has released it; its
    // warpgroup keeps the fewest registers, and the consumers take 240
    lns::setmaxnreg_dec<24>();
    if (tid == kFilmWGs * 128) {
      const uint32_t rank = sp.cl > 1 ? lns::cluster_rank() : 0;
      const uint16_t mask = static_cast<uint16_t>((1 << sp.cl) - 1);
      const int per_step = kChunksPerBlock * p.n_block;
      int f = 0;
      for (int pass = 0; pass < p.passes; ++pass)
        for (int step = 0; step < p.steps; ++step)
          for (int c = 0; c < per_step; ++c, ++f) {
            const int st = f % sp.ring;
            if (f >= sp.ring) lns::mbar_wait(&empty[st], ((f / sp.ring) - 1) & 1);
            lns::mbar_expect_tx(&full[st], kChunk);
            if (f % sp.cl != static_cast<int>(rank)) continue;  // another block loads it
            const int i = c / kChunksPerBlock, j = c - kChunksPerBlock * i;
            const CUtensorMap* map = j < 27 ? &map_conv : &map_ffn;
            const int c2 = j < 27 ? j % 9 : 2 * i + j - 27, c3 = j < 27 ? 3 * i + j / 9 : 0;
            for (int hf = 0; hf < 2; ++hf) {
              uint8_t* dst = ring + st * kChunk + hf * kHalf;
              if (sp.cl > 1)
                lns::tma_load_multicast(dst, map, &full[st], 64 * hf, 0, c2, c3, mask);
              else
                lns::tma_load(dst, map, &full[st], 64 * hf, 0, c2, c3);
            }
          }
    }
  } else {
    lns::setmaxnreg_inc<240>();  // 2 x 128 x 240 + 128 x 24 of the SM's 65,536: no spills
    const int wg = role, wt = tid % 128;
    Lane L;
    L.lane = wt % 32;
    L.q = wt / 32;
    L.u = L.lane % 4;
    L.r0 = 64 * wg + 16 * L.q + L.lane / 4;
    {
      const int row = 64 * wg + 16 * L.q + (L.lane & 15);
      L.ay = row < P ? row / g.W : -1;
      L.ax = row < P ? row % g.W : 0;
    }
    bf16* F = reinterpret_cast<bf16*>(base + sp.off_f);
    bf16* hs = reinterpret_cast<bf16*>(base + sp.off_h);
    float* red1 = reinterpret_cast<float*>(base + sp.off_gn);  // [2][8][2]
    float* gpart = red1 + 32;                                  // [2 halves][32 groups][2]
    float* cst = gpart + kFilmWGs * kFilmGroups * 2 + wg * C * 2;  // this warpgroup's [C][2]
    const Ring r{ring, full, empty, sp.ring, sp.cl};
    const int gsz = C / kFilmGroups;
    bf16* out = p.out;
    int f = 0, n1 = 0;
    Frag a;
    float acc[64];
    for (int pass = 0; pass < p.passes; ++pass) {
      const int b = pass * gridDim.x + blockIdx.x;
      const bool live = b < p.B;
      const int bs = live ? b : 0;  // the sample whose e, c a dead one reads
      // z0 as the in-projection's A fragments (rows past P, and samples past B, zero)
      uint32_t z[4][4];
      {
        const bf16* z0 = p.z0 + static_cast<size_t>(bs) * P * C_lat;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = L.r0 + 8 * (e & 1), col = 16 * ks + 8 * (e >> 1) + 2 * L.u;
            z[ks][e] = live && row < P
                           ? *reinterpret_cast<const uint32_t*>(z0 + row * C_lat + col) : 0u;
          }
      }
      for (int step = 0; step < p.steps; ++step) {
        // h = z @ in_w + in_b
        zero(acc);
        lns::wgmma_fence_regs(acc);
        lns::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          lns::wgmma_n128_rs<1>(acc, z[ks],
                                lns::desc_mnmajor_wide(in_s + ks * 2048, C_lat * 128));
        lns::wgmma_commit();
        lns::wgmma_wait<0>();
        lns::wgmma_fence_regs(acc);
        residual_pairs<false>(acc, p.in_b, hs, P, L);

#pragma unroll 1
        for (int i = 0; i < p.n_block; ++i) {
          const float* gs_ = p.gn_s + 3 * i * C;
          const float* gb_ = p.gn_b + 3 * i * C;
          const float* cb = p.conv_b + 3 * i * C;
          const size_t ec = (static_cast<size_t>(i) * p.B + bs) * C;
          // t = GN1(h) into F (film_stats' barrier ends the last conv's reads of F)
          float2 s = h_sums(hs, L);
          float2 mi = film_stats(s.x, s.y, red1 + 16 * (n1++ & 1), P, L, wg);
          gn_apply_sc<false>(hs, a, mi, nullptr, gs_, gb_, L);
          store_f(F, a, P, L);
          lns::bar_sync(1, 2 * 128);
          // t = gelu(conv1.1(t)), in place in F
          conv_taps(acc, F, g, 1, L, r, f);
          film_gelu_pairs<true>(acc, cb, a, L);
          lns::bar_sync(1, 2 * 128);  // every warp's reads of F are done
          store_f(F, a, P, L);
          lns::bar_sync(1, 2 * 128);
          // u = (bf16(conv1.3 product) + bf16(bias)) + e, f32
          conv_taps(acc, F, g, p.dilation, L, r, f);
#pragma unroll
          for (int q = 0; q < 32; ++q) {
            const int c = pair_col(L, q);
            const float2 bb = bias2(cb + C, c);
            const float2 ee = __ldg(reinterpret_cast<const float2*>(p.e + ec + c));
            acc[2 * q] = (rnd<bf16>(acc[2 * q]) + bb.x) + ee.x;
            acc[2 * q + 1] = (rnd<bf16>(acc[2 * q + 1]) + bb.y) + ee.y;
          }
          // bf16(gelu(GN1(u))) into F: cond_conv1.2's input
          s = film_sums(acc, P, L);
          mi = film_stats(s.x, s.y, red1 + 16 * (n1++ & 1), P, L, wg);
          film_norm<true>(acc, a, mi, gs_ + C, gb_ + C, L);
          store_f(F, a, P, L);
          lns::bar_sync(1, 2 * 128);
          // g = cond_conv1.2(.); h = bf16(h + g); t = (h + g)(1 + c), f32
          conv_taps(acc, F, g, 1, L, r, f);
#pragma unroll
          for (int q = 0; q < 32; ++q) {
            const int c = pair_col(L, q);
            const float2 bb = bias2(cb + 2 * C, c);
            const float2 cc = __ldg(reinterpret_cast<const float2*>(p.c + ec + c));
            const float2 x = unpack2(hword(hs, L, q));
            const float x0 = x.x + rnd<bf16>(rnd<bf16>(acc[2 * q]) + bb.x);
            const float x1 = x.y + rnd<bf16>(rnd<bf16>(acc[2 * q + 1]) + bb.y);
            const bool in = pair_row(L, q) < P;
            hword(hs, L, q) = in ? lns::pack_bf16(x0, x1) : 0u;
            acc[2 * q] = x0 * (1.f + cc.x);
            acc[2 * q + 1] = x1 * (1.f + cc.y);
          }
          // h = h + gelu(GN1(t) @ ffn0) @ ffn1, the FFN in registers
          s = film_sums(acc, P, L);
          mi = film_stats(s.x, s.y, red1 + 16 * (n1++ & 1), P, L, wg);
          film_norm<false>(acc, a, mi, gs_ + 2 * C, gb_ + 2 * C, L);
          zero(acc);
          chunk_product(acc, a, r, f++, L.lane);
          film_gelu_pairs<false>(acc, nullptr, a, L);
          zero(acc);
          chunk_product(acc, a, r, f++, L.lane);
          residual_pairs<true>(acc, nullptr, hs, P, L);
        }

        // z = GN(32)(h) @ out_w + out_b: column sums over this half's rows,
        // each group's (gsz lanes') sums into gpart, both halves added in order
        lns::bar_sync(2 + wg, 128);  // this half's h is in place
        {
          float sa = 0.f, sq = 0.f;
          const bf16* col = hs + 64 * wg * kSampLdf + wt;
          for (int row = 0; row < 64; ++row) {
            const float v = __bfloat162float(col[row * kSampLdf]);
            sa += v;
            sq = fmaf(v, v, sq);
          }
          for (int off = 1; off < gsz; off <<= 1) {
            sa += __shfl_xor_sync(0xffffffffu, sa, off);
            sq += __shfl_xor_sync(0xffffffffu, sq, off);
          }
          if (wt % gsz == 0) {
            gpart[2 * (wg * kFilmGroups + wt / gsz)] = sa;
            gpart[2 * (wg * kFilmGroups + wt / gsz) + 1] = sq;
          }
        }
        lns::bar_sync(1, 2 * 128);
        {
          const int gi = wt / gsz;
          const float sa = gpart[2 * gi] + gpart[2 * (kFilmGroups + gi)];
          const float sq = gpart[2 * gi + 1] + gpart[2 * (kFilmGroups + gi) + 1];
          const float n = static_cast<float>(P) * gsz, mean = sa / n;
          cst[2 * wt] = mean;
          cst[2 * wt + 1] = rsqrtf(fmaxf(sq / n - mean * mean, 0.f) + 1e-6f);
        }
        lns::bar_sync(2 + wg, 128);
        gn_apply_sc<true>(hs, a, make_float2(0.f, 0.f), cst, p.out_gn_s, p.out_gn_b, L);
        float az[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) az[k] = 0.f;
        lns::wgmma_fence_regs(az);
        lns::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          lns::wgmma_n64_rs<1>(az, a[ks], lns::desc_mnmajor(out_s + ks * 2048));
        lns::wgmma_commit();
        lns::wgmma_wait<0>();
        lns::wgmma_fence_regs(az);
        bf16* o = out + (static_cast<size_t>(step) * p.B + bs) * P * C_lat;
#pragma unroll
        for (int k = 0; k < 8; ++k) {  // the n8 column blocks of C_lat
          const int c = 8 * k + 2 * L.u;
          const float2 bz = bias2(p.out_b, c);
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = L.r0 + 8 * rh;
            const float v0 = rnd<bf16>(az[4 * k + 2 * rh]) + bz.x;
            const float v1 = rnd<bf16>(az[4 * k + 2 * rh + 1]) + bz.y;
            const uint32_t v = row < P ? lns::pack_bf16(v0, v1) : 0u;
            z[k >> 1][2 * (k & 1) + rh] = v;
            if (live && row < P) *reinterpret_cast<uint32_t*>(o + row * C_lat + c) = v;
          }
        }
      }
    }
  }
  if (sp.cl > 1) lns::cluster_sync();  // no block leaves while its cluster may reach it
}

// Clusters of the FiLM plan's launch that the card holds at once
// (cudaOccupancyMaxActiveClusters), asked once per device and H W.
cudaError_t film_at_once(int P, int* n) {
  struct Seen {
    int dev, P, n;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen)
    if (s.dev == dev && s.P == P) {
      *n = s.n;
      return cudaSuccess;
    }
  const FilmPlan sp = make_film_plan(P);
  e = lns::allow_smem(rollout_film_kernel, sp.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = bf16_config(sp.cl, sp.cl, sp.smem, nullptr, &attr);
  cfg.blockDim = dim3(kFilmThreads);
  e = cudaOccupancyMaxActiveClusters(n, rollout_film_kernel, &cfg);
  if (e == cudaSuccess) seen.push_back({dev, P, *n});
  return e;
}

// The FiLM plan's limits, stated once: nullptr when it takes the shape.
const char* film_limit(int B, int H, int W, int C_lat, int C, int groups) {
  static thread_local char msg[240];
  if (B < 1 || H < 1 || W < 1) {
    snprintf(msg, sizeof msg, "B, H, W >= 1, got %d, %d, %d", B, H, W);
  } else if (C != kSampC || C_lat != kFilmLat) {
    snprintf(msg, sizeof msg, "C %d and C_lat %d (the N of its m64n128k16 and m64n64k16 "
             "products), got C %d, C_lat %d", kSampC, kFilmLat, C, C_lat);
  } else if (H * W > kFilmRows) {
    snprintf(msg, sizeof msg, "H*W <= %d (two m64 tiles a sample), got %d", kFilmRows, H * W);
  } else if (groups != kFilmGroups) {
    snprintf(msg, sizeof msg, "groups %d (CondSimpleCNN's out_proj), got %d", kFilmGroups,
             groups);
  } else if (make_film_plan(H * W).ring < 2) {
    snprintf(msg, sizeof msg, "a weight ring of 2 stages in %zu bytes of shared memory",
             lns::kMaxDynamicSmem);
  } else {
    return nullptr;
  }
  return msg;
}

// The FiLM plan's grid: {clusters the card holds at once, blocks, passes}.
// Every pass is as full as the batch allows: passes = ceil(B / the blocks
// the card holds), then the fewest whole clusters that cover B in that
// many passes.
cudaError_t film_grid(int B, int P, int cl, int* at_once, int* blocks, int* passes) {
  const cudaError_t e = film_at_once(P, at_once);
  if (e != cudaSuccess) return e;
  if (*at_once < 1) return cudaErrorInvalidConfiguration;
  const int most = *at_once * cl;
  *passes = (B + most - 1) / most;
  const int need = (B + *passes - 1) / *passes;
  *blocks = (need + cl - 1) / cl * cl;
  return cudaSuccess;
}

}  // namespace

// nullptr when the kernel of this dtype (0 f32, 1 bf16) takes the shape,
// else the limit it breaks; for bf16 also when a cluster fits on no part of
// the card (cudaOccupancyMaxActiveClusters). The bf16 limits are the cluster
// plan's: the sample plan takes a subset of its shapes.
extern "C" const char* lns_prop_rollout_limit(int dtype, int B, int H, int W, int C_lat, int C,
                                              int groups) {
  if (dtype == 0) return f32_limit(H * W, C_lat, C, groups);
  if (dtype != 1) return "dtype float32 or bfloat16";
  if (const char* msg = bf16_limit(B, H, W, C_lat, C, groups)) return msg;
  static thread_local char msg[200];
  int n = 0;
  const cudaError_t e = cluster_plan_at_once(B, H, W, C_lat, C, &n);
  if (e != cudaSuccess || n < 1) {
    const int cl = cluster_for(B, C);
    snprintf(msg, sizeof msg, "a cluster of %d blocks of %d bytes of shared memory that the card "
             "can hold (cudaOccupancyMaxActiveClusters: %d, %s)", cl,
             make_plan(H * W, C_lat, C, cl).smem, n, cudaGetErrorString(e));
    return msg;
  }
  return nullptr;
}

// The bf16 launch for this shape: out = {blocks per cluster, blocks, shared
// memory bytes per block, clusters the card holds at once, 16-row tiles per
// warp, plan (0 the cluster plan, 1 the sample plan), whole samples per
// block (0 in the cluster plan: a cluster shares one sample), weight ring
// stages}.
extern "C" int lns_prop_rollout_plan(int B, int H, int W, int C_lat, int C, int groups,
                                     int* out) {
  if (bf16_limit(B, H, W, C_lat, C, groups)) return cudaErrorInvalidValue;
  Params prm = shape_params(B, H, W, C_lat, C);
  if (uses_samples(B, H, W, C_lat, C)) {
    const SampPlan sp = make_samp_plan(H * W);
    out[0] = sp.cl;
    out[1] = samp_blocks(B, sp.cl);
    out[2] = sp.smem;
    out[3] = 0;
    out[4] = 1;
    out[5] = 1;
    out[6] = kSampWGs;
    out[7] = sp.ring;
    return run_samples(prm, nullptr, &out[3]);
  }
  out[0] = prm.cl;
  out[1] = B * prm.cl;
  out[2] = make_plan(H * W, C_lat, C, prm.cl).smem;
  out[3] = 0;
  out[4] = tiles_needed(H * W, C_lat, C, prm.cl);
  out[5] = 0;
  out[6] = 0;
  out[7] = kStages;
  return cluster_plan_at_once(B, H, W, C_lat, C, &out[3]);
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
    if (uses_samples(B, H, W, C_lat, C)) return run_samples(prm, st, nullptr);
    prm.cl = cluster_for(B, C);
    return dispatch_bf16(prm, st, nullptr);
  }
  return cudaErrorInvalidValue;
}

// nullptr when the FiLM plan (bf16) takes the shape, else the limit it
// breaks: the shape alone, asking nothing of the card, so that the rollout
// driver's choice is read from its input. Where the card holds none of the
// plan's clusters, the launch fails (lns_prop_rollout_film returns the
// occupancy query's error, or cudaErrorInvalidConfiguration).
extern "C" const char* lns_prop_rollout_film_limit(int B, int H, int W, int C_lat, int C,
                                                   int groups) {
  return film_limit(B, H, W, C_lat, C, groups);
}

// The FiLM plan's launch for this shape: out = {blocks per cluster, blocks,
// shared memory bytes per block, clusters the card holds at once, weight
// ring stages, passes (samples each block walks)}.
extern "C" int lns_prop_rollout_film_plan(int B, int H, int W, int* out) {
  if (film_limit(B, H, W, kFilmLat, kSampC, kFilmGroups)) return cudaErrorInvalidValue;
  const FilmPlan sp = make_film_plan(H * W);
  out[0] = sp.cl;
  out[2] = sp.smem;
  out[4] = sp.ring;
  return film_grid(B, H * W, sp.cl, &out[3], &out[1], &out[5]);
}

// The conditional propagator's rollout (bf16, zero padding), the FiLM plan.
extern "C" int lns_prop_rollout_film(const void* z0, const void* in_w, const void* in_b,
                                     const void* gn_s, const void* gn_b, const void* conv_w,
                                     const void* conv_b, const void* ffn_w, const void* out_gn_s,
                                     const void* out_gn_b, const void* out_w, const void* out_b,
                                     const void* e_, const void* c_, void* out, int B, int H,
                                     int W, int n_block, int dilation, int steps, void* stream) {
  if (film_limit(B, H, W, kFilmLat, kSampC, kFilmGroups) || n_block < 1 || dilation < 1)
    return cudaErrorInvalidValue;
  const FilmPlan sp = make_film_plan(H * W);
  int at_once = 0, blocks = 0, passes = 0;
  cudaError_t e = film_grid(B, H * W, sp.cl, &at_once, &blocks, &passes);
  if (e != cudaSuccess) return e;
  // the weights as the sample plan streams them (run_samples): conv_w as [3
  // n_block convs][9 taps][C in][C out], ffn_w as [2 n_block][C][C], boxes
  // of C rows x 64 output columns
  const uint64_t C = kSampC, nb = n_block;
  CUtensorMap map_conv, map_ffn;
  e = lns::make_map(&map_conv, conv_w, {C, C, 9, 3 * nb}, {C * 2, C * C * 2, 9 * C * C * 2},
                    {64, kSampC, 1, 1});
  if (e == cudaSuccess)
    e = lns::make_map(&map_ffn, ffn_w, {C, C, 2 * nb, 1}, {C * 2, C * C * 2, 2 * nb * C * C * 2},
                      {64, kSampC, 1, 1});
  if (e != cudaSuccess) return e;
  FilmParams prm{static_cast<const bf16*>(z0), static_cast<const bf16*>(in_w),
                 static_cast<const float*>(in_b), static_cast<const float*>(gn_s),
                 static_cast<const float*>(gn_b), static_cast<const float*>(conv_b),
                 static_cast<const float*>(out_gn_s), static_cast<const float*>(out_gn_b),
                 static_cast<const bf16*>(out_w), static_cast<const float*>(out_b),
                 static_cast<const float*>(e_), static_cast<const float*>(c_),
                 static_cast<bf16*>(out), B, n_block, dilation, steps, passes,
                 Geo{H, W, H * W, 0, 0}};
  e = lns::allow_smem(rollout_film_kernel, sp.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      bf16_config(blocks, sp.cl, sp.smem, static_cast<cudaStream_t>(stream), &attr);
  cfg.blockDim = dim3(kFilmThreads);
  e = cudaLaunchKernelEx(&cfg, rollout_film_kernel, map_conv, map_ffn, prm, sp);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" const char* lns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fused latent rollout: `steps` SimpleCNN propagator applications in one
// kernel launch, one thread block per sample.
//
// Replaces lns_tpu/pallas_kernels/prop_rollout.py: fused_rollout
// (_rollout_kernel). Each step:
//   h = z @ in_w + in_b
//   n_block x [ t = GN1(h); t = gelu(conv3(t)); t = gelu(conv3_dil(t));
//               h = h + conv3(t);  f = GN1(h); h = h + gelu(f @ ffn0) @ ffn1 ]
//   z = GN(groups)(h) @ out_w + out_b
// and z is carried to the next step.
//
// What bounds it on an H100: arithmetic on few SMs. Every op of a step is
// per sample (GN statistics, convs, the output GN), so a block per sample
// runs all steps with no cross-block synchronisation — but the NS2d batch of
// 32 fills only 32 of the 132 SMs, and the ~180 MFLOP per sample-step (3x128
// channels, 8x8) run as f32 FMAs on CUDA cores. The weights (2.9 MB in bf16)
// do not fit in shared memory; each step streams them from L2, where they
// stay resident.
//
// Design. The TPU kernel carried the latent across a sequential grid over
// steps; here the step loop is inside the block and the carry, the residual
// stream and two scratch activations live in shared memory as f32 ([H*W+1, C]
// each, 33 KB at 8x8x128; the extra row is all zeros). A 3x3 conv tap is
// index arithmetic: circular axes wrap, zero-padded axes point at the zero
// row, so all four padding modes share one code path. Thread (co, position
// group) owns one output channel for a run of positions and keeps their
// accumulators in registers; the input is read as float4 broadcasts and each
// weight once per position group. The TPU workarounds are gone: no 128-lane
// latent padding, erff instead of a rational erf, plain group sums instead
// of a 0/1 mixing matmul.
//
// Rounding matches the TPU kernel: products accumulate in f32 and are rounded
// to the activation dtype, then the bias (rounded the same way) is added;
// GN statistics are f32 with the variance clamped at 0; GELU is computed in
// f32 and rounded.

#include "common.cuh"

namespace {

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
  float* h = smem;                // residual stream [P+1, C]
  float* t1 = h + rows * C;       // scratch        [P+1, C]
  float* t2 = t1 + rows * C;      // scratch        [P+1, C]
  float* z = t2 + rows * C;       // latent carry   [P+1, C_lat]
  float* red = z + rows * CL;     // 2 * kThreads
  float* chan = red + 2 * kThreads;   // 2 * C
  float* stats = chan + 2 * C;        // 2 * C (2 * groups used)

  const int b = blockIdx.x, tid = threadIdx.x;
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

template <typename T>
int launch(const Params& prm, size_t smem, cudaStream_t stream) {
  cudaError_t e = lns::allow_smem(rollout_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  rollout_kernel<T><<<prm.B, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

bool fits(int cout) { return cout > 0 && kThreads % cout == 0; }

}  // namespace

extern "C" int lns_prop_rollout(int dtype, const void* z0, const void* in_w, const void* in_b,
                                const void* gn_s, const void* gn_b, const void* conv_w,
                                const void* conv_b, const void* ffn_w, const void* out_gn_s,
                                const void* out_gn_b, const void* out_w, const void* out_b,
                                void* out, int B, int H, int W, int C_lat, int C, int n_block,
                                int dilation, int wrap_y, int wrap_x, int groups, int steps,
                                void* stream) {
  const int P = H * W;
  if (C % 4 || C_lat % 4 || groups <= 0 || groups > C || C % groups || !fits(C) ||
      !fits(C_lat))
    return cudaErrorInvalidValue;
  Params prm{z0, in_w, static_cast<const float*>(in_b), static_cast<const float*>(gn_s),
             static_cast<const float*>(gn_b), conv_w, static_cast<const float*>(conv_b),
             ffn_w, static_cast<const float*>(out_gn_s), static_cast<const float*>(out_gn_b),
             out_w, static_cast<const float*>(out_b), out, B, C_lat, C, n_block, dilation,
             groups, steps, Geo{H, W, P, wrap_y, wrap_x}};
  const size_t smem =
      (static_cast<size_t>(3) * (P + 1) * C + static_cast<size_t>(P + 1) * C_lat +
       2 * kThreads + 4 * C) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(prm, smem, st);
  if (dtype == 1) return launch<__nv_bfloat16>(prm, smem, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* lns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

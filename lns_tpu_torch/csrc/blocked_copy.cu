// A blocked copy: out = x bitwise, any dtype, one thread block per `s`
// samples of one group.
//
// Replaces benchmarks/probe_pallas_bw.py: pallas_copy (_copy_kernel). The TPU
// probe copies x [B, G, M, N] through VMEM on a grid (B / s, G), a block of
// (s, 1, M, N) per step, to part the cost of a grid step from the rate of
// its copies. Here block (i, j) copies samples i s .. i s + s - 1 of group j:
// s rows of `row` bytes, G rows apart (the last block takes what is left
// when s does not divide B).
//
// What bounds it on an H100: bytes, one read and one write of x. Each thread
// keeps kInFlight loads in flight before it stores them, neighbouring
// threads on neighbouring addresses; the pieces are 16 bytes where the row
// size and both pointers allow it, else 8, 4, 2 or 1. The grid holds
// ceil(B / s) x G blocks: at large s fewer than the card's SMs hold at once,
// which is what a sweep over s shows.

#include <cstdint>
#include <cstdio>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kInFlight = 8;

// V: the piece one thread moves (uint4 = 16 bytes down to unsigned char);
// nv pieces per row
template <typename V>
__global__ void __launch_bounds__(kThreads)
blocked_copy_kernel(const V* __restrict__ x, V* __restrict__ out, int b, int g, int s,
                    long long nv) {
  const int b0 = blockIdx.x * s, gi = blockIdx.y;
  const int b1 = b0 + s < b ? b0 + s : b;
  for (int bi = b0; bi < b1; ++bi) {
    const long long base = (static_cast<long long>(bi) * g + gi) * nv;
    const V* src = x + base;
    V* dst = out + base;
    for (long long e0 = threadIdx.x; e0 < nv; e0 += kThreads * kInFlight) {
      V v[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long e = e0 + k * kThreads;
        if (e < nv) v[k] = src[e];
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long e = e0 + k * kThreads;
        if (e < nv) dst[e] = v[k];
      }
    }
  }
}

template <typename V>
int launch(const void* x, void* out, int b, int g, int s, long long row_bytes, cudaStream_t st) {
  const dim3 grid((b + s - 1) / s, g);
  blocked_copy_kernel<V><<<grid, kThreads, 0, st>>>(static_cast<const V*>(x),
                                                     static_cast<V*>(out), b, g, s,
                                                     row_bytes / static_cast<long long>(sizeof(V)));
  return cudaGetLastError();
}

}  // namespace

// The copy's limits (the one statement of them): nullptr when it takes the
// shape, else the limit it breaks.
extern "C" const char* lns_blocked_copy_limit(int b, int g, int s, long long row_bytes) {
  static thread_local char msg[160];
  if (b < 1 || g < 1 || row_bytes < 1) {
    snprintf(msg, sizeof msg, "samples, groups and row bytes >= 1, got %d, %d, %lld", b, g,
             row_bytes);
  } else if (g > 65535) {
    snprintf(msg, sizeof msg, "groups in [1, 65535] (the grid's y), got %d", g);
  } else if (s < 1) {
    snprintf(msg, sizeof msg, "samples per block >= 1, got %d", s);
  } else {
    return nullptr;
  }
  return msg;
}

// x [b, g, row_bytes] -> out, a block per s samples of one group; the piece
// size is the largest of 16, 8, 4, 2, 1 bytes that divides the row and both
// pointers.
extern "C" int lns_blocked_copy(const void* x, void* out, int b, int g, int s,
                                long long row_bytes, void* stream) {
  if (lns_blocked_copy_limit(b, g, s, row_bytes)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long align =
      static_cast<unsigned long long>(row_bytes) | reinterpret_cast<uintptr_t>(x) |
      reinterpret_cast<uintptr_t>(out);
  if (align % 16 == 0) return launch<uint4>(x, out, b, g, s, row_bytes, st);
  if (align % 8 == 0) return launch<uint2>(x, out, b, g, s, row_bytes, st);
  if (align % 4 == 0) return launch<unsigned>(x, out, b, g, s, row_bytes, st);
  if (align % 2 == 0) return launch<unsigned short>(x, out, b, g, s, row_bytes, st);
  return launch<unsigned char>(x, out, b, g, s, row_bytes, st);
}

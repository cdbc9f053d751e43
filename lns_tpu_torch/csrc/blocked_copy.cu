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
// What bounds it on an H100: bytes, one read and one write of x (at
// [928, 2, 128, 2048] bf16, 1,946 MB: 0.581 ms at 3.35 TB/s). Two routes,
// chosen in one place (bulk_route) by the alignment of the row size and
// both pointers:
//   bulk     (all three multiples of 16 bytes) no byte passes through
//            registers. One thread of a 32-thread block streams the block's
//            rows through a ring of kStages stages of kStage bytes in shared
//            memory with Hopper's 1-D bulk copies (TMA): global -> shared
//            completing on an mbarrier by bytes, shared -> global as a bulk
//            group. The loads run kStages - 1 stages ahead of the stores, so
//            a block keeps reads and writes in flight together. 128 KB of
//            shared memory a block: one block on an SM, so s = 2 (928
//            blocks) is 7.03 waves on 132 SMs and s = 16 (116) one. No L2
//            policy hint.
//   threads  (anything else: odd-sized rows, offset views) the per-thread
//            copy, 256 threads, each keeps kInFlight pieces in registers
//            before it stores them; pieces of 16, 8, 4, 2 or 1 bytes, the
//            largest that divides the row and both pointers.
// The grid holds ceil(B / s) x G blocks on both routes: at large s fewer
// than the card's SMs hold at once, which is what a sweep over s shows.
// Neither route reaches Tensor.copy_. `probe_bw.py --variants` times the
// bulk route beside variants of this file (16 KB stages, an evict-first
// hint, its chunks dealt to the blocks in address order, the per-thread
// route on aligned rows and on x viewed as short rows in address order);
// PERF.md reads what limits the copy from them.

#include <cstdint>
#include <cstdio>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256, kInFlight = 8;
constexpr int kStage = 32768, kStages = 4;  // the bulk route's ring
constexpr int kBulkSmem = kStage * kStages;

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

// The bulk route: chunk k of the block is piece k % per_row (kStage bytes,
// the row's last one shorter) of its row k / per_row, and passes through
// stage k % kStages.
__global__ void __launch_bounds__(32)
blocked_copy_bulk(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int b, int g, int s,
                  long long row) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[kStages];
  if (threadIdx.x != 0) return;
  const int b0 = blockIdx.x * s, gi = blockIdx.y;
  const int rows = b0 + s < b ? s : b - b0;
  const long long per_row = (row + kStage - 1) / kStage;
  const long long total = rows * per_row;
  for (int i = 0; i < kStages; ++i) lns::mbar_init(&full[i], 1);
  lns::mbar_fence_init();
  // the byte offset of chunk k in x and out, and its size
  auto chunk = [&](long long k, uint32_t* bytes) {
    const long long r = k / per_row, off = (k % per_row) * kStage;
    *bytes = static_cast<uint32_t>(row - off < kStage ? row - off : kStage);
    return ((b0 + r) * g + gi) * row + off;
  };
  auto load = [&](long long k) {
    uint32_t bytes;
    const long long at = chunk(k, &bytes);
    uint64_t* bar = &full[k % kStages];
    lns::mbar_expect_tx(bar, bytes);
    lns::bulk_load(ring + (k % kStages) * kStage, x + at, bytes, bar);
  };
  for (long long k = 0; k < kStages && k < total; ++k) load(k);
  for (long long k = 0; k < total; ++k) {
    lns::mbar_wait(&full[k % kStages], static_cast<uint32_t>((k / kStages) & 1));
    uint32_t bytes;
    const long long at = chunk(k, &bytes);
    lns::bulk_store(out + at, ring + (k % kStages) * kStage, bytes);
    lns::tma_store_commit();
    if (k >= 1 && k - 1 + kStages < total) {  // refill chunk k - 1's stage once it is read
      lns::bulk_wait_read<1>();
      load(k - 1 + kStages);
    }
  }
  lns::bulk_wait_read<0>();  // the ring is read out before the block's memory is released
}

template <typename V>
int launch(const void* x, void* out, int b, int g, int s, long long row_bytes, cudaStream_t st) {
  const dim3 grid((b + s - 1) / s, g);
  blocked_copy_kernel<V><<<grid, kThreads, 0, st>>>(static_cast<const V*>(x),
                                                     static_cast<V*>(out), b, g, s,
                                                     row_bytes / static_cast<long long>(sizeof(V)));
  return cudaGetLastError();
}

// The route rule (the one statement of it): the bulk route when the row
// size and both pointers are multiples of 16 bytes, else the per-thread one.
bool bulk_route(const void* x, const void* out, long long row_bytes) {
  const unsigned long long align =
      static_cast<unsigned long long>(row_bytes) | reinterpret_cast<uintptr_t>(x) |
      reinterpret_cast<uintptr_t>(out);
  return align % 16 == 0;
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

// x [b, g, row_bytes] -> out, a block per s samples of one group, on the
// route bulk_route picks; *route (where not null) receives it, 1 bulk or 0
// per-thread. The per-thread route's piece is the largest of 16, 8, 4, 2, 1
// bytes that divides the row and both pointers.
extern "C" int lns_blocked_copy(const void* x, void* out, int b, int g, int s,
                                long long row_bytes, int* route, void* stream) {
  if (lns_blocked_copy_limit(b, g, s, row_bytes)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bulk = bulk_route(x, out, row_bytes);
  if (route) *route = bulk ? 1 : 0;
  if (bulk) {
    cudaError_t e = lns::allow_smem(blocked_copy_bulk, kBulkSmem);
    if (e != cudaSuccess) return e;
    blocked_copy_bulk<<<dim3((b + s - 1) / s, g), 32, kBulkSmem, st>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), b, g, s, row_bytes);
    return cudaGetLastError();
  }
  const unsigned long long align =
      static_cast<unsigned long long>(row_bytes) | reinterpret_cast<uintptr_t>(x) |
      reinterpret_cast<uintptr_t>(out);
  if (align % 16 == 0) return launch<uint4>(x, out, b, g, s, row_bytes, st);
  if (align % 8 == 0) return launch<uint2>(x, out, b, g, s, row_bytes, st);
  if (align % 4 == 0) return launch<unsigned>(x, out, b, g, s, row_bytes, st);
  if (align % 2 == 0) return launch<unsigned short>(x, out, b, g, s, row_bytes, st);
  return launch<unsigned char>(x, out, b, g, s, row_bytes, st);
}

// Tensor-core building blocks shared by the bf16 (and f16) kernels: 16-byte
// asynchronous copies into shared memory (cp.async, with commit and wait
// groups), ldmatrix fragment loads, and the warp-wide
// mma.sync.m16n8k16 bf16 / f16 product with f32 accumulation.
//
// Fragment layout of mma.m16n8k16 (lane = 4 g + t):
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8):        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// The *_addr helpers give the shared-memory address lane `lane` passes to
// ldmatrix for a 16 x 16 (or 16 x 8) operand tile at (r0, c0) of a row-major
// bf16 array with row stride `ld` elements. Rows of 16 bytes must start on
// 16-byte boundaries; a stride that is an odd multiple of 16 bytes keeps the
// eight rows of one 8 x 8 matrix in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <type_traits>

namespace lns {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a . b  (16 x 16 bf16 times 16 x 8 bf16, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in f16 (the same fragment layout)
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the product for a 16-bit operand type T (__nv_bfloat16 or __half)
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16(c, a, b0, b1);
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

// A operand, 16 x 16, stored [m][k]: ldsm_x4 gives a0..a3.
__device__ __forceinline__ int a_addr(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}
// A operand, 16 x 16, stored transposed [k][m] (r0 = k0, c0 = m0): ldsm_x4_trans gives a0..a3.
__device__ __forceinline__ int at_addr(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + (((lane >> 3) & 1) << 3);
}
// B operand, k16 x n16, stored [k][n] (r0 = k0, c0 = n0): ldsm_x4_trans gives
// b0, b1 of columns n0..n0+7, then b0, b1 of n0+8..n0+15.
__device__ __forceinline__ int b_addr(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}
// B operand, k16 x n8, stored [n][k] (r0 = n0, c0 = k0): ldsm_x2 gives b0, b1
// (lanes 16-31 pass addresses that ldmatrix ignores).
__device__ __forceinline__ int bt_addr(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 7)) * ld + c0 + (((lane >> 3) & 1) << 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two f32 values rounded to T (__nv_bfloat16 or __half), packed low first
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

}  // namespace lns

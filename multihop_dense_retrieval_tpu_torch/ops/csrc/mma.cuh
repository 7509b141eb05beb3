// Tensor-core and asynchronous-copy building blocks for the port's Hopper
// kernels (mips_scan_mma.cu, chunk_max_mma.cu, fused_attention.cu and the
// int8 mips_scan_i8.cu, chunk_max_i8.cu), as inline PTX:
//   * cp.async.cg 16-byte copies from device memory to shared memory (L2
//     only), and cp.async.ca 4-byte ones, with a source size of 0 giving a
//     zero-filled destination;
//   * ldmatrix (plain and .trans) loading 8x8 bf16 tiles into the register
//     fragments of mma.sync;
//   * mma.sync.m16n8k16 with bf16 inputs and fp32 accumulators, and
//     mma.sync.m16n8k32 with s8 inputs and s32 accumulators.
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), lane =
// 4 * g + t: A (16x16, row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
// a2 = (g, 2t+8..), a3 = (g+8, 2t+8..); B (16x8) b0 = (k 2t..2t+1, n g),
// b1 = (k 2t+8.., n g); C/D (16x8 fp32) c0,c1 = (g, 2t..2t+1), c2,c3 =
// (g+8, 2t..2t+1).  Two C tiles side by side (16 x 16) therefore hold, once
// rounded to bf16 pairs, exactly the A fragment of the next product.
// m16n8k32 with s8 inputs has the same fragments byte for byte: A a0 =
// (g, bytes 4t..4t+3), a1 = (g+8, ..), a2 = (g, bytes 16+4t..), a3 = (g+8,
// ..); B b0 = (k bytes 4t..4t+3, n g), b1 = (k bytes 16+4t.., n g); C in
// s32 at the same places.  So the same 144-byte shared-memory rows and the
// same ldmatrix addressing (in bytes) feed both; an int8 k-step is 32
// columns where a bf16 one is 16.
//
// The tensor cores add the products of one instruction in their own order
// and alignment, not as an IEEE fp32 sum in sequence: results differ from a
// CUDA-core loop by a few ulps of the running sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdrt_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` to shared `dst`; src_bytes 0 writes zeros and reads
// nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes from `src` to shared `dst` (both 4-byte aligned); src_bytes 0
// writes zeros and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b on the tensor cores: m16n8k16, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on the tensor cores: m16n8k32, s8 inputs, s32 accumulators
// (exact: no saturation is needed below 2^31)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// two fp32 values rounded to a bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace mdrt_mma

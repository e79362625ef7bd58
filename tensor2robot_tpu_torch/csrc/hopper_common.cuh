// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// and the decode tick: shared-memory matrix descriptors for
// 128-byte-swizzled tiles (and K-major 64-byte ones), warpgroup matrix
// multiply (`wgmma`) wrappers for bf16 and tf32, `mbarrier` waits, the TMA
// 3-D tile load and its host-side tensor map (bf16 or f32), the 1-D bulk
// copy, the bf16 hi/lo split of accumulator fragments, the tf32 big/small
// split of f32 values (3xTF32) and the permutation (`perm8`) that makes an
// f32 accumulator a tf32 A fragment.
//
// Tile layout used throughout: a tile of R rows is stored as column blocks
// of 128 bytes (64 bf16 or 32 f32 columns), block h at tile + h * R * 128
// bytes, each block R rows of 128 bytes, 128B-swizzled by TMA. Every block
// starts 1024-byte aligned (the swizzle atom: 8 rows of 128 bytes), so a
// descriptor may start 32, 64 or 96 bytes into a row to step along K, as
// the hardware applies the swizzle to address bits.
//
// Accumulator fragment of `wgmma` m64nNk16 (f32): thread t of the
// warpgroup (warp w = t / 32, lane l) holds d[4j + 2i + c] at row
// 16w + l/4 + 8i, column 8j + 2(l%4) + c. Packed to bf16 pairs, the
// columns 16kk .. 16kk+15 of it are exactly the A-operand register
// fragment of a following m64nNk16 product whose K is those columns
// (`acc_to_frag`): a score tile feeds the next product from registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t2r_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a K-major operand (rows of 128 bytes, 64 bf16 or 32 tf32,
// K contiguous): layout 128B swizzle, stride between 8-row groups 1024
// bytes.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)             // LBO: unused
         | (static_cast<uint64_t>(1024 >> 4) << 32)     // SBO
         | (static_cast<uint64_t>(1) << 62);            // 128B swizzle
}

// Descriptor of an MN-major operand (the same stored tile read transposed:
// rows are K, 64 N-elements contiguous): SBO 1024 bytes between groups of
// 8 K-rows, LBO `half_bytes` between 64-column halves along N.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t half_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((half_bytes >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// Descriptor of a K-major operand stored in rows of 64 bytes (16 tf32),
// 64B-swizzled as TMA writes it (`encode_bhtd_box` with swizzle 64):
// stride between 8-row groups 512 bytes. A k-step of 8 tf32 is 32 bytes.
__device__ __forceinline__ uint64_t desc_kmajor_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)             // LBO: unused
         | (static_cast<uint64_t>(512 >> 4) << 32)      // SBO
         | (static_cast<uint64_t>(2) << 62);            // 64B swizzle
}
// K-major descriptor of a tile of `row_bytes` (128 or 64) rows.
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc_kmajor_rows(uint32_t addr) {
  static_assert(kRowBytes == 128 || kRowBytes == 64, "128 or 64-byte rows");
  return kRowBytes == 128 ? desc_kmajor(addr) : desc_kmajor_sw64(addr);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving register reads or writes across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// -- wgmma (bf16 in, f32 accumulate) ----------------------------------------

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B from shared memory,
// both K-major. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B from shared memory,
// both K-major. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]; A from registers (a bf16x2
// fragment, the accumulator layout of a previous product), B from shared
// memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]; A from registers (a bf16x2
// fragment, the accumulator layout of a previous product), B from shared
// memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// The same wrappers chosen by accumulator size (N = 64 or 128).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  wgmma_ss_m64n64(d, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  wgmma_ss_m64n128(d, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n64_tb(d, a, b);
}
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n128_tb(d, a, b);
}

// -- wgmma (tf32 in, f32 accumulate) ------------------------------------------
//
// A k-step of tf32 is 8 values, 32 bytes: the same bytes as a bf16 k-step,
// so `desc_kmajor` and its 32-byte steps along K serve 32-float rows
// unchanged. `.tf32` takes no transpose bits: both operands are K-major.
// The A-operand register fragment of m64nNk8 holds, for thread t of the
// warpgroup (warp w, lane l, g = l / 4, c = l % 4), a[0] at (row 16w + g,
// k c), a[1] at (16w + g + 8, c), a[2] at (16w + g, c + 4), a[3] at
// (16w + g + 8, c + 4).

// D[64 x 64] (+)= A[64 x 8] * B[8 x 64], tf32; A and B from shared memory,
// both K-major. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_m64n64(float (&d)[32], uint64_t a,
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 8] * B[8 x 32], tf32; A and B from shared memory,
// both K-major. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_m64n32(float (&d)[16], uint64_t a,
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 16] (+)= A[64 x 8] * B[8 x 16], tf32; A and B from shared memory,
// both K-major. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_m64n16(float (&d)[8], uint64_t a,
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The tf32 SS products chosen by accumulator size (N = 16, 32 or 64).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t a,
                                              uint64_t b, int scale_d) {
  wgmma_tf32_ss_m64n16(d, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a,
                                              uint64_t b, int scale_d) {
  wgmma_tf32_ss_m64n32(d, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  wgmma_tf32_ss_m64n64(d, a, b, scale_d);
}

// D[64 x 32] += A[64 x 8] * B[8 x 32], tf32; A from registers (a tf32
// fragment), B from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 8] * B[8 x 64], tf32; A from registers (a tf32
// fragment), B from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 8] * B[8 x 128], tf32; A from registers (a tf32
// fragment), B from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// tf32(x), rounded to nearest with ties away from zero, as f32 bits with
// the 13 low bits clear.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}
// x = big + small to ~2^-22 |x|: big = tf32(x), small = tf32(x - big).
// Three products big.big + big.small + small.big keep an f32 product to
// about that accuracy (3xTF32; the dropped small.small term is ~2^-22).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}
// Splits the four floats at `p` in place into their big parts and writes
// the small parts to `small`.
__device__ __forceinline__ void split4_in_place(uint8_t* p, uint8_t* small) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  uint4 big, lo;
  split_tf32(__uint_as_float(x.x), big.x, lo.x);
  split_tf32(__uint_as_float(x.y), big.y, lo.y);
  split_tf32(__uint_as_float(x.z), big.z, lo.z);
  split_tf32(__uint_as_float(x.w), big.w, lo.w);
  *reinterpret_cast<uint4*>(p) = big;
  *reinterpret_cast<uint4*>(small) = lo;
}

// The key (or query) permutation of a transposed B operand. The f32
// accumulator of a product holds columns 2c and 2c+1 of each group of 8
// (c = lane % 4); the tf32 A fragment of the next product takes K indices
// c and c+4. Storing index j of each 8 at position (j >> 1) + 4 (j & 1)
// (order 0 2 4 6 1 3 5 7) makes the accumulator's registers that fragment
// as they stand: a[0..3] = d[4kk + 0, 2, 1, 3].
__device__ __forceinline__ int perm8(int j) {
  return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
}
// Its inverse: the index stored at position p.
__device__ __forceinline__ int unperm8(int p) {
  return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
}

// -- shared memory shared by generic and async proxies ---------------------------

// Orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma, TMA); then a barrier publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Orders this thread's global-memory accesses (and those it has acquired
// from other threads) before its later async-proxy ones (bulk copies).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// Named barrier 1 over the first `count` threads (the consumer warps).
__device__ __forceinline__ void consumer_sync(int count) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(count) : "memory");
}
// Byte offset of 32-bit element (row, col) of a tile of 128-byte rows
// (32 floats), 128B-swizzled as TMA writes it and wgmma reads it: the
// 16-byte chunk index is XORed with row % 8 (the tile starts 1024-byte
// aligned).
__device__ __forceinline__ int swz128_f32(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

// -- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Waits until the phase of parity `parity` has completed. A wait that
// cannot end (a fault in the pipeline) traps after ~2^28 polls, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// -- TMA ---------------------------------------------------------------------

// Copies the box at (c0 = column, c1 = row, c2 = batch*head) of a 3-D
// tensor map into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Copies `bytes` of contiguous global memory at `src` into shared memory
// at `dst` (1-D bulk copy, no tensor map); completion is counted on `bar`.
// Both addresses and `bytes` must be multiples of 16.
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// -- fragments ---------------------------------------------------------------

// Two floats as a bf16 pair, `lo` in the low half (the lower K index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// The accumulator of an m64nNk16 product as A-operand fragments, one per
// 16 columns, each value rounded once to bf16.
template <int N>
__device__ __forceinline__ void acc_to_frag(const float (&d)[N / 2],
                                            uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r],
                                                     d[8 * kk + 2 * r + 1]);
  }
}

// As acc_to_frag, split into x_hi = bf16(x) and x_lo = bf16(x - x_hi):
// hi + lo carries about 16 mantissa bits, so two bf16 products
// (hi * B + lo * B) reproduce an f32 x to ~2^-17 relative.
template <int N>
__device__ __forceinline__ void acc_to_frag_split(const float (&d)[N / 2],
                                                  uint32_t (&hi)[N / 16][4],
                                                  uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
      hi[kk][r] = pack_bf16(x0, x1);
      const float2 h = unpack_bf16(hi[kk][r]);
      lo[kk][r] = pack_bf16(x0 - h.x, x1 - h.y);
    }
  }
}

// -- host: tensor maps ---------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// build links no -lcuda).
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous [bh, t, d] tensor of bf16 (elem_bytes 2) or
// f32 (4), box (`swizzle_bytes` bytes of columns, `box_rows` rows, 1 head),
// swizzled by 128 or 64 bytes: box rows of that width, as `desc_kmajor` or
// `desc_kmajor_sw64` read them. Reads past t or d fill zeros within the
// head: a tile that runs past t never reads the next head.
inline cudaError_t encode_bhtd_box(CUtensorMap* map, const void* base, int bh,
                                   int t, int d, int box_rows, int elem_bytes,
                                   int swizzle_bytes) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorMisalignedAddress;
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  if (swizzle_bytes != 128 && swizzle_bytes != 64) return cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(d) * elem_bytes;
  const cuuint64_t strides[2] = {row_bytes, static_cast<cuuint64_t>(t) * row_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(swizzle_bytes / elem_bytes),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map,
                      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      3, const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D map over a contiguous [bh, t, d] tensor of bf16 (elem_bytes 2) or
// f32 (4), box (128 bytes of columns: 64 bf16 or 32 f32, `box_rows` rows,
// 1 head), 128B swizzle.
inline cudaError_t encode_bhtd(CUtensorMap* map, const void* base, int bh,
                               int t, int d, int box_rows, int elem_bytes) {
  return encode_bhtd_box(map, base, bh, t, d, box_rows, elem_bytes, 128);
}

}  // namespace t2r_hopper

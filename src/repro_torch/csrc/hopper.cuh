// Hopper (sm_90a) building blocks of the port's tensor-core kernels:
// cp.async copies into 128-byte-swizzled shared-memory tiles, wgmma
// shared-memory descriptors, and the bf16 wgmma instructions (m64n64k16
// and m64n128k16 with A from registers, m64n64k16 with A from shared
// memory), in raw PTX.
//
// Tile layout.  A bf16 tile of `rows` rows by D columns is stored as
// D / 64 column atoms, each `rows` rows of 128 bytes.  Inside an atom the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8): the 128-byte
// swizzle that wgmma's descriptor layout type 1 reads, so every atom
// starts on a 1024-byte boundary.  The same bytes serve as a K-major
// operand (rows = M or N, columns = the reduction dim: Q and K in
// Q·Kᵀ) and as an MN-major one (rows = the reduction dim: V in P·V).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rt {
namespace sm90 {

// Byte offset of the 16-byte chunk `chunk` (column / 8) of row r.
__device__ __forceinline__ uint32_t swizzled(int r, int chunk, int rows) {
  return (chunk / 8) * rows * 128 + r * 128 + (((chunk % 8) ^ (r % 8)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device memory to shared memory; when !valid the
// source is not read and the 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async
// included) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.  K-major: the stride
// byte offset steps 8 rows (1024 bytes); the leading one is unused.
// MN-major: the leading byte offset steps to the next 64-column atom, the
// stride byte offset to the next 8 rows of the reduction dim.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma that is still in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ... and of register A fragments, which a wgmma reads until it is done
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t ld_shared32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr));
  return x;
}

// 2^x in one instruction (MUFU.EX2); flushes subnormal results to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 as one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// (x0, x1) as hi + lo, each a register of two bf16: hi = bf16(x), lo =
// bf16(x - hi), so hi + lo holds x to about 2^-17 relative.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

#define RT_F8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define RT_F32(d, i) \
  RT_F8(d, i), RT_F8(d, i + 8), RT_F8(d, i + 16), RT_F8(d, i + 24)
#define RT_F64(d, i) RT_F32(d, i), RT_F32(d, i + 32)

// d[OFF, OFF + N/2) (64 x N, f32) = A·B (+ d if accumulate), N = 64 or
// 128: A (64 x 16, bf16) in registers, B (16 x N) in shared memory,
// K-major (TRANS_B = 0: stored as N rows of the reduction dim) or
// MN-major (TRANS_B = 1).  Thread t of warp w holds A rows w*16 + t/4 and
// +8: a[0] = (row, 2(t%4) + {0,1}), a[1] = (row + 8, same), a[2] and a[3]
// the same 8 columns on; and d[OFF + i] at row w*16 + t/4 + 8((i/2)%2),
// column 8(i/4) + 2(t%4) + i%2 of the product.  So products over
// neighbouring column ranges of one B, issued into d at OFF = first
// column / 2, leave d laid out as one product over all of them.
template <int TRANS_B, int OFF = 0, int ND>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[ND],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  static_assert(OFF + 32 <= ND, "accumulators out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : RT_F32(d, OFF)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B, int OFF = 0, int ND>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[ND],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  static_assert(OFF + 64 <= ND, "accumulators out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : RT_F64(d, OFF)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 64, f32) = A·B (+ d if accumulate) with both operands in shared
// memory, K-major: A (64 x 16) at da and B (16 x 64) at db, each stored
// as 64 rows that hold the reduction dim; d laid out as above.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_F32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef RT_F8
#undef RT_F32
#undef RT_F64

}  // namespace sm90
}  // namespace rt

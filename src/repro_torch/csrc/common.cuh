// Shared helpers of the port's CUDA kernels: element loads/stores in float32
// or bfloat16, warp reductions, cp.async copies, the bf16 tensor-core
// instructions (ldmatrix, mma.sync m16n8k16), and sm_90a's own (mbarriers,
// TMA tile loads, setmaxnreg, wgmma m64n128k16).  Every
// kernel accumulates in float32.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reduce over the `width` lanes of an aligned lane group (width a power of 2).
template <int WIDTH>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int WIDTH>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int WIDTH>
__device__ __forceinline__ int group_sum_int(int x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l gets row l/4, columns 2(l%4) and
// 2(l%4)+1 of matrix i in r[i] (of its transpose with TRANS).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col) on the tensor
// cores.  Fragments (g = lane / 4, t = lane % 4): a[0] row g cols 2t..2t+1,
// a[1] row g+8, a[2] row g cols 2t+8.., a[3] row g+8 cols 2t+8..; b0 rows
// 2t..2t+1 col g, b1 rows 2t+8..; c[0..1] row g cols 2t..2t+1, c[2..3] row
// g+8.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- Hopper (sm_90a): mbarriers, TMA tile loads, wgmma ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive, and expect `bytes` more of transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D tile of the tensor map `map` (a __grid_constant__ kernel
// parameter) at element coordinates (c0 innermost, c1) into shared memory;
// its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Give this warpgroup's registers back to / take them from the SM's pool.
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// atomicAdd on shared memory with acquire-release order at CTA scope.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "r"(smem_addr(p)), "r"(v)
               : "memory");
  return old;
}

// A shared-memory matrix descriptor of a 128-byte-swizzled tile (rows of
// 128 bytes, the TMA's CU_TENSOR_MAP_SWIZZLE_128B layout; the tile's base
// 1024-byte aligned): start address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x on the SFU, denormal results flushed to zero (one MUFU.EX2; exp2f
// adds range scaling for denormals).  ex2(-inf) = 0.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin an accumulator register of an asynchronous wgmma after the wait for
// it: the compiler takes its value as made here, so no read of it moves
// above the wait.
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

#define REPRO_ACC8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_ACC64(d)                                                   \
  REPRO_ACC8(d, 0), REPRO_ACC8(d, 8), REPRO_ACC8(d, 16), REPRO_ACC8(d, 24), \
      REPRO_ACC8(d, 32), REPRO_ACC8(d, 40), REPRO_ACC8(d, 48),           \
      REPRO_ACC8(d, 56)
#define REPRO_ACC64_REGS                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128 f32, the warpgroup's accumulator fragments) = A B^T (+ d if
// accumulate), A 64 x 16 and B 128 x 16 bf16 both K-major in shared
// memory.  Fragment i of thread (warp w, lane l): row 16w + l/4 + 8((i/2)
// % 2), column 8(i/4) + 2(l%4) + i%2.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      REPRO_ACC64_REGS ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128 f32) += A B, A 64 x 16 bf16 in registers (the mma.sync A
// fragment layout per warp: a0 row l/4, columns 2(l%4).., a1 row l/4 + 8,
// a2 columns + 8, a3 both), B 16 x 128 bf16 in shared memory
// with its 128 columns contiguous (MN-major, transposed operand).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      REPRO_ACC64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

}  // namespace repro

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
#define REPRO_F32 0
#define REPRO_BF16 1

// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tile loads,
// register hand-over between warpgroups, shared-memory matrix descriptors
// and the warpgroup MMAs the attention kernels run (m64n128k8 tf32 and
// m64n128k16 bf16 with f32 accumulators, A from shared memory or registers).
//
// Shared-memory operand layout used throughout: K-major, rows of exactly
// 128 bytes written by TMA with CU_TENSOR_MAP_SWIZZLE_128B (32 f32 or 64
// bf16 values per row), each tile 1024-byte aligned.  One k-step of an MMA
// reads 32 bytes of every row, so step kk starts 32·kk bytes into the tile
// (the swizzle is applied by the hardware from the address bits).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of the given parity has completed.  A wait
// of more than 10 s can only be a broken pipeline: it traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = global_ns();
    } else if (global_ns() - start > 10000000000ull) {
      __trap();
    }
  }
}

// ---- TMA -------------------------------------------------------------------

// Copy the box at (c0 = innermost coordinate, c1 = row) of a 2-D tensor map
// into shared memory; the barrier's transaction count falls by the box's
// bytes when it lands.  Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Registers move between warpgroups: the producer gives up what it does not
// need, the consumers take it (all four warps of a warpgroup execute it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a K-major, 128-byte-swizzled tile: rows of 128 bytes, groups
// of 8 rows 1024 bytes apart (stride byte offset), swizzle mode 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4);
  desc |= (uint64_t)1 << 16;            // leading byte offset (unused here)
  desc |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  desc |= (uint64_t)1 << 62;            // 128-byte swizzle
  return desc;
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

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous MMAs that own it.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"

#define HOPPER_ACC64_OPERANDS(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),         \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),            \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),            \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),            \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),            \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
      "+f"(d[62]), "+f"(d[63])

// d(64×128) += a(64×8) · b(128×8)ᵀ, tf32 operands from shared memory
// (d = a·bᵀ when accumulate is 0).  Accumulator element i of thread t: row
// 16·(t/32) + (t%32)/4 + 8·((i/2)%2), column 8·(i/4) + 2·(t%4) + i%2.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HOPPER_ACC64
      ", %64, %65, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC64_OPERANDS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64×128) += a(64×8) · b(128×8)ᵀ with a in registers (d = a·bᵀ when
// accumulate is 0): thread t holds in a[i] the tf32 value of row
// 16·(t/32) + (t%32)/4 + 8·(i%2), column (t%4) + 4·(i/2).  The registers
// stay untouched until the MMA has completed (wgmma_wait).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HOPPER_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d(64×128) += a(64×16) · b(128×16)ᵀ with a in registers, two bf16 values
// to a register: thread t holds in a[i] row 16·(t/32) + (t%32)/4 + 8·(i%2),
// columns 2·(t%4) + 8·(i/2) (low half) and the next (high half).  b is
// K-major; the registers stay untouched until the MMA has completed.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : HOPPER_ACC64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64×128) += a(64×16) · b(128×16)ᵀ, bf16 operands from shared memory, both
// K-major (no transpose).  Same accumulator layout as wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_ACC64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC64_OPERANDS(d)
      : "l"(da), "l"(db), "r"(1));
}

#undef HOPPER_ACC64
#undef HOPPER_ACC64_OPERANDS

// ---- arithmetic --------------------------------------------------------------

// 2^x in one MUFU instruction (relative error about 2^-22; results below
// 2^-126 flush to zero).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// Round to the nearest tf32 value (ties away from zero); the low 13 bits of
// the result are zero.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

}  // namespace hopper

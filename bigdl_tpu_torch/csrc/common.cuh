// Shared helpers for the hand-written Hopper kernels of bigdl_tpu_torch:
// bf16 bit conversions and the PTX wrappers (lop3, bf16x2 fma, ldmatrix,
// mma.sync, cp.async) of the tensor-core kernels.
//
// Every kernel library is built by nvcc into its own shared object with a
// plain C interface (see bigdl_tpu_torch/_native.py) and takes raw device
// pointers and the caller's CUDA stream. bfloat16 values travel as their
// 16-bit patterns (uint16_t), so no header beyond the CUDA runtime is needed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// -inf as a float bit pattern (no host math header needed)
#define kNegInf __int_as_float(0xff800000)

// bf16 bits -> f32 (exact)
__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
    return __uint_as_float(((uint32_t)b) << 16);
}

// f32 -> bf16 bits, round to nearest even (NaN kept quiet)
__device__ __forceinline__ uint16_t f32_to_bf16(float f) {
    uint32_t u = __float_as_uint(f);
    if ((u & 0x7f800000u) == 0x7f800000u && (u & 0x007fffffu)) {
        return (uint16_t)((u >> 16) | 0x0040u);
    }
    u += 0x7fffu + ((u >> 16) & 1u);
    return (uint16_t)(u >> 16);
}

// round an f32 to the nearest bf16 value, kept in f32
__device__ __forceinline__ float round_bf16(float f) {
    return bf16_to_f32(f32_to_bf16(f));
}

// two f32 -> bf16x2 (round to nearest even); lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

// d = a * b + c on bf16 pairs, rounded once
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// one three-input bitwise op, LUT over (a, b, c) = (0xF0, 0xCC, 0xAA):
// 0xEA is (a & b) | c, 0x6A (a & b) ^ c. With two constant operands the
// compiler splits such an expression into two LOP3s (an instruction holds
// one immediate); here the constants sit in registers.
template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("lop3.b32 %0, %1, %2, %3, %4;"
        : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
    return d;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* p) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr)
        : "memory");
}

// c += a . b on the tensor cores: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on the tensor cores: m16n8k32, s8 in, s32 accumulate (exact)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of 16 bytes into shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(addr), "l"(src), "r"(src_bytes) : "memory");
}

// cp.async of 4 bytes into shared memory (cached in L1: a scale column
// shares its sectors with other heads); src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(addr), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

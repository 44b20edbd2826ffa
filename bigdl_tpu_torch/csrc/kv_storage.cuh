// KV cache storage kinds of the attention kernels (B3, B4, B5): how a code
// plane holds a row, and how codes become the bf16 values attention uses.
//
//   kind      code bits  scales  value of code c
//   bf16          16       no    c
//   fp8_e5m2       8       no    c, exactly (the byte is the top half of an
//                                fp16 with the same value; every e5m2 value
//                                is a bf16 value)
//   int8           8      yes    round_bf16(float(c) * scale)
//   int4           4      yes    round_bf16(float(c) * scale); two codes a
//                                byte, dim 2i in the low nibble of byte i,
//                                two's complement
//
// The scaled kinds carry one f32 scale per (row, kv head); their value is
// the bits of the TPU kernels' `_dequant_rows` (decode_attention.py:118):
// the code converted to f32 exactly, multiplied by its f32 scale in f32,
// the product rounded to bf16 before any dot.
//
// A policy Kv<K> gives kBits, kScaled, the type Word4 that holds the codes
// of 4 consecutive head dims (8, 4 or 2 bytes), and code(w, i), the i-th of
// them as f32 (before scaling); scaled4 turns one Word4 into 4 values
// before the bf16 rounding (B4 rounds as it packs them). The decode body
// (B3, B5) converts code pairs exactly with kv_pair_* instead.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

enum KvKind { KV_BF16 = 0, KV_E5M2 = 1, KV_INT8 = 2, KV_INT4 = 3 };

template <int K>
struct Kv;

template <>
struct Kv<KV_BF16> {
    static constexpr int kBits = 16;
    static constexpr bool kScaled = false;
    using Word4 = uint2;
    __device__ __forceinline__ static float code(Word4 w, int i) {
        const uint32_t u = i < 2 ? w.x : w.y;
        return __uint_as_float(i & 1 ? (u & 0xffff0000u) : (u << 16));
    }
};

template <>
struct Kv<KV_E5M2> {
    static constexpr int kBits = 8;
    static constexpr bool kScaled = false;
    using Word4 = uint32_t;
    __device__ __forceinline__ static float code(Word4 w, int i) {
        const unsigned short h =
            (unsigned short)(((w >> (8 * i)) & 0xffu) << 8);
        return __half2float(__ushort_as_half(h));
    }
};

template <>
struct Kv<KV_INT8> {
    static constexpr int kBits = 8;
    static constexpr bool kScaled = true;
    using Word4 = uint32_t;
    __device__ __forceinline__ static float code(Word4 w, int i) {
        return (float)((int)(w << (24 - 8 * i)) >> 24);
    }
};

template <>
struct Kv<KV_INT4> {
    static constexpr int kBits = 4;
    static constexpr bool kScaled = true;
    using Word4 = uint16_t;
    __device__ __forceinline__ static float code(Word4 w, int i) {
        return (float)((int)((uint32_t)w << (28 - 4 * i)) >> 28);
    }
};

// 4 codes -> their f32 values before any bf16 rounding: the code, times
// its scale for the scaled kinds (scale ignored by the others)
template <class KV>
__device__ __forceinline__ void scaled4(typename KV::Word4 w, float scale,
                                        float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float c = KV::code(w, i);
        out[i] = KV::kScaled ? c * scale : c;
    }
}

// Exact code pairs -> bf16x2 (lo half first), for the decode body's
// tensor-core operands (decode_attention.cuh). No scale is applied: every
// int8/int4 code and every e5m2 value is a bf16 value, and the decode body
// folds the scales into the score and the probability instead. Each takes
// the two codes where a shift or one prmt leaves them and ignores the other
// bits of its word, so a caller pairs codes of one row or of two rows at
// the cost of that one instruction.

// int4: the nibbles at bits 0-3 and 16-19 of x (two's complement).
// (0x4300 | (n ^ 8)) is the bf16 value 136 + c; fma(v, 1, -136) is c.
__device__ __forceinline__ uint32_t kv_pair_i4(uint32_t x) {
    return fma_bf16x2(lop3<0x6A>(x, 0x000f000fu, 0x43084308u), 0x3F803F80u,
                      0xC308C308u);
}

// int8: the bytes at bits 0-7 and 16-23 of x. Low nibble l as 128 + l,
// high nibble h (signed) as 136 + h; fma(136 + h, 16, -2304) = 16h - 128,
// plus 128 + l is c = 16h + l, every step exact.
__device__ __forceinline__ uint32_t kv_pair_i8(uint32_t x) {
    const uint32_t lo = lop3<0xEA>(x, 0x000f000fu, 0x43004300u);
    const uint32_t hi = lop3<0x6A>(x >> 4, 0x000f000fu, 0x43084308u);
    return fma_bf16x2(lo, 0x3F803F80u,
                      fma_bf16x2(hi, 0x41804180u, 0xC510C510u));
}

// fp8_e5m2: the bytes at bits 8-15 and 24-31 of x. The magnitude bits
// moved to bf16's bits 5-11 are the value times 2^-112 (e5m2 and bf16
// subnormals line up too); fma by +-2^112 restores it and the sign.
// Codes of inf/NaN (exponent 31) decode as finite values (2^16 .. 1.75 *
// 2^16); a cache never stores them (the engine's values are finite).
__device__ __forceinline__ uint32_t kv_pair_e5m2(uint32_t x) {
    const uint32_t mag = (x >> 3) & 0x0FE00FE0u;
    const uint32_t sgn = lop3<0xEA>(x, 0x80008000u, 0x77807780u);
    return fma_bf16x2(mag, sgn, 0x80008000u);
}

// bytes of `n` codes of this kind (n a multiple of 2)
template <class KV>
__device__ __host__ __forceinline__ constexpr size_t code_bytes(size_t n) {
    return n * KV::kBits / 8;
}

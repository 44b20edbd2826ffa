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
// them as f32 (before scaling). dequant4 turns one Word4 into 4 values;
// scaled4 stops before the bf16 rounding, for a caller that rounds as it
// packs the values.
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

// 4 codes -> the 4 values attention uses: the scaled kinds' products
// rounded to bf16 (round to nearest even, two at a time by one cvt)
template <class KV>
__device__ __forceinline__ void dequant4(typename KV::Word4 w, float scale,
                                         float* out) {
    scaled4<KV>(w, scale, out);
    if constexpr (KV::kScaled) {
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
            const uint32_t p = pack_bf16x2(out[i], out[i + 1]);
            out[i] = __uint_as_float(p << 16);
            out[i + 1] = __uint_as_float(p & 0xffff0000u);
        }
    }
}

// bytes of `n` codes of this kind (n a multiple of 2)
template <class KV>
__device__ __host__ __forceinline__ constexpr size_t code_bytes(size_t n) {
    return n * KV::kBits / 8;
}

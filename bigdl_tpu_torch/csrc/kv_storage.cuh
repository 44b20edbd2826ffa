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
// A policy Kv<K> gives kBits and kScaled. The attention bodies (B3, B4,
// B5) convert code pairs exactly with kv_pair_* and fold the scales out of
// the products, in the order kslot_dim / k_frag / v_pair (at the end) give
// the mma.sync operands.
#pragma once

#include "common.cuh"

enum KvKind { KV_BF16 = 0, KV_E5M2 = 1, KV_INT8 = 2, KV_INT4 = 3 };

template <int K>
struct Kv;

template <>
struct Kv<KV_BF16> {
    static constexpr int kBits = 16;
    static constexpr bool kScaled = false;
};

template <>
struct Kv<KV_E5M2> {
    static constexpr int kBits = 8;
    static constexpr bool kScaled = false;
};

template <>
struct Kv<KV_INT8> {
    static constexpr int kBits = 8;
    static constexpr bool kScaled = true;
};

template <>
struct Kv<KV_INT4> {
    static constexpr int kBits = 4;
    static constexpr bool kScaled = true;
};

// Exact code pairs -> bf16x2 (lo half first), for the attention bodies'
// tensor-core operands (decode_attention.cuh, prefill_attention.cu). No
// scale is applied: every int8/int4 code and every e5m2 value is a bf16
// value, and the bodies fold the scales into the score and the probability
// instead. Each takes the two codes where a shift or one prmt leaves them
// and ignores the other bits of its word, so a caller pairs codes of one
// row or of two rows at the cost of that one instruction.

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

// Operands of m16n8k16 from a row's codes. A lane's K slice is a quarter
// of a key's row (its words w: the dims [t * hd/4, (t + 1) * hd/4) of the
// lane t = lane % 4); its V slice an eighth (dims [g * hd/8, (g + 1) *
// hd/8) of the lane g = lane / 4). The score's dot runs over the k slots
// of hd/16 k steps in any order of the dims, so each kind takes the order
// that its pairs come in, and q is loaded in the same order.

// The dims of a lane's K slice behind k step s, in the order of the mma's
// k slots {2t, 2t+1, 2t+8, 2t+9}: where kv_pair_* finds a pair, so q is
// loaded in the same order. bf16: 4s..4s+3; int8, fp8: 4s, 4s+2, 4s+1,
// 4s+3 (the bytes at 0/16 and 8/24 of word s); int4: nibbles m, m+4 and
// m+1, m+5 of word s/2 with m = 2 (s % 2).
template <int KIND>
__device__ __forceinline__ int kslot_dim(int s, int e) {
    if (KIND == KV_BF16) return 4 * s + e;
    if (KIND == KV_INT4) {
        const int m = 8 * (s >> 1) + 2 * (s & 1);
        return m + (e >> 1) + 4 * (e & 1);
    }
    return 4 * s + 2 * (e & 1) + (e >> 1);
}

// B fragment {b0, b1} of k step s from a lane's K slice (words w)
template <int KIND, int NW>
__device__ __forceinline__ void k_frag(const uint32_t (&w)[NW], int s,
                                       uint32_t& b0, uint32_t& b1) {
    if (KIND == KV_BF16) {
        b0 = w[2 * s];
        b1 = w[2 * s + 1];
    } else if (KIND == KV_INT8) {
        b0 = kv_pair_i8(w[s]);
        b1 = kv_pair_i8(w[s] >> 8);
    } else if (KIND == KV_E5M2) {
        b0 = kv_pair_e5m2(w[s] << 8);
        b1 = kv_pair_e5m2(w[s]);
    } else {
        const uint32_t x = w[s >> 1] >> (8 * (s & 1));
        b0 = kv_pair_i4(x);
        b1 = kv_pair_i4(x >> 4);
    }
}

// bf16x2 of dim i of a lane's V slice for two keys (words wa, wb)
template <int KIND, int NW>
__device__ __forceinline__ uint32_t v_pair(const uint32_t (&wa)[NW],
                                           const uint32_t (&wb)[NW], int i) {
    if (KIND == KV_BF16) {
        return __byte_perm(wa[i >> 1], wb[i >> 1], (i & 1) ? 0x7632 : 0x5410);
    } else if (KIND == KV_INT8) {
        const uint32_t p = __byte_perm(wa[i >> 2], wb[i >> 2],
                                       (i & 2) ? 0x7632 : 0x5410);
        return kv_pair_i8((i & 1) ? p >> 8 : p);
    } else if (KIND == KV_E5M2) {
        const uint32_t p = __byte_perm(wa[i >> 2], wb[i >> 2],
                                       (i & 2) ? 0x7632 : 0x5410);
        return kv_pair_e5m2((i & 1) ? p : p << 8);
    } else {
        const uint32_t p = __byte_perm(wa[i >> 3], wb[i >> 3],
                                       (i & 4) ? 0x7632 : 0x5410);
        return kv_pair_i4(p >> (4 * (i & 3)));
    }
}

// Tensor-core dequant matmul of B1's fold and mxuflat bodies
// (dequant_variants.cu, M <= 32): y[M, N] = x[M, Kp] . W[Kp, N] over
// block-quantized W, with mma.sync m16n8k16 (bf16 in, f32 accumulate). Its
// word loads and dequantization (Words, load_chunk, dequant_col) also feed
// the small-M body of B1's std, mxu and mxu8 bodies and B6's decode tiles
// (dequant_smallm.cuh), which makes the weights the A operand instead, and
// dequant_col the Hopper body of B2 and B6's quantized prefill tiles
// (dequant_wgmma.cuh).
//
// The weights are never staged in shared memory. Each thread loads packed
// 32-bit words straight from device memory (4 adjacent columns of one
// packed row), dequantizes them in registers and hands the bf16 pairs to
// the tensor cores as B fragments. Lane t's k slots (2t, 2t+1) are packed
// rows 2t and 2t+1 of a 16-row group: their low nibbles form one k step
// over 16 consecutive k of the quant block's first half, their high
// nibbles the next step over the same 16 k of the second half (int8: the
// rows themselves). So every k step's A tile is a plain 16-wide slice of
// x, which is copied into shared memory as it is (cp.async, several
// chunks in flight) and read with ldmatrix. Byte j of a thread's word
// feeds n-tile j, so the thread's four columns land in four 8-column mma
// tiles, and the C fragments come back as 8 consecutive columns per row.
//
// Dequantization is the JAX kernels' (`_dequant_tile`): the f32 value of
// code times scale (plus zero for asym), rounded once to bf16. For
// sym_int4 that product is computed with one bf16x2 fma, which rounds the
// exact product once, i.e. to the same bits.
//
// A block is 4 warps; each warp owns 32 output columns and all M rows
// (MT m-tiles of 16). The words and x of the next STAGES - 1 chunks of 64 K
// are in flight while one chunk computes. K may be split across blocks
// (gridDim.y); every split then writes f32 partial sums to a workspace
// that a second pass adds in split order, so results do not vary from
// run to run. With one split the kernel writes bf16 y directly.
//
// Two weight layouts share the body: the split-block nibbles above, and
// the int4 layout of a prepacked sym_int4 weight (KIND_I4: packed row i
// holds the signed codes of K rows 2i, 2i+1). There lane t's k slots
// (2t, 2t+1) are one byte, so the lane loads packed rows t, t+4, t+8 and
// t+12 of a 16-row unit (one 32-K quant block, two k steps) and
// sign-extends each byte's nibbles into a bf16 pair.
//
// Two scale policies share it too. STD multiplies every weight by its
// block scale and rounds it to bf16 before the product (the
// `_gemv_kernel_mxuflat` numerics). FOLD feeds the tensor cores the raw
// codes (exact in bf16; a codebook value rounded to bf16) and sums each
// 32- or 64-K quant block into a separate f32 C fragment, which then FMAs
// into the running sum with its column's f32 scale (`_gemv_kernel_fold`):
// one scale a block and C column, no per-weight multiply. A C fragment's
// columns are not the ones whose codes the lane loads, so FOLD loads the
// scales of its 8 * CW C columns instead.
#pragma once

#include "common.cuh"

// quantized weight kinds (bigdl_tpu_torch.ops.cuda.dequant_matmul._KIND)
enum WeightKind : int {
    KIND_SYM4 = 0,       // (c - 8) * s
    KIND_ASYM4 = 1,      // c * s + z
    KIND_CODEBOOK4 = 2,  // lut[c] * s
    KIND_SYM8 = 3,       // c * s, int8 codes
    KIND_BF16 = 4,       // dense bf16 weights (B6 over a dense stack)
    KIND_I4 = 5,         // s * c, signed int4 codes in K-row pairs
};

// kinds whose packed rows are K rows (16 a unit), not nibble pairs
__host__ __device__ constexpr bool row_units(int kind) {
    return kind == KIND_SYM8 || kind == KIND_BF16;
}

namespace dqmma {

// B6's per-tile weight address: tile z multiplies by expert
// tile_expert[z] of an [E, ...] stack of planes.
struct RaggedArgs {
    const int* tile_expert;   // [tiles] expert of each tile
    const int* tile_rows;     // [tiles] real rows of each tile
    long long data_es;        // expert stride of the data plane (bytes)
    long long scale_es;       // expert stride of the scale/zero planes
    int num_experts;
};

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;               // K per staged x chunk
constexpr int kLd = kChunk + 8;          // xs row stride: 144 B, no ldmatrix
                                         // bank conflicts

// exact small integer -> f32 without an int-to-float conversion
__device__ __forceinline__ float code_f32(uint32_t c) {
    return __uint_as_float(0x4B000000u | c) - 8388608.f;
}

// f32 value of one code (before the bf16 rounding); `_rn` keeps nvcc from
// contracting the asym multiply-add into an fma
template <int KIND>
__device__ __forceinline__ float dequant_f32(uint32_t c, float s, float z,
                                             const float* lut) {
    if (KIND == KIND_ASYM4) return __fadd_rn(__fmul_rn(code_f32(c), s), z);
    if (KIND == KIND_CODEBOOK4) return __fmul_rn(lut[c], s);
    if (KIND == KIND_SYM8)                  // c is the int8 byte
        return __fmul_rn(code_f32(c ^ 0x80u) - 128.f, s);
    return __fmul_rn(code_f32(c) - 8.f, s);
}

// Load NW consecutive 32-bit words (NW * 4 bytes, aligned to that size).
template <int NW>
__device__ __forceinline__ void ldg_words(const void* p, uint32_t* out) {
    if (NW == 1) {
        out[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    } else if (NW == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        out[0] = v.x;
        out[1] = v.y;
    } else {
#pragma unroll
        for (int q = 0; q < NW / 4; ++q) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
            out[4 * q] = v.x;
            out[4 * q + 1] = v.y;
            out[4 * q + 2] = v.z;
            out[4 * q + 3] = v.w;
        }
    }
}

// A chunk's packed words and scales for one thread, which owns 4 * CW
// adjacent columns. A unit is 16 packed rows: two k steps for 4-bit codes
// (low, then high nibbles), one for int8 and bf16. A bf16 row of 4 * CW
// columns is 2 * CW words.
//
// Q8 is the mxu8 body's m16n8k32 fragment (dequant_smallm.cuh): 32 K a
// unit (one quant block), lane t's k slots 4t..4t+3 and 16+4t..16+4t+3.
// int4-layout rows are then 2t, 2t+1, 2t+8, 2t+9 of the unit, as for the
// split-block nibbles; int8 rows 4t..4t+3 of a 16-row half unit.
//
// FOLD keeps the scales of the thread's 8 * CW C columns for each of the
// chunk's (at most two) quant blocks instead of its own columns'.
template <int KIND, int CW, bool FOLD = false, bool Q8 = false>
struct Words {
    static constexpr int kUnits = row_units(KIND) ? 4 : 2;
    static constexpr int kRowWords = KIND == KIND_BF16 ? 2 * CW : CW;
    static constexpr bool kCScales = FOLD;
    uint32_t w[kUnits][4][kRowWords];       // (see unit_row)
    // bf16 scales, 2 columns a word: per unit (own columns) or per block
    // (C columns)
    uint32_t s[kCScales ? 2 : kUnits][kCScales ? 4 * CW : 2 * CW];
    uint32_t z[kUnits][2 * CW];             // bf16 zeros (asym)
};

// Packed row i (of 4) that lane t loads in a 16-row unit.
template <int KIND, bool Q8>
__device__ __forceinline__ int unit_row(int t, int i) {
    if (Q8 && KIND == KIND_SYM8) return 4 * t + i;
    if (!Q8 && KIND == KIND_I4) return t + 4 * i;
    return 2 * t + (i & 1) + 8 * (i >> 1);
}

// The quant block of each kind: 64 for the codebook formats (nf4, fp4,
// nf3), 32 for sym_int4, asym_int4, sym_int8 and the int4 layout.
template <int KIND>
__host__ __device__ constexpr int kind_block() {
    return KIND == KIND_CODEBOOK4 ? 64 : 32;
}

// K rows of a unit: 16 packed rows of nibbles are 32 K, of int8/bf16 16.
template <int KIND>
__host__ __device__ constexpr int unit_k() {
    return row_units(KIND) ? 16 : 32;
}

// Load this thread's packed words and scales for the chunk at K offset k0
// (klen valid K rows). ccol is the first of the thread's C columns (FOLD).
template <int KIND, int CW, bool FOLD = false, bool Q8 = false>
__device__ __forceinline__ void load_chunk(
    Words<KIND, CW, FOLD, Q8>& f, const uint8_t* __restrict__ data,
    const uint16_t* __restrict__ scale, const uint16_t* __restrict__ zero,
    int k0, int klen, int N, int ncol, bool col_ok, int ccol, int block,
    int t) {
    using W = Words<KIND, CW, FOLD, Q8>;
    constexpr bool kInt8 = row_units(KIND);
    constexpr int kRowWords = W::kRowWords;
    const int half = block >> 1;
#pragma unroll
    for (int u = 0; u < W::kUnits; ++u) {
        // first packed row of the unit and its quant block
        const int p = kInt8 ? k0 + 16 * u : (k0 >> 1) + 16 * u;
        [[maybe_unused]] const int gb = kInt8 ? p / block : p / half;
        if (col_ok && unit_k<KIND>() * u < klen) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = p + unit_row<KIND, Q8>(t, i);
                // bf16 rows are 2 bytes a column
                ldg_words<kRowWords>(
                    data + ((size_t)row * N + ncol) * (kRowWords / CW),
                    f.w[u][i]);
            }
            if constexpr (!W::kCScales && KIND != KIND_BF16) {
                ldg_words<2 * CW>(scale + (size_t)gb * N + ncol, f.s[u]);
            }
            if (KIND == KIND_ASYM4) {
                ldg_words<2 * CW>(zero + (size_t)gb * N + ncol, f.z[u]);
            }
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int c = 0; c < kRowWords; ++c) f.w[u][i][c] = 0u;
            }
            if constexpr (!W::kCScales) {
#pragma unroll
                for (int c = 0; c < 2 * CW; ++c) f.s[u][c] = 0u;
            }
#pragma unroll
            for (int c = 0; c < 2 * CW; ++c) f.z[u][c] = 0u;
        }
    }
    if constexpr (W::kCScales) {
        // the chunk's quant blocks (64 / block of them) x the two groups
        // of 4 * CW C columns
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int col = ccol + 4 * CW * q;
                if (b * block < klen && col < N) {
                    ldg_words<2 * CW>(
                        scale + (size_t)(k0 / block + b) * N + col,
                        f.s[b] + 2 * CW * q);
                } else {
#pragma unroll
                    for (int c = 0; c < 2 * CW; ++c) {
                        f.s[b][2 * CW * q + c] = 0u;
                    }
                }
            }
        }
    }
}

// Copy x[:, k0:k0+64] into xs as it is (rows >= M and K >= Kp as zeros).
template <int MT>
__device__ __forceinline__ void stage_x(uint16_t (*xs)[kLd],
                                        const uint16_t* __restrict__ x,
                                        int M, int Kp, int k0, int tid) {
    static_assert(MT * 16 * (kChunk / 8) % kThreads == 0, "whole rounds");
#pragma unroll
    for (int r = 0; r < MT * 16 * (kChunk / 8) / kThreads; ++r) {
        const int i = tid + r * kThreads;
        const int m = i / (kChunk / 8);
        const int k = k0 + 8 * (i % (kChunk / 8));
        const bool ok = m < M && k < Kp;
        cp_async16(&xs[m][k - k0], ok ? x + (size_t)m * Kp + k : x,
                   ok ? 16 : 0);
    }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}

// B fragment of one k step for this thread's column 4c + j: {k slots 2t
// and 2t+1, k slots 2t+8 and 2t+9} of byte j of word c. For split-block
// codes `hi` picks the high nibbles, for the int4 layout the unit's second
// k step (rows t+8, t+12). FOLD leaves the scale out. WT is any Words
// (dequant_smallm.cuh folds with the scales of the thread's own columns).
template <int KIND, int CW, bool FOLD, class WT>
__device__ __forceinline__ void dequant_col(const WT& f, int u, bool hi,
                                            const float* lut, int c, int j,
                                            uint32_t* b) {
    uint32_t sw = 0u;                 // FOLD reads no scale here
    if constexpr (!FOLD) sw = f.s[u][2 * c + (j >> 1)];
    if (KIND == KIND_I4) {
        // byte j of the row and of the row >> 4: the codes of K rows 2i
        // (low nibble) and 2i + 1 (high nibble) at bits 0-3 and 16-19; xor 8
        // makes them the unsigned code c = s + 8, (0x4300 | c) the bf16
        // 128 + c, and fma(v, 1, -136) the signed code exactly
        const uint32_t s2 = __byte_perm(sw, 0u, (j & 1) ? 0x3232 : 0x1010);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const uint32_t w = f.w[u][2 * (hi ? 1 : 0) + r][c];
            const uint32_t p = __byte_perm(w, w >> 4, j | ((4 + j) << 8));
            const uint32_t v = lop3<0x6A>(p, 0x000f000fu, 0x43084308u);
            const uint32_t d = fma_bf16x2(v, 0x3F803F80u, 0xC308C308u);
            b[r] = FOLD ? d : fma_bf16x2(d, s2, 0x80008000u);
        }
    } else if (KIND == KIND_SYM4) {
        // (0x4300 | q) is the bf16 value 128 + q; fma(v, 1, -136)
        // is q - 8 exactly, fma(q - 8, s, -0) rounds the exact
        // product once
        const uint32_t s2 = __byte_perm(sw, 0u, (j & 1) ? 0x3232 : 0x1010);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            uint32_t p = __byte_perm(f.w[u][2 * r][c], f.w[u][2 * r + 1][c],
                                     j | ((4 + j) << 8));
            if (hi) p >>= 4;
            const uint32_t v = lop3<0xEA>(p, 0x000f000fu, 0x43004300u);
            const uint32_t d = fma_bf16x2(v, 0x3F803F80u, 0xC308C308u);
            b[r] = FOLD ? d : fma_bf16x2(d, s2, 0x80008000u);
        }
    } else {
        // FOLD: the code (or table value) itself, rounded to bf16
        const float sf = FOLD ? 1.f : (j & 1) ? bf16_hi(sw) : bf16_lo(sw);
        float zf = 0.f;
        if (KIND == KIND_ASYM4) {
            const uint32_t zw = f.z[u][2 * c + (j >> 1)];
            zf = (j & 1) ? bf16_hi(zw) : bf16_lo(zw);
        }
        const int shift = 8 * j + (hi ? 4 : 0);
        const uint32_t mask = KIND == KIND_SYM8 ? 0xffu : 0xfu;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const uint32_t c0 = (f.w[u][2 * r][c] >> shift) & mask;
            const uint32_t c1 = (f.w[u][2 * r + 1][c] >> shift) & mask;
            b[r] = pack_bf16x2(dequant_f32<KIND>(c0, sf, zf, lut),
                               dequant_f32<KIND>(c1, sf, zf, lut));
        }
    }
}

// B fragments of one k step for the 4 * CW n-tiles: bf[4c + j] is
// dequant_col of this thread's column 4c + j.
template <int KIND, int CW, bool FOLD = false>
__device__ __forceinline__ void dequant_step(const Words<KIND, CW, FOLD>& f,
                                             int u, bool hi,
                                             const float* lut,
                                             uint32_t (*bf)[2]) {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            dequant_col<KIND, CW, FOLD>(f, u, hi, lut, c, j, bf[4 * c + j]);
        }
    }
}

// One k step: the NT n-tiles' B fragments against the MT m-tiles of the
// 16-wide x slice starting at column kc of xs.
template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (*acc)[NT][4],
                                         const uint16_t (*xs)[kLd], int kc,
                                         uint32_t (*bf)[2], int lane) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, &xs[mt * 16 + (lane & 15)][kc + (lane >> 4) * 8]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
        }
    }
}

// Write a warp's MT x 32 * CW output tile: bf16 y with one K split, else
// the split's f32 partial sums into ws. C fragment e of tile j holds row g
// (+8 for e >= 2) and warp column (2t + (e & 1)) * 4 * CW + j: per row,
// 8 * CW consecutive columns.
template <int MT, int CW>
__device__ __forceinline__ void store_tile(float (*acc)[4 * CW][4],
                                           float* __restrict__ ws,
                                           uint16_t* __restrict__ y, int M,
                                           int N, int wcol, int g, int t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
            const int row = mt * 16 + g + 8 * hrow;
            if (row >= M) continue;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int n = wcol + (2 * t + q) * 4 * CW;
                if (n >= N) continue;
                const int e = 2 * hrow + q;
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                    if (gridDim.y == 1) {
                        uint2 o;
                        o.x = pack_bf16x2(acc[mt][4 * c][e],
                                          acc[mt][4 * c + 1][e]);
                        o.y = pack_bf16x2(acc[mt][4 * c + 2][e],
                                          acc[mt][4 * c + 3][e]);
                        *reinterpret_cast<uint2*>(
                            y + (size_t)row * N + n + 4 * c) = o;
                    } else {
                        *reinterpret_cast<float4*>(
                            ws + ((size_t)blockIdx.y * M + row) * N + n +
                            4 * c) =
                            make_float4(acc[mt][4 * c][e],
                                        acc[mt][4 * c + 1][e],
                                        acc[mt][4 * c + 2][e],
                                        acc[mt][4 * c + 3][e]);
                    }
                }
            }
        }
    }
}

// The kernel body. MT m-tiles of 16 rows; CW words (4 * CW columns) per
// thread per packed row; STAGES chunks of 64 K in the pipeline. FOLD is
// the scale-folded policy.
template <int MT, int CW, int STAGES, int KIND, bool FOLD>
__device__ __forceinline__ void
dequant_mma_body(const uint16_t* __restrict__ x,       // [M, Kp] bf16
                 const uint8_t* __restrict__ data,     // [Kp/2, N] | [Kp, N]
                 const uint16_t* __restrict__ scale,   // [Kp/B, N] bf16
                 const uint16_t* __restrict__ zero,    // [Kp/B, N] (asym)
                 const float* __restrict__ lut_g,      // [16] (codebook)
                 float* __restrict__ ws,               // [split, M, N] f32
                 uint16_t* __restrict__ y,             // [M, N] bf16
                 int M, int Kp, int N, int block, int chunks_per_split) {
    constexpr int NT = 4 * CW;             // 8-column mma tiles per warp
    constexpr int kWarpCols = 8 * NT;
    __shared__ __align__(16) uint16_t xs[STAGES][MT * 16][kLd];
    __shared__ float lut[16];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wcol = (blockIdx.x * kWarps + warp) * kWarpCols;
    const int ncol = wcol + g * 4 * CW;    // this thread's 4 * CW columns
    const bool col_ok = ncol < N;          // N % (4 * CW) == 0: all or none
    const int half = block >> 1;
    if (KIND == KIND_CODEBOOK4 && tid < 16) lut[tid] = lut_g[tid];

    static_assert(KIND != KIND_BF16, "B6's dense stack is not on this body");
    static_assert(!(FOLD && KIND == KIND_ASYM4),
                  "FOLD takes sym, codebook and int4-layout weights");
    // FOLD: the first of this thread's 8 * CW C columns
    const int ccol = wcol + 8 * CW * t;
    float acc[MT][NT][4];
    // FOLD: the current quant block's partial sums
    float part[FOLD ? MT : 1][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc[mt][j][e] = 0.f;
                if (FOLD) part[mt][j][e] = 0.f;
            }
        }
    }

    const int nchunks = (Kp + kChunk - 1) / kChunk;
    const int c_begin = blockIdx.y * chunks_per_split;
    const int c_end = min(nchunks, c_begin + chunks_per_split);

    // Chunk c's words sit in ring[(c - c_begin) % STAGES] and its x in
    // xs[(c - c_begin) % STAGES]. The loop is unrolled by STAGES so every
    // slot index is a constant: registers still waiting for their loads
    // are never copied (a copy would stall until the load lands).
    Words<KIND, CW, FOLD> ring[STAGES];
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        const int c = c_begin + i;
        if (c < c_end) {
            stage_x<MT>(xs[i], x, M, Kp, c * kChunk, tid);
            load_chunk<KIND, CW, FOLD>(ring[i], data, scale, zero,
                                       c * kChunk,
                                       min(kChunk, Kp - c * kChunk), N, ncol,
                                       col_ok, ccol, block, t);
        }
        cp_async_commit();
    }
    for (int c0 = c_begin; c0 < c_end; c0 += STAGES) {
#pragma unroll
        for (int i = 0; i < STAGES; ++i) {
            const int c = c0 + i;
            if (c >= c_end) break;
            // refill the slot the previous chunk freed with chunk
            // c + STAGES - 1
            const int cn = c + STAGES - 1;
            const int sn = (i + STAGES - 1) % STAGES;
            if (cn < c_end) {
                stage_x<MT>(xs[sn], x, M, Kp, cn * kChunk, tid);
                load_chunk<KIND, CW, FOLD>(ring[sn], data, scale, zero,
                                           cn * kChunk,
                                           min(kChunk, Kp - cn * kChunk), N,
                                           ncol, col_ok, ccol, block, t);
            }
            cp_async_commit();
            cp_async_wait<STAGES - 1>();   // chunk c's x has landed
            __syncthreads();

            const int klen = min(kChunk, Kp - c * kChunk);
            // STD sums into acc, FOLD into the block's part
            auto step = [&](int kc, uint32_t (*bf)[2]) {
                if constexpr (FOLD) {
                    mma_step<MT, NT>(part, xs[i], kc, bf, lane);
                } else {
                    mma_step<MT, NT>(acc, xs[i], kc, bf, lane);
                }
            };
#pragma unroll
            for (int u = 0; u < Words<KIND, CW, FOLD>::kUnits; ++u) {
                constexpr int uk = unit_k<KIND>();
                if (uk * u >= klen) continue;
                uint32_t bf[NT][2];
                if (row_units(KIND)) {
                    dequant_step<KIND, CW, FOLD>(ring[i], u, false, lut, bf);
                    step(16 * u, bf);
                } else {
                    // the unit's 16 packed rows: k [kl, kl+16) and +half
                    // (the int4 layout: block 32, so half is 16)
                    const int blk = (16 * u) / half;
                    const int kl = blk * block + (16 * u - blk * half);
                    dequant_step<KIND, CW, FOLD>(ring[i], u, false, lut, bf);
                    step(kl, bf);
                    dequant_step<KIND, CW, FOLD>(ring[i], u, true, lut, bf);
                    step(kl + half, bf);
                }
                if constexpr (FOLD) {
                    // (compile-time block: the scale words stay in
                    // registers)
                    constexpr int fb = kind_block<KIND>();
                    if ((uk * (u + 1)) % fb != 0) continue;
                    // the block is complete: acc += part * scale of the C
                    // column (2t + (e & 1)) * 4CW + j, then a fresh part
                    const uint32_t* sw = ring[i].s[(uk * u) / fb];
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
#pragma unroll
                        for (int q = 0; q < 2; ++q) {
                            const uint32_t w2 = sw[2 * CW * q + (j >> 1)];
                            const float sc = (j & 1) ? bf16_hi(w2)
                                                     : bf16_lo(w2);
#pragma unroll
                            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                                for (int e = q; e < 4; e += 2) {
                                    acc[mt][j][e] = fmaf(part[mt][j][e], sc,
                                                         acc[mt][j][e]);
                                    part[mt][j][e] = 0.f;
                                }
                            }
                        }
                    }
                }
            }
            __syncthreads();               // xs[i] free for reuse
        }
    }
    cp_async_wait<0>();

    store_tile<MT, CW>(acc, ws, y, M, N, wcol, g, t);
}

// B1 (fold, mxuflat): one weight, all M rows.
template <int MT, int CW, int STAGES, int KIND, bool FOLD = false>
__global__ void __launch_bounds__(kThreads)
dequant_mma_kernel(const uint16_t* __restrict__ x,
                   const uint8_t* __restrict__ data,
                   const uint16_t* __restrict__ scale,
                   const uint16_t* __restrict__ zero,
                   const float* __restrict__ lut_g, float* __restrict__ ws,
                   uint16_t* __restrict__ y, int M, int Kp, int N, int block,
                   int chunks_per_split) {
    dequant_mma_body<MT, CW, STAGES, KIND, FOLD>(
        x, data, scale, zero, lut_g, ws, y, M, Kp, N, block,
        chunks_per_split);
}

// y = bf16(sum over splits of ws), summed in split order
__global__ void finalize_kernel(const float* __restrict__ ws,
                                uint16_t* __restrict__ y, int split, int mn) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= mn) return;
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += ws[(size_t)s * mn + i];
    y[i] = f32_to_bf16(v);
}

// One launch of a single-kind variant (the int4-layout and scale-folded
// bodies: fold, mxuflat) and the split-order sum when split > 1.
// Returns the cudaError_t of the launches.
template <int MT, int CW, int STAGES, int KIND, bool FOLD>
int launch_variant(const void* x, const void* data, const void* scale,
                   const void* lut, void* ws, void* y, int M, int Kp, int N,
                   int block, int split, int cps, cudaStream_t st) {
    constexpr int cols = kWarps * 32 * CW;
    dequant_mma_kernel<MT, CW, STAGES, KIND, FOLD>
        <<<dim3((N + cols - 1) / cols, split), kThreads, 0, st>>>(
            (const uint16_t*)x, (const uint8_t*)data, (const uint16_t*)scale,
            nullptr, (const float*)lut, (float*)ws, (uint16_t*)y, M, Kp, N,
            block, cps);
    if (split > 1) {
        const int mn = M * N;
        finalize_kernel<<<(mn + 255) / 256, 256, 0, st>>>(
            (const float*)ws, (uint16_t*)y, split, mn);
    }
    return (int)cudaGetLastError();
}

// Resident blocks per SM of a single-kind variant (0 on error).
template <int MT, int CW, int STAGES, int KIND, bool FOLD>
int variant_blocks_per_sm() {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, dequant_mma_kernel<MT, CW, STAGES, KIND, FOLD>, kThreads, 0);
    return e == cudaSuccess ? n : 0;
}

// The shape rules every launch needs (see the wrappers in
// bigdl_tpu_torch/ops/cuda/dequant_matmul.py).
inline bool args_ok(int M, int Kp, int N, int block, int kind, int split,
                    int cps, const void* ws, int cw) {
    const int nchunks = (Kp + kChunk - 1) / kChunk;
    return M >= 1 && Kp >= block && N >= 4 && N % (4 * cw) == 0
           && block % 32 == 0
           && kChunk % block == 0 && Kp % block == 0 && kind >= 0
           && kind <= KIND_I4 && split >= 1 && cps >= 1
           && (split - 1) * cps < nchunks && split * cps >= nchunks
           && (split == 1 || ws != nullptr);
}

}  // namespace dqmma

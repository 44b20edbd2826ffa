// The small-M dequant matmul: y[M, N] = x[M, Kp] . W[Kp, N] over
// block-quantized or dense bf16 W for M <= 32, on mma.sync (m16n8k16, bf16
// in, f32 accumulate; the Q8 policy m16n8k32, s8 in, s32 accumulate). It is
// the body of every B1 decode GEMV (std in dequant_gemv.cu; mxu, fold,
// mxuflat and mxu8 in dequant_variants.cu) and of B6's decode tiles over a
// quantized or a dense bf16 expert stack (moe_dispatch.cu, the small-M
// entry). Its weight words and their dequantization (namespace dqmma: Words,
// load_chunk, dequant_col) also feed the Hopper body of B2 and B6's prefill
// tiles (dequant_wgmma.cuh).
//
// Replaces bigdl_tpu/ops/pallas/dequant_matmul.py::_q_gemv_pallas (L473:
// `_gemv_kernel` L144, `_gemv_kernel_fold` L172, `_gemv_kernel_mxu` L234,
// `_gemv_kernel_mxuflat` L265, `_gemv_kernel_mxu8` L284) and the decode
// tiles of bigdl_tpu/ops/pallas/moe_dispatch.py::ragged_expert_matmul (L90,
// `_ragged_kernel_q` L66, `_ragged_kernel_dense` L84). It computes what they
// compute and does not carry the Pallas blocks over.
//
// Bound on the H100: bytes. At M <= 32 a sym_int4 weight costs 4.5 bits of
// device memory and 2 M flops (a bf16 weight 16 bits), so streaming the
// planes at 3.35 TB/s is the floor (Llama-2-7B's gate_up, 4096 x 22016:
// 51 MB, 0.0153 ms).
//
// Design.
// - A and B are swapped. The dequantized weights are the mma A operand, 16
//   output columns a tile; x is the B operand, 8 tokens an n8 tile,
//   ceil(M / 8) tiles. No tile row is padding at M <= 8 (x as A in m16
//   tiles pads half of each), and the registers that padding would take
//   carry 16-byte weight loads instead.
// - Lane (g, t) loads packed rows unit_row(t, i) of columns ncol ..
//   ncol+4CW-1 straight from device memory (Words, load_chunk) and
//   dequantizes them with dequant_col. The bf16 pairs of two of the lane's
//   columns are the A fragment of one 16-column tile (rows g and g + 8), so
//   the words feed the product as they are; the store undoes the column
//   permutation. The C rows a lane holds are the columns whose codes it
//   loaded, so FOLD (mxu, fold) scales each quant block's f32 sum with the
//   scales it loaded beside the codes: one scale load, one set of C
//   fragments. A dense bf16 stack's rows pair into the A fragment by byte
//   permutes, no decode (8 weights a 16-byte load at cw 2).
// - Q8 (mxu8): x is quantized inside the launch. Each warp quantizes the
//   32-K blocks of every x chunk it stages, with the JAX package's
//   expression, straight into the registers of the m16n8k32 B fragments
//   (a lane's eight values of a block are its fragment; the block's amax
//   is reduced over four lanes), so no code tile passes through shared
//   memory. The weights' codes (int4-layout nibbles or sym_int8 bytes)
//   widen to s8 four columns at a time into the A fragments (a 4 x 4 byte
//   transpose), and each quant block's exact int32 partial is scaled by
//   s[r, n] (loaded beside the codes) and sx[m, r] in f32. One launch a
//   call: no quantize launches, no workspace of its own.
// - Each warp streams its own chunks of 64 K (chunk c + 4i of the block's
//   range) with its own x ring in shared memory (cp.async, warp barriers
//   only). The 4 warps of a block share one strip of 32 CW columns and add
//   their sums in warp order in shared memory: no block barrier inside the
//   K loop (4 warps on 4 column groups sharing one x ring, a block barrier
//   a chunk, ran slower on the H100). Little's law asks ~25 KB in flight
//   per SM (3.35 TB/s x ~1 us); a chunk is 4.5 KB a warp at 16-byte loads
//   and two chunks are in flight (a third ran no faster and took the
//   registers of a third block).
// - K splits across blocks (gridDim.y) in one launch. Each split writes its
//   f32 partials to the workspace and takes a ticket for its strip; the
//   last block to arrive adds the strip's partials in split order (results
//   repeat bit for bit), writes bf16 y and resets the ticket. No second
//   kernel, no memset, no host sync, no allocation. The tickets assume one
//   stream: two launches in flight on two streams must not share a ticket
//   buffer.
//
// Numerics. STD (std, mxuflat, B6): f32 code times f32 scale (plus zero),
// rounded once to bf16, products summed in f32 (a dense stack: its bf16
// weights as they are). FOLD (mxu over the int4 layout; fold over sym_int4,
// the codebooks and sym_int8): raw codes (a codebook value rounded to
// bf16), each quant block summed in f32, times the f32 column scale, as
// `_gemv_kernel_fold` does. A unit of the K loop (a 16-row load of each
// lane's words) is 32 K of a 4-bit kind or 16 K of sym_int8, so a 64-K
// codebook block and a 32-K sym_int8 block span two units: their partial
// lives over both and is scaled once. Scaling each unit's sum instead (two
// FMAs a block, no partial held across units) ran 1-10% slower over nf4
// and sym_int8 at M 8 and 32 and nf4 at M 16, 2% faster only for sym_int8
// at M 16, timed in turns on the H100 (PERF.md section 6). Q8: exact int32
// block partials, times the f32 scale, times the f32 activation scale,
// summed in f32.
//
// RAGGED (B6): block z takes 128-row tile z of x, expert tile_expert[z] of
// an [E, ...] stack, and its first tile_rows[z] rows, at most 8 NT (the
// caller's max_tile_rows); the tile's other rows are written as zeros.
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

// The weight words of the small-M body and the Hopper body
// (dequant_wgmma.cuh): how a lane loads packed rows and dequantizes them.
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
// Q8 is the mxu8 body's m16n8k32 fragment (chunk_mma_q8 below): 32 K a
// unit (one quant block), lane t's k slots 4t..4t+3 and 16+4t..16+4t+3.
// int4-layout rows are then 2t, 2t+1, 2t+8, 2t+9 of the unit, as for the
// split-block nibbles; int8 rows 4t..4t+3 of a 16-row half unit.
template <int KIND, int CW, bool Q8 = false>
struct Words {
    static constexpr int kUnits = row_units(KIND) ? 4 : 2;
    static constexpr int kRowWords = KIND == KIND_BF16 ? 2 * CW : CW;
    uint32_t w[kUnits][4][kRowWords];       // (see unit_row)
    uint32_t s[kUnits][2 * CW];             // bf16 scales, 2 columns a word
    uint32_t z[kUnits][2 * CW];             // bf16 zeros (asym)
};

// Packed row i (of 4) that lane t loads in a 16-row unit: rows 2t, 2t+1,
// 2t+8, 2t+9, the k slots 2t, 2t+1, 2t+8, 2t+9 of a k step (of both the low
// and the high nibbles' steps for split-block codes); the int4 layout's t,
// t+4, t+8, t+12 (a byte holds K rows 2i, 2i+1: the unit's two k steps).
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
// (klen valid K rows).
template <int KIND, int CW, bool Q8 = false>
__device__ __forceinline__ void load_chunk(
    Words<KIND, CW, Q8>& f, const uint8_t* __restrict__ data,
    const uint16_t* __restrict__ scale, const uint16_t* __restrict__ zero,
    int k0, int klen, int N, int ncol, bool col_ok, int block, int t) {
    using W = Words<KIND, CW, Q8>;
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
            if constexpr (KIND != KIND_BF16) {
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
#pragma unroll
            for (int c = 0; c < 2 * CW; ++c) {
                f.s[u][c] = 0u;
                f.z[u][c] = 0u;
            }
        }
    }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}

// The codebook table entry the FOLD policy reads for the value v: its bf16
// bits (rounded to nearest even), kept in a float slot of the table.
__device__ __forceinline__ float fold_lut_entry(float v) {
    return __uint_as_float(f32_to_bf16(v));
}

// Bf16 pair of one k step for this thread's column 4c + j: {k slots 2t
// and 2t+1, k slots 2t+8 and 2t+9} of byte j of word c (b[0], b[1]). For
// split-block codes `hi` picks the high nibbles, for the int4 layout the
// unit's second k step (rows t+8, t+12). FOLD leaves the scale out: the
// code itself, or a codebook value rounded to bf16 (lut then holds
// fold_lut_entry of each value). WT is any Words.
template <int KIND, int CW, bool FOLD, class WT>
__device__ __forceinline__ void dequant_col(const WT& f, int u, bool hi,
                                            const float* lut, int c, int j,
                                            uint32_t* b) {
    uint32_t sw = 0u;                 // FOLD reads no scale here
    if constexpr (!FOLD) sw = f.s[u][2 * c + (j >> 1)];
    if (FOLD && KIND == KIND_CODEBOOK4) {
        // the table entries of rows 2t and 2t + 1 (2t+8, 2t+9), read at the
        // code's byte offset 4 c, paired by one byte permute
        const int shift = 8 * j + (hi ? 4 : 0);
        auto entry = [&](uint32_t w) {
            const uint32_t off = (shift >= 2 ? w >> (shift - 2) : w << 2) &
                                 0x3cu;
            return __float_as_uint(*reinterpret_cast<const float*>(
                reinterpret_cast<const char*>(lut) + off));
        };
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            b[r] = __byte_perm(entry(f.w[u][2 * r][c]),
                               entry(f.w[u][2 * r + 1][c]), 0x5410);
        }
    } else if (FOLD && KIND == KIND_SYM8) {
        // byte j ^ 0x80 under the f32 exponent of 2^23 is 2^23 + 128 + the
        // int8 code, exactly
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float v[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t w = f.w[u][2 * r + i][c] ^ 0x80808080u;
                v[i] = __uint_as_float(__byte_perm(w, 0x4B000000u,
                                                   0x7540 | j)) -
                       8388736.f;
            }
            b[r] = pack_bf16x2(v[0], v[1]);
        }
    } else if (KIND == KIND_I4) {
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

}  // namespace dqmma

namespace smallm {

using dqmma::kChunk;
using dqmma::kLd;
using dqmma::RaggedArgs;
using dqmma::Words;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 128;               // rows of one B6 token tile

// 32-bit registers of one chunk's words (data, scales, zeros) a thread
template <int KIND, int CW>
__host__ __device__ constexpr int stage_regs() {
    using W = Words<KIND, CW>;
    return W::kUnits * (4 * W::kRowWords + (KIND == KIND_BF16 ? 0 : 2 * CW)) +
           (KIND == KIND_ASYM4 ? W::kUnits * 2 * CW : 0);
}

// Chunks of words in the ring: as many as keep the ring and the f32 sums
// (8 CW NT) within 64 registers, 2 to 4 (at 16-byte loads two).
template <int KIND, int NT, int CW>
__host__ __device__ constexpr int stages() {
    constexpr int p = stage_regs<KIND, CW>();
    constexpr int acc = 8 * CW * NT;
    return (3 * p + acc <= 64) ? 4 : (2 * p + acc <= 64) ? 3 : 2;
}

// Resident blocks a variant asks the compiler for: 3 (168 registers) at
// one n8 tile over the 4-bit kinds, where it costs at most a few spilled
// bytes and buys a third block per SM (std sym_int4 compiles to 172
// registers unasked, two blocks); else 1. Asym, int8 and two or more n8
// tiles spill hundreds of bytes at 168.
template <int NT, int KIND>
__host__ __device__ constexpr int min_blocks() {
    return NT == 1 && (KIND == KIND_SYM4 || KIND == KIND_I4 ||
                       KIND == KIND_CODEBOOK4) ? 3 : 1;
}

// Dynamic shared memory: the warps' x rings, reused after the K loop for
// the sums of warps 1-3.
template <int KIND, int NT, int CW>
__host__ __device__ constexpr int smem_bytes() {
    constexpr int ring = kWarps * stages<KIND, NT, CW>() * 8 * NT * kLd * 2;
    constexpr int red = (kWarps - 1) * 8 * CW * NT * 32 * 4;
    return ring > red ? ring : red;
}

// ldmatrix of two 8x8 bf16 matrices (lanes 0-15 give the row addresses)
__device__ __forceinline__ void ldmatrix_x2(uint32_t* a, const void* p) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
        : "=r"(a[0]), "=r"(a[1])
        : "r"(addr)
        : "memory");
}

// Copy rows [0, rows) of x[:, k0:k0+64] into a warp's xs (K >= Kp as
// zeros, rows >= m_live as zeros, rows >= rows not at all).
template <int R>
__device__ __forceinline__ void stage_rows(uint16_t (*xs)[kLd],
                                           const uint16_t* __restrict__ x,
                                           int m_live, int rows, int Kp,
                                           int k0, int lane) {
#pragma unroll
    for (int r = 0; r < R * (kChunk / 8) / 32; ++r) {
        const int i = lane + 32 * r;
        const int m = i / (kChunk / 8);
        const int k = k0 + 8 * (i % (kChunk / 8));
        if (m < rows) {
            const bool ok = m < m_live && k < Kp;
            cp_async16(&xs[m][k - k0], ok ? x + (size_t)m * Kp + k : x,
                       ok ? 16 : 0);
        }
    }
}

// One chunk's products: the lane's 2 CW 16-column tiles against the live
// n8 tiles of the chunk's x.
template <int NT, int CW, int KIND, bool FOLD>
__device__ __forceinline__ void chunk_mma(float (*acc)[NT][4],
                                          const Words<KIND, CW>& f,
                                          const uint16_t (*xs)[kLd],
                                          int klen, int nt_live,
                                          const float* lut, int lane) {
    using W = Words<KIND, CW>;
    constexpr int NS = row_units(KIND) ? 1 : 2;      // k steps a unit
    constexpr int uk = dqmma::unit_k<KIND>();
    constexpr int kBlock = dqmma::kind_block<KIND>();
    constexpr int half = kBlock >> 1;
    // FOLD: a quant block's f32 partials, summed over its units (one a
    // sym_int4 or int4-layout block, two a codebook or sym_int8 block)
    constexpr int kFoldUnits = kBlock / uk;
    [[maybe_unused]] float part[FOLD ? 2 * CW : 1][NT][4];
#pragma unroll
    for (int u = 0; u < W::kUnits; ++u) {
        if (uk * u >= klen) continue;
        // the unit's k steps: int8 16 rows; 4-bit codes the low nibbles
        // (int4 layout: first step) at kl, the high (second) at kl + half
        int kc0 = 16 * u, kc1 = 0;
        if (NS == 2) {
            const int blk = (16 * u) / half;
            kc0 = blk * kBlock + (16 * u - blk * half);
            kc1 = kc0 + half;
        }
        uint32_t bx[NS][NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nt_live) continue;
            const uint16_t* row = xs[nt * 8 + (lane & 7)];
            if constexpr (NS == 2) {
                uint32_t q[4];
                ldmatrix_x4(q, row + ((lane & 16) ? kc1 : kc0) + (lane & 8));
                bx[0][nt][0] = q[0];
                bx[0][nt][1] = q[1];
                bx[1][nt][0] = q[2];
                bx[1][nt][1] = q[3];
            } else {
                ldmatrix_x2(bx[0][nt], row + kc0 + (lane & 8));
            }
        }
#pragma unroll
        for (int p = 0; p < 2 * CW; ++p) {
            // tile p: rows g and g + 8 are the lane's columns 2p and 2p + 1
            uint32_t a[NS][4];
            if constexpr (KIND == KIND_BF16) {
                // columns 2p and 2p + 1 are the halves of word p of rows
                // 2t, 2t+1 (k slots 2t, 2t+1) and 2t+8, 2t+9
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    a[0][2 * r] = __byte_perm(f.w[u][2 * r][p],
                                              f.w[u][2 * r + 1][p], 0x5410);
                    a[0][2 * r + 1] = __byte_perm(f.w[u][2 * r][p],
                                                  f.w[u][2 * r + 1][p],
                                                  0x7632);
                }
            } else {
#pragma unroll
                for (int st = 0; st < NS; ++st) {
                    uint32_t b0[2], b1[2];
                    dqmma::dequant_col<KIND, CW, FOLD>(f, u, st == 1, lut,
                                                       (2 * p) >> 2,
                                                       (2 * p) & 3, b0);
                    dqmma::dequant_col<KIND, CW, FOLD>(f, u, st == 1, lut,
                                                       (2 * p + 1) >> 2,
                                                       (2 * p + 1) & 3, b1);
                    a[st][0] = b0[0];
                    a[st][1] = b1[0];
                    a[st][2] = b0[1];
                    a[st][3] = b1[1];
                }
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                if (nt >= nt_live) continue;
                if constexpr (FOLD) {
                    // the quant block's sum over its units, then times the
                    // column's scale (column 2p: low half of scale word p,
                    // 2p + 1: high)
                    float* pt = part[p][nt];
                    if (u % kFoldUnits == 0) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) pt[e] = 0.f;
                    }
#pragma unroll
                    for (int st = 0; st < NS; ++st) {
                        mma_bf16(pt, a[st], bx[st][nt][0], bx[st][nt][1]);
                    }
                    if (u % kFoldUnits != kFoldUnits - 1) continue;
                    const uint32_t sw = f.s[u][p];
                    const float lo = dqmma::bf16_lo(sw);
                    const float hi = dqmma::bf16_hi(sw);
                    acc[p][nt][0] = fmaf(pt[0], lo, acc[p][nt][0]);
                    acc[p][nt][1] = fmaf(pt[1], lo, acc[p][nt][1]);
                    acc[p][nt][2] = fmaf(pt[2], hi, acc[p][nt][2]);
                    acc[p][nt][3] = fmaf(pt[3], hi, acc[p][nt][3]);
                } else {
#pragma unroll
                    for (int st = 0; st < NS; ++st) {
                        mma_bf16(acc[p][nt], a[st], bx[st][nt][0],
                                 bx[st][nt][1]);
                    }
                }
            }
        }
    }
}

// 4 consecutive f32 -> 4 bf16 at y
__device__ __forceinline__ void store_bf16x4(uint16_t* y, float a, float b,
                                             float c, float d) {
    uint2 o;
    o.x = pack_bf16x2(a, b);
    o.y = pack_bf16x2(c, d);
    *reinterpret_cast<uint2*>(y) = o;
}

// Two s32 codes (in [-127, 127]) a and b, c and d, as the bytes of a word
__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
    return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                       0x5410);
}

// Quantize quant block b of a warp's staged x chunk straight into the
// m16n8k32 B fragments: lane (g, t) holds token 8 nt + g's k slots
// 4t..4t+3 (bx[nt][0]) and 16+4t..16+4t+3 (bx[nt][1]), and the block's
// amax over its 32 values is reduced over the four lanes of g. The JAX
// package's expression (`_q_gemv_pallas` L532-537): amax of the block's
// bf16 values in f32, sx = amax * f32(1 / 127), inv = 1 / sx (0 where sx
// is 0; the IEEE reciprocal, the build uses no fast math), code = x * inv
// rounded half to even. sxr[nt] gets the sx of the lane's C columns,
// tokens 8 nt + 2t and 2t + 1.
template <int NT>
__device__ __forceinline__ void quantize_b(uint32_t (&bx)[NT][2],
                                           float (&sxr)[NT][2],
                                           const uint16_t (*xs)[kLd], int b,
                                           int nt_live, int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        if (nt >= nt_live) continue;
        const uint16_t* row = xs[8 * nt + g] + 32 * b + 4 * t;
        const uint2 lo = *reinterpret_cast<const uint2*>(row);
        const uint2 hi = *reinterpret_cast<const uint2*>(row + 16);
        const uint32_t w[4] = {lo.x, lo.y, hi.x, hi.y};
        float f[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = dqmma::bf16_lo(w[i]);
            f[2 * i + 1] = dqmma::bf16_hi(w[i]);
        }
        // |x| of a bf16 orders as its bits with the sign cleared: the
        // largest of the eight, two at a time, then as the f32 it is
        const uint32_t m2 = __vmaxu2(__vmaxu2(w[0] & 0x7fff7fffu,
                                              w[1] & 0x7fff7fffu),
                                     __vmaxu2(w[2] & 0x7fff7fffu,
                                              w[3] & 0x7fff7fffu));
        float amax = fmaxf(dqmma::bf16_lo(m2), dqmma::bf16_hi(m2));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        const float sx = __fmul_rn(amax, 1.0f / 127.0f);
        const float inv = sx == 0.f ? 0.f : __frcp_rn(sx);
        int q[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) q[i] = __float2int_rn(__fmul_rn(f[i], inv));
        bx[nt][0] = pack_s8x4(q[0], q[1], q[2], q[3]);
        bx[nt][1] = pack_s8x4(q[4], q[5], q[6], q[7]);
        sxr[nt][0] = __shfl_sync(0xffffffffu, sx, (2 * t) << 2);
        sxr[nt][1] = __shfl_sync(0xffffffffu, sx, (2 * t + 1) << 2);
    }
}

// Byte j of each of four rows' words as the four bytes of column j:
// c[j] = {r0.bj, r1.bj, r2.bj, r3.bj}.
__device__ __forceinline__ void transpose_bytes(uint32_t r0, uint32_t r1,
                                                uint32_t r2, uint32_t r3,
                                                uint32_t (&c)[4]) {
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    c[0] = __byte_perm(t0, t1, 0x5410);
    c[1] = __byte_perm(t0, t1, 0x7632);
    c[2] = __byte_perm(t2, t3, 0x5410);
    c[3] = __byte_perm(t2, t3, 0x7632);
}

// The s8 codes of the lane's four columns 4c .. 4c + 3 in quant block b of
// a chunk (Q8's row map): v[r][j] holds column 4c + j's k slots 4t..4t+3
// (r 0) and 16+4t..16+4t+3 (r 1). The int4 layout: the low and high
// nibbles of packed rows 2t, 2t+1 (K rows 4t..4t+3), each sign-extended to
// a byte four at a time; int8: rows 4t..4t+3's bytes.
template <int KIND, int CW>
__device__ __forceinline__ void widen_word(
    const Words<KIND, CW, true>& f, int b, int c,
    uint32_t (&v)[2][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if constexpr (KIND == KIND_I4) {
            const uint32_t w0 = f.w[b][2 * r][c];
            const uint32_t w1 = f.w[b][2 * r + 1][c];
            // (n ^ 8) - 8 a byte: the nibble n as a signed byte
            auto s8 = [](uint32_t w) {
                return __vsub4(lop3<0x6A>(w, 0x0f0f0f0fu, 0x08080808u),
                               0x08080808u);
            };
            transpose_bytes(s8(w0), s8(w0 >> 4), s8(w1), s8(w1 >> 4), v[r]);
        } else {
            transpose_bytes(f.w[2 * b + r][0][c], f.w[2 * b + r][1][c],
                            f.w[2 * b + r][2][c], f.w[2 * b + r][3][c], v[r]);
        }
    }
}

// One chunk's Q8 products: per quant block, x's codes quantized into the
// live n8 B tiles, against the lane's 2 CW 16-column s8 A tiles, each
// int32 partial times the column's scale and then the token's sx, in f32.
template <int NT, int CW, int KIND>
__device__ __forceinline__ void chunk_mma_q8(float (*acc)[NT][4],
                                             const Words<KIND, CW, true>& f,
                                             const uint16_t (*xs)[kLd],
                                             int klen, int nt_live,
                                             int lane) {
#pragma unroll
    for (int b = 0; b < kChunk / 32; ++b) {
        if (32 * b >= klen) continue;
        uint32_t bx[NT][2];
        float sxr[NT][2];
        quantize_b<NT>(bx, sxr, xs, b, nt_live, lane);
        // block b's scales of the lane's columns (int4 layout: unit b;
        // int8: unit 2b, 16 K a unit)
        const uint32_t* sw = f.s[KIND == KIND_I4 ? b : 2 * b];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
            uint32_t v[2][4];
            widen_word<KIND, CW>(f, b, c, v);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                // tile p: rows g and g + 8 are the lane's columns 2p, 2p + 1
                const int p = 2 * c + h;
                const uint32_t a[4] = {v[0][2 * h], v[0][2 * h + 1],
                                       v[1][2 * h], v[1][2 * h + 1]};
                const float s0 = dqmma::bf16_lo(sw[p]);
                const float s1 = dqmma::bf16_hi(sw[p]);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    if (nt >= nt_live) continue;
                    int part[4] = {0, 0, 0, 0};
                    mma_s8(part, a, bx[nt][0], bx[nt][1]);
                    acc[p][nt][0] += __fmul_rn(__fmul_rn((float)part[0], s0),
                                               sxr[nt][0]);
                    acc[p][nt][1] += __fmul_rn(__fmul_rn((float)part[1], s0),
                                               sxr[nt][1]);
                    acc[p][nt][2] += __fmul_rn(__fmul_rn((float)part[2], s1),
                                               sxr[nt][0]);
                    acc[p][nt][3] += __fmul_rn(__fmul_rn((float)part[3], s1),
                                               sxr[nt][1]);
                }
            }
        }
    }
}

template <int NT, int CW, int KIND, bool FOLD, bool RAGGED, bool Q8>
__device__ __forceinline__ void
smallm_body(const uint16_t* __restrict__ x,       // [M, Kp] bf16
            const uint8_t* __restrict__ data,     // [Kp/2, N] | [Kp, N]
            const uint16_t* __restrict__ scale,   // [Kp/B, N] bf16
            const uint16_t* __restrict__ zero,    // [Kp/B, N] (asym)
            const float* __restrict__ lut_g,      // [16] (codebook)
            float* __restrict__ ws,               // [split, tiles*rows, N]
            unsigned* __restrict__ tickets,       // [tiles * strips]
            uint16_t* __restrict__ y,             // [M, N] bf16
            int M, int Kp, int N, int chunks_per_split,
            const RaggedArgs& ra) {
    constexpr int STAGES = stages<KIND, NT, CW>();
    constexpr int R = 8 * NT;              // x rows a warp stages
    constexpr int P = 2 * CW;              // 16-column tiles a warp
    constexpr int kCols = 32 * CW;         // columns a block (its strip)
    constexpr int kAcc = P * NT * 4;
    // the kind's quant block (args_ok checks the caller's)
    constexpr int kBlock = dqmma::kind_block<KIND>();
    static_assert(!FOLD || (KIND != KIND_ASYM4 && KIND != KIND_BF16),
                  "FOLD takes sym, codebook and int4-layout weights");
    static_assert(!RAGGED || (!FOLD && !Q8), "B6 takes the std numerics");
    static_assert(!Q8 || (!FOLD && (KIND == KIND_I4 || KIND == KIND_SYM8)),
                  "Q8 reads int4-layout or sym_int8 weights");
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ float lut[16];
    __shared__ int is_last;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;

    // rows multiplied (m_live), written from acc (m_rows) and written in
    // all (m_out), from row0; ws rows of this tile from wrow0
    int m_live = M, m_rows = M, m_out = M, row0 = 0, wrow0 = 0, tix = 0;
    if (RAGGED) {
        const int tile = blockIdx.z;
        // an id outside [0, E) breaks the caller's contract; clamp it so no
        // read leaves the stack
        const int e = min(max(ra.tile_expert[tile], 0), ra.num_experts - 1);
        data += (size_t)e * ra.data_es;
        scale += (size_t)e * ra.scale_es;
        if (KIND == KIND_ASYM4) zero += (size_t)e * ra.scale_es;
        row0 = tile * kTile;
        m_rows = R;
        m_out = kTile;
        m_live = min(max(ra.tile_rows[tile], 0), R);
        wrow0 = tile * R;
        tix = tile * gridDim.x;
        x += (size_t)row0 * Kp;
    }
    tix += blockIdx.x;
    const int ws_rows = RAGGED ? gridDim.z * R : M;
    const int nt_live = (m_live + 7) / 8;
    const int ncol = blockIdx.x * kCols + g * 4 * CW;   // the lane's columns
    const bool col_ok = ncol < N;          // N % (4 * CW) == 0: all or none
    if (KIND == KIND_CODEBOOK4) {
        if (tid < 16) {
            lut[tid] = FOLD ? dqmma::fold_lut_entry(lut_g[tid]) : lut_g[tid];
        }
        __syncthreads();
    }

    float acc[P][NT][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
        }
    }

    const int nchunks = (Kp + kChunk - 1) / kChunk;
    const int c_begin = blockIdx.y * chunks_per_split;
    // a ragged tile with no real row loads nothing and writes zeros
    const int c_end = (RAGGED && m_live == 0)
                          ? c_begin
                          : min(nchunks, c_begin + chunks_per_split);
    // this warp's chunks: c_begin + warp + kWarps * i, i < mine
    const int mine = (c_end - c_begin - warp + kWarps - 1) / kWarps;
    const int c0 = c_begin + warp;
    uint16_t (*xs)[R][kLd] =
        reinterpret_cast<uint16_t (*)[R][kLd]>(smem) + warp * STAGES;

    // Chunk i's words sit in ring[i % STAGES], its x in xs[i % STAGES]; the
    // loop is unrolled by STAGES so every slot index is a constant.
    Words<KIND, CW, Q8> ring[STAGES];
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < mine) {
            const int k0 = (c0 + kWarps * s) * kChunk;
            stage_rows<R>(xs[s], x, m_live, 8 * nt_live, Kp, k0, lane);
            dqmma::load_chunk<KIND, CW, Q8>(
                ring[s], data, scale, zero, k0, min(kChunk, Kp - k0), N,
                ncol, col_ok, kBlock, t);
        }
        cp_async_commit();
    }
    for (int i0 = 0; i0 < mine; i0 += STAGES) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            const int i = i0 + s;
            if (i >= mine) break;
            // refill the slot chunk i - 1 freed with chunk i + STAGES - 1
            const int in = i + STAGES - 1;
            const int sn = (s + STAGES - 1) % STAGES;
            if (in < mine) {
                const int k0 = (c0 + kWarps * in) * kChunk;
                stage_rows<R>(xs[sn], x, m_live, 8 * nt_live, Kp, k0, lane);
                dqmma::load_chunk<KIND, CW, Q8>(
                    ring[sn], data, scale, zero, k0, min(kChunk, Kp - k0), N,
                    ncol, col_ok, kBlock, t);
            }
            cp_async_commit();
            cp_async_wait<STAGES - 1>();   // chunk i's x has landed
            __syncwarp();
            const int k0 = (c0 + kWarps * i) * kChunk;
            if constexpr (Q8) {
                chunk_mma_q8<NT, CW, KIND>(acc, ring[s], xs[s],
                                           min(kChunk, Kp - k0), nt_live,
                                           lane);
            } else {
                chunk_mma<NT, CW, KIND, FOLD>(acc, ring[s], xs[s],
                                              min(kChunk, Kp - k0), nt_live,
                                              lut, lane);
            }
            __syncwarp();                  // xs[s] free for its refill
        }
    }
    cp_async_wait<0>();

    // the block's sum: warp 0's, then warps 1, 2, 3 in order
    __syncthreads();                       // every x ring is done with
    float* red = reinterpret_cast<float*>(smem);     // [3][kAcc][32]
    if (warp > 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int a = (p * NT + nt) * 4 + e;
                    red[((warp - 1) * kAcc + a) * 32 + lane] = acc[p][nt][e];
                }
            }
        }
    }
    __syncthreads();
    const int split = gridDim.y;
    if (warp == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int a = (p * NT + nt) * 4 + e;
#pragma unroll
                    for (int w = 0; w < kWarps - 1; ++w) {
                        acc[p][nt][e] += red[(w * kAcc + a) * 32 + lane];
                    }
                }
            }
        }
        // acc[p][nt][e]: column ncol + 2p + (e >> 1), row 8nt + 2t + (e & 1)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int row = nt * 8 + 2 * t + e;
                if (!col_ok || row >= m_rows) continue;
#pragma unroll
                for (int q = 0; q < CW; ++q) {
                    const int p = 2 * q;
                    if (split == 1) {
                        store_bf16x4(y + ((size_t)row0 + row) * N + ncol +
                                         4 * q,
                                     acc[p][nt][e], acc[p][nt][2 + e],
                                     acc[p + 1][nt][e],
                                     acc[p + 1][nt][2 + e]);
                    } else {
                        __stcg(reinterpret_cast<float4*>(
                                   ws + ((size_t)blockIdx.y * ws_rows +
                                         wrow0 + row) * N + ncol + 4 * q),
                               make_float4(acc[p][nt][e], acc[p][nt][2 + e],
                                           acc[p + 1][nt][e],
                                           acc[p + 1][nt][2 + e]));
                    }
                }
            }
        }
    }
    const int col0 = blockIdx.x * kCols;
    if (split > 1) {
        // the last split of the strip to arrive adds them all
        __threadfence();
        __syncthreads();
        if (tid == 0) {
            is_last = atomicAdd(&tickets[tix], 1u) == (unsigned)split - 1;
        }
        __syncthreads();
        if (!is_last) return;
        __threadfence();
        for (int i = tid; i < m_rows * (kCols / 4); i += kThreads) {
            const int row = i / (kCols / 4);
            const int n = col0 + 4 * (i % (kCols / 4));
            if (n >= N) continue;
            const float* src = ws + ((size_t)wrow0 + row) * N + n;
            float4 v = __ldcg(reinterpret_cast<const float4*>(src));
            for (int s = 1; s < split; ++s) {
                const float4 o = __ldcg(reinterpret_cast<const float4*>(
                    src + (size_t)s * ws_rows * N));
                v.x += o.x;
                v.y += o.y;
                v.z += o.z;
                v.w += o.w;
            }
            store_bf16x4(y + ((size_t)row0 + row) * N + n, v.x, v.y, v.z,
                         v.w);
        }
        if (tid == 0) tickets[tix] = 0u;
    }
    // B6: the tile's rows past the staged ones are zeros
    for (int i = tid; i < (m_out - m_rows) * (kCols / 4); i += kThreads) {
        const int row = m_rows + i / (kCols / 4);
        const int n = col0 + 4 * (i % (kCols / 4));
        if (n < N) {
            *reinterpret_cast<uint2*>(y + ((size_t)row0 + row) * N + n) =
                make_uint2(0u, 0u);
        }
    }
}

template <int NT, int CW, int KIND, bool FOLD, bool Q8>
__global__ void __launch_bounds__(kThreads, min_blocks<NT, KIND>())
smallm_gemv_kernel(const uint16_t* __restrict__ x,
                   const uint8_t* __restrict__ data,
                   const uint16_t* __restrict__ scale,
                   const uint16_t* __restrict__ zero,
                   const float* __restrict__ lut_g, float* __restrict__ ws,
                   unsigned* __restrict__ tickets, uint16_t* __restrict__ y,
                   int M, int Kp, int N, int chunks_per_split) {
    smallm_body<NT, CW, KIND, FOLD, false, Q8>(x, data, scale, zero, lut_g,
                                               ws, tickets, y, M, Kp, N,
                                               chunks_per_split,
                                               RaggedArgs{});
}

template <int NT, int CW, int KIND>
__global__ void __launch_bounds__(kThreads, min_blocks<NT, KIND>())
smallm_ragged_kernel(const uint16_t* __restrict__ x,
                     const uint8_t* __restrict__ data,
                     const uint16_t* __restrict__ scale,
                     const uint16_t* __restrict__ zero,
                     const float* __restrict__ lut_g, float* __restrict__ ws,
                     unsigned* __restrict__ tickets, uint16_t* __restrict__ y,
                     int M, int Kp, int N, int chunks_per_split,
                     RaggedArgs ra) {
    smallm_body<NT, CW, KIND, false, true, false>(x, data, scale, zero,
                                                  lut_g, ws, tickets, y, M,
                                                  Kp, N, chunks_per_split,
                                                  ra);
}

// The kernel of a variant, with its dynamic shared memory allowed past
// 48 KB once (0, or the cudaError_t of the attribute call).
template <int NT, int CW, int KIND, bool FOLD, bool RAGGED, bool Q8 = false>
int prepare(const void** fn) {
    if constexpr (RAGGED) {
        *fn = (const void*)smallm_ragged_kernel<NT, CW, KIND>;
    } else {
        *fn = (const void*)smallm_gemv_kernel<NT, CW, KIND, FOLD, Q8>;
    }
    constexpr int bytes = smem_bytes<KIND, NT, CW>();
    if constexpr (bytes > 48 * 1024) {
        static const int err = (int)cudaFuncSetAttribute(
            *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        return err;
    }
    return 0;
}

// One launch over strips of 32 CW columns x split x tiles (B6: one grid z a
// token tile). Returns the cudaError_t of the launch.
template <int NT, int CW, int KIND, bool FOLD, bool RAGGED, bool Q8 = false>
int launch(const void* x, const void* data, const void* scale,
           const void* zero, const void* lut, void* ws, void* tickets,
           void* y, int M, int Kp, int N, int split, int cps,
           int tiles, const RaggedArgs& ra, cudaStream_t st) {
    const void* fn;
    const int err = prepare<NT, CW, KIND, FOLD, RAGGED, Q8>(&fn);
    if (err) return err;
    const dim3 grid((N + 32 * CW - 1) / (32 * CW), split, tiles);
    constexpr int bytes = smem_bytes<KIND, NT, CW>();
    if constexpr (RAGGED) {
        smallm_ragged_kernel<NT, CW, KIND><<<grid, kThreads, bytes, st>>>(
            (const uint16_t*)x, (const uint8_t*)data, (const uint16_t*)scale,
            (const uint16_t*)zero, (const float*)lut, (float*)ws,
            (unsigned*)tickets, (uint16_t*)y, M, Kp, N, cps, ra);
    } else {
        smallm_gemv_kernel<NT, CW, KIND, FOLD, Q8>
            <<<grid, kThreads, bytes, st>>>(
                (const uint16_t*)x, (const uint8_t*)data,
                (const uint16_t*)scale, (const uint16_t*)zero,
                (const float*)lut, (float*)ws, (unsigned*)tickets,
                (uint16_t*)y, M, Kp, N, cps);
    }
    return (int)cudaGetLastError();
}

// Resident blocks per SM of a variant (0 on error).
template <int NT, int CW, int KIND, bool FOLD, bool RAGGED, bool Q8 = false>
int blocks_per_sm() {
    const void* fn;
    if (prepare<NT, CW, KIND, FOLD, RAGGED, Q8>(&fn)) return 0;
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fn, kThreads, smem_bytes<KIND, NT, CW>());
    return e == cudaSuccess ? n : 0;
}

// Calls F(NT, CW) for the variant that rows M (B6: the caller's
// max_tile_rows) and cw words a thread take: one n8 tile at M <= 8, two at
// M <= 16 (cw 4 or 1), four at M <= 32 (cw 2 or 1). Returns `err` for a
// combination no variant takes.
#define BIGDL_SMALLM_VARIANTS(F, M, cw, err)                                \
    if ((M) >= 1 && (M) <= 8 && (cw) == 4) F(1, 4)                          \
    if ((M) >= 1 && (M) <= 8 && (cw) == 1) F(1, 1)                          \
    if ((M) > 8 && (M) <= 16 && (cw) == 4) F(2, 4)                          \
    if ((M) > 8 && (M) <= 16 && (cw) == 1) F(2, 1)                          \
    if ((M) > 16 && (M) <= 32 && (cw) == 2) F(4, 2)                         \
    if ((M) > 16 && (M) <= 32 && (cw) == 1) F(4, 1)                         \
    return err;

// Calls F(NT, CW) for the dense bf16 variant (B6's small-M entry over a
// dense stack) that rows M and cw take: 1, 2 or 4 n8 tiles as above, with
// 16-byte (cw 2: 8 bf16 columns) or 8-byte (cw 1) row loads.
#define BIGDL_SMALLM_DENSE_VARIANTS(F, M, cw, err)                          \
    if ((M) >= 1 && (M) <= 8 && (cw) == 2) F(1, 2)                          \
    if ((M) >= 1 && (M) <= 8 && (cw) == 1) F(1, 1)                          \
    if ((M) > 8 && (M) <= 16 && (cw) == 2) F(2, 2)                          \
    if ((M) > 8 && (M) <= 16 && (cw) == 1) F(2, 1)                          \
    if ((M) > 16 && (M) <= 32 && (cw) == 2) F(4, 2)                         \
    if ((M) > 16 && (M) <= 32 && (cw) == 1) F(4, 1)                         \
    return err;

// Calls F(NT, CW, K) for the canonical quantized kind `kind` of a launch
// (sym_int4, asym_int4, the 4-bit codebooks, sym_int8).
#define BIGDL_SMALLM_KINDS(F, NT, CW)                                     \
    switch (kind) {                                                       \
        case KIND_SYM4: F(NT, CW, KIND_SYM4)                               \
        case KIND_ASYM4: F(NT, CW, KIND_ASYM4)                             \
        case KIND_CODEBOOK4: F(NT, CW, KIND_CODEBOOK4)                     \
        case KIND_SYM8: F(NT, CW, KIND_SYM8)                               \
        default: break;                                                   \
    }

// The shape rules of a small-M launch over quantized weights (see the
// wrappers in bigdl_tpu_torch/ops/cuda/dequant_matmul.py).
inline bool args_ok(int M, int Kp, int N, int block, int kind, int split,
                    int cps, const void* ws, const void* tickets, int cw) {
    const int nchunks = (Kp + kChunk - 1) / kChunk;
    return M >= 1 && Kp >= block && N >= 4 && N % (4 * cw) == 0 &&
           Kp % block == 0 && kind >= 0 && kind <= KIND_I4 &&
           block == (kind == KIND_CODEBOOK4 ? 64 : 32) && split >= 1 &&
           cps >= 1 && (split - 1) * cps < nchunks &&
           split * cps >= nchunks &&
           (split == 1 || (ws != nullptr && tickets != nullptr));
}

}  // namespace smallm

// The small-M dequant matmul: y[M, N] = x[M, Kp] . W[Kp, N] over
// block-quantized or dense bf16 W for M <= 32, on mma.sync (m16n8k16, bf16
// in, f32 accumulate; the Q8 policy m16n8k32, s8 in, s32 accumulate). It is
// the body of B1's std, mxu and mxu8 decode GEMVs (dequant_gemv.cu,
// dequant_variants.cu bodies 0 and 3) and of B6's decode tiles over a
// quantized or a dense bf16 expert stack (moe_dispatch.cu, the small-M
// entry).
//
// Replaces bigdl_tpu/ops/pallas/dequant_matmul.py::_q_gemv_pallas (L473:
// `_gemv_kernel` L144, `_gemv_kernel_mxu` L234, `_gemv_kernel_mxu8` L284)
// and the decode tiles of
// bigdl_tpu/ops/pallas/moe_dispatch.py::ragged_expert_matmul (L90,
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
//   ceil(M / 8) tiles. No tile row is padding at M <= 8, and the registers
//   the padding took in dequant_mma.cuh (x as A in m16 tiles) carry 16-byte
//   weight loads instead.
// - The weight words load as in dequant_mma.cuh (Words, load_chunk: lane
//   (g, t) loads packed rows unit_row(t, i) of columns ncol .. ncol+4CW-1)
//   and dequantize with dequant_col. The B fragment of two of the lane's
//   columns is the A fragment of one 16-column tile (rows g and g + 8), so
//   the words feed the product as they are; the store undoes the column
//   permutation. The C rows a lane holds are the columns whose codes it
//   loaded, so FOLD (mxu) scales each quant block's f32 sum with the scales
//   it loaded beside the codes: one scale load, one set of C fragments
//   (the block's sum lives for two mma). A dense bf16 stack's rows pair
//   into the A fragment by byte permutes, no decode (8 weights a 16-byte
//   load at cw 2).
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
// Numerics do not change. STD: f32 code times f32 scale (plus zero),
// rounded once to bf16, products summed in f32 (a dense stack: its bf16
// weights as they are). FOLD (int4 layout, block 32): raw codes, each 32-K
// block summed in f32, times the f32 column scale. Q8: exact int32 block
// partials, times the f32 scale, times the f32 activation scale, summed in
// f32.
//
// RAGGED (B6): block z takes 128-row tile z of x, expert tile_expert[z] of
// an [E, ...] stack, and its first tile_rows[z] rows, at most 8 NT (the
// caller's max_tile_rows); the tile's other rows are written as zeros.
#pragma once

#include "dequant_mma.cuh"

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
                    // the 32-K block's sum, then times the column's scale
                    // (column 2p: low half of scale word p, 2p + 1: high)
                    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                    for (int st = 0; st < NS; ++st) {
                        mma_bf16(part, a[st], bx[st][nt][0], bx[st][nt][1]);
                    }
                    const uint32_t sw = f.s[u][p];
                    const float lo = dqmma::bf16_lo(sw);
                    const float hi = dqmma::bf16_hi(sw);
                    acc[p][nt][0] = fmaf(part[0], lo, acc[p][nt][0]);
                    acc[p][nt][1] = fmaf(part[1], lo, acc[p][nt][1]);
                    acc[p][nt][2] = fmaf(part[2], hi, acc[p][nt][2]);
                    acc[p][nt][3] = fmaf(part[3], hi, acc[p][nt][3]);
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
    const Words<KIND, CW, false, true>& f, int b, int c,
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
                                             const Words<KIND, CW, false,
                                                         true>& f,
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
    static_assert(!FOLD || KIND == KIND_I4, "FOLD reads the int4 layout");
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
        if (tid < 16) lut[tid] = lut_g[tid];
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
    Words<KIND, CW, false, Q8> ring[STAGES];
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < mine) {
            const int k0 = (c0 + kWarps * s) * kChunk;
            stage_rows<R>(xs[s], x, m_live, 8 * nt_live, Kp, k0, lane);
            dqmma::load_chunk<KIND, CW, false, Q8>(
                ring[s], data, scale, zero, k0, min(kChunk, Kp - k0), N,
                ncol, col_ok, 0, kBlock, t);
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
                dqmma::load_chunk<KIND, CW, false, Q8>(
                    ring[sn], data, scale, zero, k0, min(kChunk, Kp - k0), N,
                    ncol, col_ok, 0, kBlock, t);
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

// The shape rules of a small-M launch.
inline bool args_ok(int M, int Kp, int N, int block, int kind, int split,
                    int cps, const void* ws, const void* tickets, int cw) {
    return dqmma::args_ok(M, Kp, N, block, kind, split, cps, ws, cw) &&
           block == (kind == KIND_CODEBOOK4 ? 64 : 32) &&
           (split == 1 || tickets != nullptr);
}

}  // namespace smallm

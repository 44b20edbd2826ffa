// The Hopper GEMM body: y[M, N] = x[M, Kp] . W[Kp, N] over block-quantized
// or dense bf16 W for 1 <= M <= 128, on wgmma (bf16 in, f32 accumulate) fed
// by TMA and an mbarrier ring. It is the body of B2's std and i4 prefill
// GEMMs (dequant_gemm.cu, one entry point for both layouts) and of B6's
// prefill tiles over a quantized or a dense bf16 expert stack
// (moe_dispatch.cu, the tiles entry).
//
// Replaces bigdl_tpu/ops/pallas/dequant_matmul.py::_q_matmul_generic (L641:
// `_kernel_4bit` L113, `_kernel_int8` L125, `_kernel_i4` L133, summed by
// `_accumulate` L94) and the prefill tiles of
// bigdl_tpu/ops/pallas/moe_dispatch.py::ragged_expert_matmul (L90,
// `_ragged_kernel_q` L66 and `_ragged_kernel_dense` L84). It computes what
// they compute and does not carry the Pallas blocks over.
//
// Bound on the H100. B2 at M 128 and Llama-2-7B widths: operations (gate_up
// does 23 GFLOP against 51 MB of packed planes, 0.023 ms at 989 TFLOP/s).
// B6 over a 256-token Mixtral chunk: bytes (each tile holding rows streams
// its expert's 33 MB of planes, or 117 MB of a dense bf16 stack, for 52-128
// rows). What held the port's first body (mma.sync, x as the A operand)
// back was the work around each weight, not the tensor cores: every thread
// loaded 4-byte words straight from device memory, synchronously with its
// dequantization, and mma.sync could not overlap the next step's
// dequantization.
//
// Design.
// - Quantized weights are wgmma's A operand, from registers; x is B, from
//   shared memory. The body computes y^T tiles: A is 64 output columns (a
//   warpgroup's tile) by 16 K, each warp dequantizing its 16 columns into
//   the fragment dequant_smallm.cuh builds (lane (g, t) holds columns 2g and
//   2g + 1 of its warp's 16, as A rows g and g + 8), with its dequant_col:
//   one decode for both bodies. B is x's [n tokens, 16 K]
//   slice; x [M, Kp] row-major is K-major for B, so it lands by TMA as it is
//   (128-byte rows, 128-byte swizzle) and the descriptor steps 32 bytes a k
//   step. n = 64 at M <= 64 and n = 128 above (B6: per tile, from
//   tile_rows, a branch uniform over the block).
// - A dense bf16 stack (KIND_BF16) needs no decode: its [64 K, 64 column]
//   boxes land by TMA as they are (128-byte rows of 64 columns, so column
//   n is A row n, M-major) and wgmma reads A from shared memory through a
//   transposed (M-major) descriptor, as it may for 16-bit types. The
//   consumers then only issue wgmma: four k steps of both tiles a chunk as
//   one group, one group left in flight while the next chunk's is issued.
//   (Reading A into registers with ldmatrix.trans instead, a k step
//   ahead, measured the same; PERF.md.) A stage is 32 KB of weights for 256
//   columns and 16 KB of x at n 128: four stages fill the shared memory (a
//   fifth does not fit).
// - A block is 2 consumer warpgroups (warps 0-7) of two 64-column tiles
//   each, 256 output columns, and a producer warpgroup (warps 8-11), whose
//   first warp keeps kStages chunks of 64 K in flight: x's [n, 64] boxes,
//   the codes' two [32 | 64 packed rows, 128] boxes (128-byte swizzle, so
//   the consumers' 2-byte reads of rows 2t, 2t+1, 2t+8, 2t+9 hit distinct
//   banks) and the scale (and zero) box, or a dense stack's four bf16
//   boxes. Consumer warps wait on the stage's full barrier and release it
//   on its empty one. Nothing of the weights passes through registers on
//   its way in. setmaxnreg leaves the producer warpgroup 40 registers a
//   thread and gives the consumers 232: at n = 128 their two tiles hold 128
//   f32 accumulators a thread.
// - The dequantization overlaps the product. A k step is one wgmma group
//   (one wgmma a tile); the A fragments are double buffered: step k's group
//   is issued, step k + 1's codes are read from shared memory, and after
//   wgmma.wait_group 1 (step k - 1, which read the other buffer, is done)
//   they are dequantized into it while step k runs. wgmma.fence precedes
//   every group, which reads freshly written A registers.
// - Why 256 columns (tools/bench_gemm.py's probe builds on the H100, see
//   PERF.md): at 128 columns a block each 64-K chunk moved 16 KB of x for
//   4.6 KB of weights, the loads alone took over half the kernel's time and
//   the loads plus the wgmma on raw codes nearly all of it, so the product
//   waited on x's bytes, not on the dequantization. Twice the columns halve
//   x a weight. Tried and not kept (slower or no faster): multicasting x
//   by TMA to a cluster of 2 or 4 blocks, 6 stages, a whole chunk of
//   dequantization ahead, and 2 blocks an SM (ptxas serialized the wgmma
//   at 112 registers).
// - K splits across blocks (gridDim.y) in one launch, as in
//   dequant_smallm.cuh: each split writes its f32 partials, the last block
//   of a strip (an atomic ticket) adds them in split order, writes bf16 y
//   and resets the ticket. Results repeat bit for bit, and B6 at B2's split
//   runs B2's reduction. A split costs the partials' round trip, so the
//   wrapper splits only to fill one wave, at most 5 ways. The epilogue stages each tile's
//   accumulators in shared memory, so y leaves in 16-byte rows (8-byte
//   where N % 8 != 0).
//
// Loads. x always takes TMA (a 2-D map over [rows, Kp], 64 x 64 boxes; rows
// past M and K past Kp arrive as zeros). The weight planes take TMA (3-D
// maps over [E, rows, N], so no box leaves its expert) when every row and
// every plane address and expert stride is 16-byte aligned (N % 16 == 0 for
// the codes, N % 8 == 0 for bf16 rows: the Llama and Mixtral widths);
// otherwise the producer warp copies them with 4-byte cp.async into the
// same swizzled layout, zero-filling past N, in the same kernel.
// ops/cuda/dequant_matmul.py::plane_loads and
// ops/cuda/moe_dispatch.py::dense_loads make the same choice.
//
// Numerics are the small-M body's STD policy: f32 code times f32 block
// scale (plus zero for asym, the LUT value for nf4 / fp4 / nf3), rounded
// once to bf16, x in bf16, products summed in f32; a dense stack's bf16
// weights are multiplied as they are.
//
// A wait on a barrier phase that never completes traps after ~2 s of
// clock instead of hanging the card.
#pragma once

#include <string.h>

#include "dequant_smallm.cuh"
#include "tma.cuh"

namespace dqwg {

constexpr int kChunk = 64;               // K per stage
constexpr int kTiles = 2;                // 64-column A tiles a warpgroup
constexpr int kTileCols = 128;           // columns of one tile set (2 WGs)
constexpr int kCols = kTiles * kTileCols;    // output columns a block
constexpr int kConsumers = 256;          // 2 warpgroups
// + the producer warpgroup, of which one warp works: setmaxnreg moves
// registers between whole warpgroups
constexpr int kThreads = kConsumers + 128;
// registers a thread: ptxas gives the 384-thread block 168 (its launch
// bound); the producer warpgroup hands 128 of each thread's to the
// consumers, 128 * 40 + 256 * 232 = 384 * 168
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <=
                  kThreads * 168, "register pool");
constexpr int kStages = 4;               // chunks in flight
constexpr int kXBox = 64;                // token rows of one x box
constexpr int kStg = kTileCols + 4;      // f32 staging row stride

// probe builds (tools/bench_gemm.py; y is then not the product): 1 runs
// the ring, the barriers and the code reads but neither dequantizes nor
// multiplies; 2 also multiplies, with the raw code words as A
#ifndef BIGDL_WGMMA_PROBE
#define BIGDL_WGMMA_PROBE 0
#endif
constexpr bool kNoDequant = BIGDL_WGMMA_PROBE != 0;
constexpr bool kLoadsOnly = BIGDL_WGMMA_PROBE == 1;
// a dense stack's weight box: 64 K rows of 64 bf16 columns (128 bytes)
constexpr int kDenseBox = kChunk * 128;

// a compile-time int, for the unrolled k steps
template <int V>
struct Int {
    static constexpr int value = V;
};

// packed rows of one chunk's code box (4-bit: 32, int8: 64)
__host__ __device__ constexpr int code_rows(int kind) {
    return row_units(kind) ? kChunk : kChunk / 2;
}

// scale rows of one chunk (64 / block)
__host__ __device__ constexpr int scale_rows(int kind) {
    return kChunk / (kind == KIND_CODEBOOK4 ? 64 : 32);
}

// One stage of the ring, for NT tokens at most: x box(es), the codes' two
// 128-column boxes (a dense stack: two 64-column bf16 boxes a tile set),
// scales, zeros; each 1024-byte aligned where a 128-byte swizzle lands.
template <int NT, int KIND>
struct Ring {
    static constexpr bool kDense = KIND == KIND_BF16;
    static constexpr int x_bytes = NT * 128;
    static constexpr int code_off = x_bytes;
    static constexpr int code_box = kDense ? 2 * kDenseBox
                                           : code_rows(KIND) * kTileCols;
    static constexpr int code_bytes = kTiles * code_box;
    static constexpr int scale_off = code_off + code_bytes;
    static constexpr int plane_bytes = kDense ? 0
                                              : scale_rows(KIND) * kCols * 2;
    static constexpr int zero_off = scale_off + (kDense ? 0 : 1024);
    static constexpr int stage =
        (zero_off + (kDense ? 0 : 1024) + 1023) / 1024 * 1024;
    static constexpr int bytes = kStages * stage;
    // + slack to align the dynamic buffer to 1024 bytes
    static constexpr int smem = bytes + 1024;
    static_assert(NT * kStg * 4 <= bytes, "the epilogue stages in the ring");
};

struct Args {
    const float* lut;          // [16] (codebook)
    float* ws;                 // [split, rows, N] f32 (split > 1)
    unsigned* tickets;         // [tiles * strips] (split > 1)
    uint16_t* y;               // [rows, N] bf16
    const uint8_t* data;       // the planes (the cp.async loads)
    const uint16_t* scale;
    const uint16_t* zero;
    const int* tile_expert;    // B6: [tiles]
    const int* tile_rows;      // B6: [tiles]
    long long data_es;         // B6: expert strides (bytes / elements)
    long long scale_es;
    int M;                     // rows of x and y (B6: Np)
    int Kp, N, cps, num_experts, planes_tma;
};

// arrive once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
        :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1),
           "r"(c2)
        : "memory");
}

// 4-byte cp.async; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void bar_consumers() {
    asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keep registers a pending wgmma reads (or writes) alive and in place up
// to this point
template <int P, int N>
__device__ __forceinline__ void keep(float (&r)[P][N]) {
#pragma unroll
    for (int i = 0; i < P * N; ++i) {
        asm volatile("" : "+f"(r[i / N][i % N]) :: "memory");
    }
}

template <int P>
__device__ __forceinline__ void keep(uint32_t (&r)[P][4]) {
#pragma unroll
    for (int i = 0; i < P * 4; ++i) {
        asm volatile("" : "+r"(r[i / 4][i % 4]) :: "memory");
    }
}

// Shared-memory descriptor of a K-major bf16 tile with 128-byte rows and
// the 128-byte swizzle, as TMA lays it: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// acc += A (registers, 64 x 16) . B (shared memory, 16 x 64, K-major)
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
}

// acc += A (registers, 64 x 16) . B (shared memory, 16 x 128, K-major)
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                           uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
}

template <int NT>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a,
                                      uint64_t desc) {
    if constexpr (NT == 128) {
        wgmma_n128(d, a, desc);
    } else {
        wgmma_n64(d, a, desc);
    }
}

// Shared-memory descriptor of an M-major (transposed) bf16 A tile with
// 128-byte rows of 64 M and the 128-byte swizzle, as TMA lays a dense
// stack's [64 K, 64 column] box: 8-row K groups 1024 bytes apart (the
// stride byte offset); the leading byte offset, the stride between 64-wide
// M atoms, is never reached by a 64-row tile.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)(kDenseBox >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define BIGDL_ACC8(i)                                                       \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
        "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// acc += A (shared memory, 64 x 16, M-major) . B (shared memory, 16 x 64,
// K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 0;\n}\n"
        : BIGDL_ACC8(0), BIGDL_ACC8(8), BIGDL_ACC8(16), BIGDL_ACC8(24)
        : "l"(da), "l"(db), "r"(1));
}

// acc += A (shared memory, 64 x 16, M-major) . B (shared memory, 16 x 128,
// K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 0;\n}\n"
        : BIGDL_ACC8(0), BIGDL_ACC8(8), BIGDL_ACC8(16), BIGDL_ACC8(24),
          BIGDL_ACC8(32), BIGDL_ACC8(40), BIGDL_ACC8(48), BIGDL_ACC8(56)
        : "l"(da), "l"(db), "r"(1));
}

#undef BIGDL_ACC8

template <int NT>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
    if constexpr (NT == 128) {
        wgmma_ss_n128(d, da, db);
    } else {
        wgmma_ss_n64(d, da, db);
    }
}

// The four k steps of a chunk. A unit is 16 packed rows: two steps for
// 4-bit codes (low nibbles, then high; the int4 layout: K rows 0-15, then
// 16-31 of its 32), one for int8.
template <int KIND>
__device__ constexpr int step_unit(int st) {
    return row_units(KIND) ? st : st >> 1;
}

template <int KIND>
__device__ constexpr bool step_hi(int st) {
    return !row_units(KIND) && (st & 1);
}

// K offset of step st within the chunk (the B slice it multiplies)
template <int KIND>
__device__ constexpr int step_k(int st) {
    if (row_units(KIND) || KIND == KIND_I4) return 16 * st;
    constexpr int b = dqmma::kind_block<KIND>();
    constexpr int half = b / 2;
    const int u = st >> 1;
    const int blk = (16 * u) / half;
    return blk * b + (16 * u - blk * half) + ((st & 1) ? half : 0);
}

// scale row (within the chunk) of unit u
template <int KIND>
__device__ constexpr int unit_scale_row(int u) {
    constexpr int b = dqmma::kind_block<KIND>();
    return row_units(KIND) ? (16 * u) / b : (16 * u) / (b / 2);
}


// Read unit u of a stage's codes (the lane's 4 packed rows of its 2
// columns) and its scale (and zero) pair into slot 0 of f, with the lane's
// columns at bytes 0 and 1: dequant_col's columns j = 0 and 1. off[i] is the
// byte offset of packed row unit_row(t, i) in the swizzled code box for
// i = 0, 1; rows i = 2, 3 lie 8 rows (1024 bytes, the same swizzle phase)
// below them. sc is the lane's byte offset in a scale row.
template <int KIND>
__device__ __forceinline__ void load_unit(dqmma::Words<KIND, 1>& f,
                                          const uint8_t* codes,
                                          const uint8_t* scales,
                                          const uint8_t* zeros, int u,
                                          const int (&off)[2], int sc) {
    codes += 16 * u * kTileCols;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f.w[0][i][0] = *reinterpret_cast<const uint16_t*>(
            codes + off[i & 1] + (i >> 1) * 8 * kTileCols);
    }
    const int sr = unit_scale_row<KIND>(u) * kCols * 2 + sc;
    f.s[0][0] = *reinterpret_cast<const uint32_t*>(scales + sr);
    if (KIND == KIND_ASYM4) {
        f.z[0][0] = *reinterpret_cast<const uint32_t*>(zeros + sr);
    }
}

// The A fragment of one k step: rows g and g + 8 are the lane's columns 0
// and 1 (bytes 0 and 1 of f's words), k slots {2t, 2t+1} and {2t+8, 2t+9}.
template <int KIND>
__device__ __forceinline__ void make_a(const dqmma::Words<KIND, 1>& f,
                                       bool hi, const float* lut,
                                       uint32_t (&a)[4]) {
    uint32_t b0[2], b1[2];
    dqmma::dequant_col<KIND, 1, false>(f, 0, hi, lut, 0, 0, b0);
    dqmma::dequant_col<KIND, 1, false>(f, 0, hi, lut, 0, 1, b1);
    a[0] = b0[0];
    a[1] = b1[0];
    a[2] = b0[1];
    a[3] = b1[1];
}

// A consumer warp's K loop over its block's nmine chunks: acc[p] (yT, the
// warp's 16 columns of tile p by NT tokens) += W^T . x^T. RING is the ring's
// token capacity (its stage layout), NT the tokens multiplied. A k step is
// one wgmma group (one wgmma a tile); while it runs, the warp reads the next
// step's codes and, once the group before it is done (wgmma.wait_group 1:
// it read the other fragment buffer), dequantizes them into that buffer.
template <int NT, int RING, int KIND>
__device__ __forceinline__ void mainloop(float (&acc)[kTiles][NT / 2],
                                         uint8_t* ring, uint32_t full,
                                         uint32_t empty, int nmine,
                                         const float* lut,
                                         const int (&off)[2], int sc,
                                         int lane) {
    using R = Ring<RING, KIND>;
    const uint32_t ring_s = smem_u32(ring);
    dqmma::Words<KIND, 1> f[kTiles];
    uint32_t a0[kTiles][4], a1[kTiles][4];
#pragma unroll
    for (int p = 0; p < kTiles; ++p) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[p][i] = 0.f;
    }
    if (kNoDequant) {
#pragma unroll
        for (int i = 0; i < kTiles * 4; ++i) {
            a0[i / 4][i % 4] = a1[i / 4][i % 4] = 0u;
        }
    }
    // unit u of stage s's codes (both tiles) into f
    auto load = [&](int s, int u) {
        const uint8_t* stage = ring + s * R::stage;
#pragma unroll
        for (int p = 0; p < kTiles; ++p) {
            load_unit<KIND>(f[p], stage + R::code_off + p * R::code_box,
                            stage + R::scale_off, stage + R::zero_off, u,
                            off, sc + 2 * kTileCols * p);
        }
    };
    // step st's A fragments (both tiles) from f into a
    auto make = [&](int st, uint32_t (&a)[kTiles][4]) {
#pragma unroll
        for (int p = 0; p < kTiles; ++p) {
            if (kNoDequant) {
                a[p][0] ^= f[p].w[0][0][0] ^ f[p].s[0][0];
                a[p][1] ^= f[p].w[0][1][0];
                a[p][2] ^= f[p].w[0][2][0];
                a[p][3] ^= f[p].w[0][3][0];
            } else {
                make_a<KIND>(f[p], step_hi<KIND>(st), lut, a[p]);
            }
        }
    };
    mbar_wait(full, 0);
    load(0, 0);
    make(0, a0);
    keep(acc);
    for (int c = 0; c < nmine; ++c) {
        const int s = c % kStages;
        const uint32_t xs = ring_s + s * R::stage;
        // one k step; ST a constant, so every buffer index is
        auto step = [&](auto st_c) {
            constexpr int ST = decltype(st_c)::value;
            uint32_t (&cur)[kTiles][4] = (ST & 1) ? a1 : a0;
            uint32_t (&nxt)[kTiles][4] = (ST & 1) ? a0 : a1;
            wg_fence();
#pragma unroll
            for (int p = 0; p < kTiles; ++p) {
                if (kLoadsOnly) {
                    acc[p][ST] += __uint_as_float(cur[p][0] & 1u);
                } else {
                    wgmma<NT>(acc[p], cur[p],
                              desc_sw128(xs + 2 * step_k<KIND>(ST)));
                }
            }
            wg_commit();
            // the next step's stage and unit
            constexpr int STN = (ST + 1) & 3;
            int sn = s;
            bool more = true;
            if (ST == 3) {
                sn = (c + 1) % kStages;
                more = c + 1 < nmine;
                if (more) mbar_wait(full + 8 * sn, ((c + 1) / kStages) & 1);
            }
            if (more && (row_units(KIND) || (STN & 1) == 0)) {
                load(sn, step_unit<KIND>(STN));
            }
            // step ST - 1, the last reader of nxt, is done
            wg_wait<1>();
            keep(nxt);
            // chunk c - 1's last step is done: its stage is free
            if (ST == 0 && c > 0 && lane == 0) {
                mbar_arrive(empty + 8 * ((c - 1) % kStages));
            }
            if (more) make(STN, nxt);
        };
        step(Int<0>{});
        step(Int<1>{});
        step(Int<2>{});
        step(Int<3>{});
    }
    wg_wait<0>();
    keep(acc);
}

// A dense stack's K loop: acc[p] (yT, the warpgroup's 64 columns of tile
// set p by NT tokens) += W^T . x^T, A from the stage's bf16 boxes (the
// warpgroup's box of tile set p: 2p + its index). A chunk's four k steps of both tiles are one wgmma group, and once chunk
// c's group is issued the group of chunk c - 1 is waited for (wait_group 1)
// and its stage released.
template <int NT, int RING>
__device__ __forceinline__ void mainloop_dense(float (&acc)[kTiles][NT / 2],
                                               uint8_t* ring, uint32_t full,
                                               uint32_t empty, int nmine,
                                               int ctid) {
    using R = Ring<RING, KIND_BF16>;
    const uint32_t ring_s = smem_u32(ring);
    const int lane = ctid & 31;
    const int wg = ctid >> 7;
#pragma unroll
    for (int p = 0; p < kTiles; ++p) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[p][i] = 0.f;
    }
    auto box = [&](uint32_t stage, int p) {
        return stage + R::code_off + (2 * p + wg) * kDenseBox;
    };
    for (int c = 0; c < nmine; ++c) {
        const int s = c % kStages;
        const uint32_t stage = ring_s + s * R::stage;
        mbar_wait(full + 8 * s, (c / kStages) & 1);
        // rows that arrived by cp.async (the generic proxy) before
        // wgmma (the async proxy) reads them
        fence_proxy_async();
        wg_fence();
#pragma unroll
        for (int k = 0; k < kChunk / 16; ++k) {
#pragma unroll
            for (int p = 0; p < kTiles; ++p) {
                wgmma_ss<NT>(acc[p], desc_mn_sw128(box(stage, p) +
                                                   k * 16 * 128),
                             desc_sw128(stage + 32 * k));
            }
        }
        wg_commit();
        // chunk c - 1's group is done: its stage is free
        wg_wait<1>();
        if (c > 0 && lane == 0) {
            mbar_arrive(empty + 8 * ((c - 1) % kStages));
        }
    }
    wg_wait<0>();
    keep(acc);
}

// The producer warp: chunk i of the block's range into stage i % kStages
// once its consumers have released it. x by TMA (nbox boxes of 64 token
// rows from row xrow); the planes by TMA at expert e, or (planes_tma 0) by
// 4-byte cp.async into the same layout.
template <int RING, int KIND>
__device__ __forceinline__ void produce(
    const CUtensorMap* xmap, const CUtensorMap* cmap, const CUtensorMap* smap,
    const CUtensorMap* zmap, const Args& a, uint8_t* ring, uint32_t full,
    uint32_t empty, int c_begin, int nmine, int nbox, int xrow, int col0,
    int e, int lane) {
    using R = Ring<RING, KIND>;
    constexpr int kBlock = dqmma::kind_block<KIND>();
    constexpr bool kAsym = KIND == KIND_ASYM4;
    const uint32_t ring_s = smem_u32(ring);
    const uint32_t tx_x = nbox * kXBox * kChunk * 2;
    const uint32_t tx_planes =
        R::code_bytes + R::plane_bytes * (kAsym ? 2 : 1);
    const bool tma = a.planes_tma != 0;
    // rows of one expert's planes, and the expert's planes
    const int rows_c = row_units(KIND) ? a.Kp : a.Kp / 2;
    const int rows_s = a.Kp / kBlock;
    const uint8_t* data = a.data + (size_t)e * a.data_es;
    const uint16_t* scale = a.scale + (size_t)e * a.scale_es;
    const uint16_t* zero = kAsym ? a.zero + (size_t)e * a.scale_es : nullptr;
    for (int i = 0; i < nmine; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) + 1) & 1);
        const int k0 = (c_begin + i) * kChunk;
        const int crow = row_units(KIND) ? k0 : k0 / 2;
        const int srow = k0 / kBlock;
        const uint32_t st = ring_s + s * R::stage;
        const uint32_t bar = full + 8 * s;
        if (lane == 0) {
            mbar_expect_tx(bar, tma ? tx_x + tx_planes : tx_x);
            for (int b = 0; b < nbox; ++b) {
                tma_2d(st + b * kXBox * 128, xmap, bar, k0, xrow + kXBox * b);
            }
            if (tma && KIND == KIND_BF16) {
                // four [64 K, 64 column] boxes of the expert's bf16 rows
#pragma unroll
                for (int b = 0; b < 2 * kTiles; ++b) {
                    tma_3d(st + R::code_off + b * kDenseBox, cmap, bar,
                           col0 + 64 * b, crow, e);
                }
            } else if (tma) {
#pragma unroll
                for (int p = 0; p < kTiles; ++p) {
                    tma_3d(st + R::code_off + p * R::code_box, cmap, bar,
                           col0 + kTileCols * p, crow, e);
                }
                tma_3d(st + R::scale_off, smap, bar, col0, srow, e);
                if (kAsym) tma_3d(st + R::zero_off, zmap, bar, col0, srow, e);
            }
        }
        if (tma) {
            __syncwarp();
            mbar_arrive(bar);
            continue;
        }
        if constexpr (KIND == KIND_BF16) {
            // 128 words a row of 256 bf16 columns, each in its box's
            // swizzled 16-byte chunk
            for (int w = lane; w < kChunk * 128; w += 32) {
                const int r = w >> 7;
                const int c = (w & 127) * 2;
                const int cb = 2 * (c & 63);
                const bool ok = crow + r < rows_c && col0 + c < a.N;
                const uint32_t dst = st + R::code_off + (c >> 6) * kDenseBox +
                                     r * 128 +
                                     ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
                cp_async4(dst, ok ? data + ((size_t)(crow + r) * a.N + col0 +
                                            c) * 2
                                  : a.data, ok ? 4 : 0);
            }
            mbar_arrive_cp_async(bar);
            continue;
        }
        // codes: 64 words a row of 256 columns, each in its box's swizzled
        // 16-byte chunk
        for (int w = lane; w < code_rows(KIND) * 64; w += 32) {
            const int r = w >> 6;
            const int c = (w & 63) * 4;
            const int cc = c & (kTileCols - 1);
            const bool ok = crow + r < rows_c && col0 + c < a.N;
            const uint32_t dst = st + R::code_off + (c / kTileCols) *
                                 R::code_box + r * 128 +
                                 ((((cc >> 4) ^ (r & 7)) << 4) | (cc & 15));
            cp_async4(dst, ok ? data + (size_t)(crow + r) * a.N + col0 + c
                              : a.data, ok ? 4 : 0);
        }
        // scales (zeros): 128 words a row of 256 bf16
        for (int w = lane; w < scale_rows(KIND) * 128; w += 32) {
            const int r = w >> 7;
            const int c = (w & 127) * 2;
            const bool ok = srow + r < rows_s && col0 + c < a.N;
            const size_t src = (size_t)(srow + r) * a.N + col0 + c;
            const uint32_t dst = r * 512 + c * 2;
            cp_async4(st + R::scale_off + dst, ok ? scale + src : a.scale,
                      ok ? 4 : 0);
            if (kAsym) {
                cp_async4(st + R::zero_off + dst, ok ? zero + src : a.zero,
                          ok ? 4 : 0);
            }
        }
        mbar_arrive_cp_async(bar);
    }
    if (!tma) asm volatile("cp.async.wait_all;" ::: "memory");
}

// 8 (or 4) f32 of the staging buffer -> bf16 at y (16- or 8-byte stores)
__device__ __forceinline__ void store_row_piece(uint16_t* y, const float* v,
                                                bool wide, bool second) {
    if (wide) {
        uint4 o;
        o.x = pack_bf16x2(v[0], v[1]);
        o.y = pack_bf16x2(v[2], v[3]);
        o.z = pack_bf16x2(v[4], v[5]);
        o.w = pack_bf16x2(v[6], v[7]);
        *reinterpret_cast<uint4*>(y) = o;
    } else {
        *reinterpret_cast<uint2*>(y) =
            make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
        if (second) {
            *reinterpret_cast<uint2*>(y + 4) =
                make_uint2(pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
        }
    }
}

// The consumers' epilogue: each tile's acc through the staging buffer (the
// ring) to bf16 y, or with a K split to the workspace, the last block of
// the strip summing the splits in order. rows: the tile's rows from acc
// (B2: M; B6: NT), out: its rows in all (B6: 128, zeros past rows), from
// row0 of y and of a workspace of ws_rows rows; tix: the strip's ticket.
// A lane's accumulator rows g and g + 8 are its warp's columns 2g and
// 2g + 1 (the dequantized fragment's order), or g and g + 8 (DENSE: the
// rows of the transposed box as they are).
template <int NT, bool DENSE>
__device__ __forceinline__ void epilogue(const float (&acc)[kTiles][NT / 2],
                                         float* stg, const Args& a,
                                         int* is_last, int rows, int out,
                                         int row0, int ws_rows, int col0,
                                         int tix, int ctid) {
    const int lane = ctid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // the lane's columns of a tile: 2g and 2g + 1 of its warp's 16 (DENSE:
    // g and g + 8)
    const int colw = 16 * (ctid >> 5) + (DENSE ? g : 2 * g);
    const int N = a.N;
    const int split = gridDim.y;
    const bool wide = N % 8 == 0;
#pragma unroll
    for (int p = 0; p < kTiles; ++p) {
        bar_consumers();                   // the ring / staging is free
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
            const int tok = 8 * j + 2 * t;
            if constexpr (DENSE) {
                stg[tok * kStg + colw] = acc[p][4 * j];
                stg[tok * kStg + colw + 8] = acc[p][4 * j + 2];
                stg[(tok + 1) * kStg + colw] = acc[p][4 * j + 1];
                stg[(tok + 1) * kStg + colw + 8] = acc[p][4 * j + 3];
            } else {
                *reinterpret_cast<float2*>(stg + tok * kStg + colw) =
                    make_float2(acc[p][4 * j], acc[p][4 * j + 2]);
                *reinterpret_cast<float2*>(stg + (tok + 1) * kStg + colw) =
                    make_float2(acc[p][4 * j + 1], acc[p][4 * j + 3]);
            }
        }
        bar_consumers();
        const int cp = col0 + kTileCols * p;
        if (split == 1) {
            for (int i = ctid; i < rows * (kTileCols / 8); i += kConsumers) {
                const int r = i / (kTileCols / 8);
                const int c = 8 * (i % (kTileCols / 8));
                if (cp + c >= N) continue;
                store_row_piece(a.y + ((size_t)row0 + r) * N + cp + c,
                                stg + r * kStg + c, wide, cp + c + 4 < N);
            }
        } else {
            for (int i = ctid; i < rows * (kTileCols / 4); i += kConsumers) {
                const int r = i / (kTileCols / 4);
                const int c = 4 * (i % (kTileCols / 4));
                if (cp + c >= N) continue;
                __stcg(reinterpret_cast<float4*>(
                           a.ws + ((size_t)blockIdx.y * ws_rows + row0 + r) *
                                      N + cp + c),
                       *reinterpret_cast<const float4*>(stg + r * kStg + c));
            }
        }
    }
    if (split > 1) {
        // the last split of the strip to arrive adds them all
        __threadfence();
        bar_consumers();
        if (ctid == 0) {
            *is_last = atomicAdd(&a.tickets[tix], 1u) == (unsigned)split - 1;
        }
        bar_consumers();
        if (!*is_last) return;
        __threadfence();
        for (int i = ctid; i < rows * (kCols / 4); i += kConsumers) {
            const int r = i / (kCols / 4);
            const int c = 4 * (i % (kCols / 4));
            if (col0 + c >= N) continue;
            const float* src = a.ws + ((size_t)row0 + r) * N + col0 + c;
            const size_t sstride = (size_t)ws_rows * N;
            float4 v = __ldcg(reinterpret_cast<const float4*>(src));
            // in split order; four loads issued ahead of their adds
            int s = 1;
            for (; s + 3 < split; s += 4) {
                float4 o[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    o[q] = __ldcg(reinterpret_cast<const float4*>(
                        src + (s + q) * sstride));
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    v.x += o[q].x;
                    v.y += o[q].y;
                    v.z += o[q].z;
                    v.w += o[q].w;
                }
            }
            for (; s < split; ++s) {
                const float4 o = __ldcg(reinterpret_cast<const float4*>(
                    src + s * sstride));
                v.x += o.x;
                v.y += o.y;
                v.z += o.z;
                v.w += o.w;
            }
            smallm::store_bf16x4(a.y + ((size_t)row0 + r) * N + col0 + c,
                                 v.x, v.y, v.z, v.w);
        }
        if (ctid == 0) a.tickets[tix] = 0u;
    }
    // B6: the tile's rows past the multiplied ones are zeros
    for (int i = ctid; i < (out - rows) * (kCols / 4); i += kConsumers) {
        const int r = rows + i / (kCols / 4);
        const int c = 4 * (i % (kCols / 4));
        if (col0 + c < N) {
            *reinterpret_cast<uint2*>(a.y + ((size_t)row0 + r) * N + col0 +
                                      c) = make_uint2(0u, 0u);
        }
    }
}

// A consumer thread's K loop and epilogue at NT tokens.
template <int NT, int RING, int KIND>
__device__ __forceinline__ void consume(uint8_t* ring, uint32_t full,
                                        uint32_t empty, int nmine,
                                        const float* lut, const Args& a,
                                        int* is_last, int rows, int out,
                                        int row0, int ws_rows, int col0,
                                        int tix, int ctid) {
    float acc[kTiles][NT / 2];
    if constexpr (KIND == KIND_BF16) {
        mainloop_dense<NT, RING>(acc, ring, full, empty, nmine, ctid);
    } else {
        const int lane = ctid & 31;
        const int g = lane >> 2;
        const int t = lane & 3;
        const int q = ctid >> 5;           // the warp's 16-byte chunk
        // rows unit_row(t, i) for i = 2, 3 are those of i = 0, 1 plus 8 in
        // both row maps (2t + (i & 1) + 8 (i >> 1); the int4 layout's t + 4i)
        int off[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = dqmma::unit_row<KIND, false>(t, i);
            off[i] = r * 128 + (((q ^ (r & 7)) << 4) | (2 * g));
        }
        const int sc = 2 * (16 * q + 2 * g);
        mainloop<NT, RING, KIND>(acc, ring, full, empty, nmine, lut, off, sc,
                                 lane);
    }
    epilogue<NT, KIND == KIND_BF16>(acc, reinterpret_cast<float*>(ring), a,
                                    is_last, rows, out, row0, ws_rows, col0,
                                    tix, ctid);
}

// The kernel body. B2 (RAGGED false; NT 64 or 128 tokens, M <= NT) and B6's
// tiles (RAGGED: block z takes 128-row tile z of x against expert
// tile_expert[z], at 64 or 128 tokens from tile_rows[z]). Grid: (strips of
// 128 columns, K splits, tiles). The maps are the kernel's grid constants.
template <int NT, int KIND, bool RAGGED>
__device__ __forceinline__ void wgmma_body(const CUtensorMap* xmap,
                                           const CUtensorMap* cmap,
                                           const CUtensorMap* smap,
                                           const CUtensorMap* zmap,
                                           const Args& a) {
    static_assert(!RAGGED || NT == 128, "B6 tiles are 128 rows");
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t bars[2 * kStages];
    __shared__ float lut[16];
    __shared__ int is_last;
    uint8_t* ring =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const int tid = threadIdx.x;
    const int col0 = blockIdx.x * kCols;

    // rows multiplied (live), from acc (rows) and in all (out), from row0
    int e = 0, live = a.M, rows = a.M, out = a.M, row0 = 0, tix = blockIdx.x;
    if (RAGGED) {
        const int tile = blockIdx.z;
        // an id outside [0, E) breaks the caller's contract; clamp it so no
        // read leaves the stack
        e = min(max(a.tile_expert[tile], 0), a.num_experts - 1);
        live = min(max(a.tile_rows[tile], 0), 128);
        rows = live > 64 ? 128 : 64;
        out = 128;
        row0 = tile * 128;
        tix += tile * gridDim.x;
        if (live == 0) {
            // no real row: one split writes the strip's zeros
            if (blockIdx.y == 0) {
                for (int i = tid; i < 128 * (kCols / 4); i += kThreads) {
                    const int r = i / (kCols / 4);
                    const int c = 4 * (i % (kCols / 4));
                    if (col0 + c < a.N) {
                        *reinterpret_cast<uint2*>(
                            a.y + ((size_t)row0 + r) * a.N + col0 + c) =
                            make_uint2(0u, 0u);
                    }
                }
            }
            return;
        }
    }
    const int nchunks = (a.Kp + kChunk - 1) / kChunk;
    const int c_begin = blockIdx.y * a.cps;
    const int nmine = min(nchunks, c_begin + a.cps) - c_begin;
    const uint32_t full = smem_u32(&bars[0]);
    const uint32_t empty = smem_u32(&bars[kStages]);
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 32);             // the producer's lanes
            mbar_init(empty + 8 * s, kConsumers / 32);   // consumer warps
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (KIND == KIND_CODEBOOK4 && tid < 16) lut[tid] = a.lut[tid];
    __syncthreads();

    if (tid >= kConsumers) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(kProducerRegs));
        if (tid < kConsumers + 32) {
            produce<NT, KIND>(xmap, cmap, smap, zmap, a, ring, full, empty,
                              c_begin, nmine, (RAGGED ? rows : NT) / kXBox,
                              row0, col0, e, tid & 31);
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                 :: "n"(kConsumerRegs));
    if constexpr (RAGGED) {
        if (rows == 128) {
            consume<128, 128, KIND>(ring, full, empty, nmine, lut, a,
                                    &is_last, 128, out, row0, a.M, col0, tix,
                                    tid);
        } else {
            consume<64, 128, KIND>(ring, full, empty, nmine, lut, a,
                                   &is_last, 64, out, row0, a.M, col0, tix,
                                   tid);
        }
    } else {
        consume<NT, NT, KIND>(ring, full, empty, nmine, lut, a, &is_last,
                              rows, out, row0, a.M, col0, tix, tid);
    }
}

// B2: one weight, M <= NT rows.
template <int NT, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap cmap,
                  const __grid_constant__ CUtensorMap smap,
                  const __grid_constant__ CUtensorMap zmap, const Args a) {
    wgmma_body<NT, KIND, false>(&xmap, &cmap, &smap, &zmap, a);
}

// B6: one 128-row token tile a grid z, its expert's planes.
template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_ragged_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __grid_constant__ CUtensorMap zmap, const Args a) {
    wgmma_body<128, KIND, true>(&xmap, &cmap, &smap, &zmap, a);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, launches, occupancy.

struct Maps {
    CUtensorMap x, c, s, z;
};

// The launch's tensor maps: x [rows, Kp] bf16 in 64 x 64 boxes, 128-byte
// swizzle; with planes_tma the code plane [E, rows, N] in [1, 32 | 64, 128]
// boxes (128-byte swizzle) and the scale (zero) planes [E, Kp / block, N]
// in [1, 64 / block, 128] boxes, or a dense stack's [E, Kp, N] bf16 in
// [1, 64, 64] boxes (128-byte swizzle). Returns 0 or an error code.
inline int encode_maps(Maps& m, const void* x, int x_rows, int Kp,
                       const void* data, const void* scale, const void* zero,
                       int N, int kind, int E, long long data_es,
                       long long scale_es, bool planes_tma) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return kNoEncoder;
    memset(&m, 0, sizeof(m));
    const cuuint32_t ones[3] = {1, 1, 1};
    const cuuint64_t xd[2] = {(cuuint64_t)Kp, (cuuint64_t)x_rows};
    const cuuint64_t xs[1] = {(cuuint64_t)Kp * 2};
    const cuuint32_t xb[2] = {kChunk, kXBox};
    CUresult r = enc(&m.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     const_cast<void*>(x), xd, xs, xb, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
    if (!planes_tma) return 0;
    if (kind == KIND_BF16) {
        // a dense stack [E, Kp, N] bf16 in [1, 64, 64] boxes
        const cuuint64_t dd[3] = {(cuuint64_t)N, (cuuint64_t)Kp,
                                  (cuuint64_t)E};
        const cuuint64_t ds[2] = {(cuuint64_t)N * 2, (cuuint64_t)data_es};
        const cuuint32_t db[3] = {64, kChunk, 1};
        r = enc(&m.c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(data), dd, ds, db, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        return r != CUDA_SUCCESS ? kEncodeError + (int)r : 0;
    }
    const int block = kind == KIND_CODEBOOK4 ? 64 : 32;
    const cuuint64_t rows_c = row_units(kind) ? Kp : Kp / 2;
    const cuuint64_t cd[3] = {(cuuint64_t)N, rows_c, (cuuint64_t)E};
    const cuuint64_t cs[2] = {(cuuint64_t)N, (cuuint64_t)data_es};
    const cuuint32_t cb[3] = {kTileCols, (cuuint32_t)code_rows(kind), 1};
    r = enc(&m.c, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(data),
            cd, cs, cb, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
    const cuuint64_t sd[3] = {(cuuint64_t)N, (cuuint64_t)(Kp / block),
                              (cuuint64_t)E};
    const cuuint64_t ss[2] = {(cuuint64_t)N * 2, (cuuint64_t)scale_es * 2};
    const cuuint32_t sb[3] = {kCols, (cuuint32_t)scale_rows(kind), 1};
    for (int p = 0; p < (kind == KIND_ASYM4 ? 2 : 1); ++p) {
        r = enc(p ? &m.z : &m.s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p ? zero : scale), sd, ss, sb, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
    }
    return 0;
}

// The planes may take TMA: N % 16 == 0 and 16-byte aligned addresses and
// expert strides (what plane_loads in ops/cuda/dequant_matmul.py asks).
inline bool planes_tma_ok(int N, const void* data, const void* scale,
                          const void* zero, long long data_es,
                          long long scale_es) {
    auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
    return N % 16 == 0 && al(data) && al(scale) &&
           (zero == nullptr || al(zero)) && data_es % 16 == 0 &&
           (scale_es * 2) % 16 == 0;
}

// A dense stack may take TMA: 16-byte aligned rows (N % 8 == 0), address
// and expert stride (what dense_loads in ops/cuda/moe_dispatch.py asks).
inline bool dense_tma_ok(int N, const void* data, long long data_es) {
    return N % 8 == 0 && ((uintptr_t)data & 15) == 0 && data_es % 16 == 0;
}

// The kernel of a variant, with its dynamic shared memory allowed past
// 48 KB once (0, or the cudaError_t of the attribute call).
template <int NT, int KIND, bool RAGGED>
int prepare(const void** fn) {
    if constexpr (RAGGED) {
        *fn = (const void*)wgmma_ragged_kernel<KIND>;
    } else {
        *fn = (const void*)wgmma_gemm_kernel<NT, KIND>;
    }
    static const int err = (int)cudaFuncSetAttribute(
        *fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ring<NT, KIND>::smem);
    return err;
}

template <int NT, int KIND, bool RAGGED>
int launch_kind(const Maps& m, const Args& a, dim3 grid, cudaStream_t st) {
    const void* fn;
    const int err = prepare<NT, KIND, RAGGED>(&fn);
    if (err) return err;
    if constexpr (RAGGED) {
        wgmma_ragged_kernel<KIND>
            <<<grid, kThreads, Ring<NT, KIND>::smem, st>>>(m.x, m.c, m.s,
                                                            m.z, a);
    } else {
        wgmma_gemm_kernel<NT, KIND>
            <<<grid, kThreads, Ring<NT, KIND>::smem, st>>>(m.x, m.c, m.s,
                                                            m.z, a);
    }
    return (int)cudaGetLastError();
}

template <int NT, int KIND, bool RAGGED>
int occupancy_kind() {
    const void* fn;
    if (prepare<NT, KIND, RAGGED>(&fn)) return 0;
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fn, kThreads, Ring<NT, KIND>::smem);
    return e == cudaSuccess ? n : 0;
}

// F<NT, K, RAGGED>(args...) for weight kind `kind`: the canonical
// quantized kinds, (not RAGGED) the int4 layout and (RAGGED) a dense bf16
// stack. Returns `err` for any other kind.
#define BIGDL_WG_KINDS(F, NT, RAGGED, err, ...)                             \
    switch (kind) {                                                         \
        case KIND_SYM4: return F<NT, KIND_SYM4, RAGGED>(__VA_ARGS__);       \
        case KIND_ASYM4: return F<NT, KIND_ASYM4, RAGGED>(__VA_ARGS__);     \
        case KIND_CODEBOOK4:                                                \
            return F<NT, KIND_CODEBOOK4, RAGGED>(__VA_ARGS__);              \
        case KIND_SYM8: return F<NT, KIND_SYM8, RAGGED>(__VA_ARGS__);       \
        case KIND_I4:                                                       \
            if constexpr (!RAGGED) {                                        \
                return F<NT, KIND_I4, false>(__VA_ARGS__);                  \
            }                                                               \
            return err;                                                     \
        case KIND_BF16:                                                     \
            if constexpr (RAGGED) {                                         \
                return F<NT, KIND_BF16, true>(__VA_ARGS__);                 \
            }                                                               \
            return err;                                                     \
        default: return err;                                                \
    }

// One launch (B2: x_rows = M; B6: x_rows = Np, tiles Np / 128, the expert
// stack's E and strides). Returns 0 or an error code.
template <bool RAGGED>
int launch(int kind, const void* x, const void* data, const void* scale,
           const void* zero, const Args& a, int x_rows, int tiles, int E,
           int split, cudaStream_t st) {
    Maps m;
    const int err = encode_maps(m, x, x_rows, a.Kp, data, scale, zero, a.N,
                                kind, E, a.data_es, a.scale_es,
                                a.planes_tma != 0);
    if (err) return err;
    const dim3 grid((a.N + kCols - 1) / kCols, split, tiles);
    if (RAGGED || a.M > 64) {
        BIGDL_WG_KINDS(launch_kind, 128, RAGGED, (int)cudaErrorInvalidValue,
                       m, a, grid, st)
    }
    if constexpr (!RAGGED) {
        BIGDL_WG_KINDS(launch_kind, 64, false, (int)cudaErrorInvalidValue, m,
                       a, grid, st)
    }
    return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the variant (0 on error).
template <int NT, bool RAGGED>
int occupancy_nt(int kind) {
    switch (kind) {
        case KIND_SYM4: return occupancy_kind<NT, KIND_SYM4, RAGGED>();
        case KIND_ASYM4: return occupancy_kind<NT, KIND_ASYM4, RAGGED>();
        case KIND_CODEBOOK4:
            return occupancy_kind<NT, KIND_CODEBOOK4, RAGGED>();
        case KIND_SYM8: return occupancy_kind<NT, KIND_SYM8, RAGGED>();
        case KIND_I4:
            if constexpr (!RAGGED) return occupancy_kind<NT, KIND_I4, false>();
            return 0;
        case KIND_BF16:
            if constexpr (RAGGED) return occupancy_kind<NT, KIND_BF16, true>();
            return 0;
        default: return 0;
    }
}

template <bool RAGGED>
int occupancy(int kind, int M) {
    if constexpr (RAGGED) {
        return occupancy_nt<128, true>(kind);
    } else {
        return M > 64 ? occupancy_nt<128, false>(kind)
                      : occupancy_nt<64, false>(kind);
    }
}

// The shape rules of a launch (see the wrappers in
// bigdl_tpu_torch/ops/cuda/dequant_matmul.py).
inline bool args_ok(const void* x, int M, int Kp, int N, int block, int kind,
                    int split, int cps, const void* ws,
                    const void* tickets) {
    const int nchunks = (Kp + kChunk - 1) / kChunk;
    return x != nullptr && ((uintptr_t)x & 15) == 0 && M >= 1 && N >= 4 &&
           N % 4 == 0 && Kp >= block && Kp % block == 0 && Kp % 8 == 0 &&
           block == (kind == KIND_CODEBOOK4 ? 64 : 32) && split >= 1 &&
           cps >= 1 && (split - 1) * cps < nchunks &&
           split * cps >= nchunks &&
           (split == 1 || (ws != nullptr && tickets != nullptr));
}

}  // namespace dqwg

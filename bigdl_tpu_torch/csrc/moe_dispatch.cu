// B6: ragged expert matmul over block-quantized or dense bf16 expert
// stacks. For each 128-row tile z of a token buffer x[Np, Kp] (bf16; rows
// sorted by expert and padded so that a tile holds one expert's rows),
// y[128 z : 128 z + 128] = x[128 z : 128 z + 128] . W[tile_expert[z]], with
// W an [E, Kp, N] stack of quantized planes or of bf16 weights.
//
// Replaces bigdl_tpu/ops/pallas/moe_dispatch.py::ragged_expert_matmul (L90,
// its `_ragged_kernel_q` body L66 and `_ragged_kernel_dense` L84): every
// quantized weight is dequantized with B1's arithmetic (f32 code times f32
// scale, plus zero for asym, one rounding to bf16) and multiplied with f32
// accumulation, for every qtype B1 and B2 take; a dense bf16 stack
// (KIND_BF16) feeds its weights to the tensor cores as they are.
//
// Bound on the H100: at a 256-token prefill chunk of Mixtral-8x7B
// (512 token-choices over 8 experts) each tile holding rows streams its
// expert's ~33 MB of packed planes (117 MB in bf16) for 52-128 rows, so the
// bytes bound it; at an 8-slot decode step 16 real rows read up to 8
// experts' weights, so the bytes bound it too.
//
// Design: prefill tiles run B2's Hopper body (dequant_wgmma.cuh: wgmma,
// TMA, an mbarrier ring) with a ragged weight address. Block z reads
// tile_expert[z]'s planes (or bf16 rows) through 3-D tensor maps over the
// [E, rows, N] stacks, where the TPU kernel's BlockSpec index map did the
// same from a scalar-prefetched id; a dense stack's boxes reach wgmma as
// its A operand from shared memory, with no decode. The rows a tile really
// holds (tile_rows, computed on the device from the routing) pick 64 or 128
// tokens for its wgmma, and the trailing tiles past the last expert region
// load nothing and write zeros. K may be split across blocks, summed by the
// strip's last block in a fixed order, as in B2 (B6 at B2's split equals B2
// on every real tile, bit for bit).
//
// Decode tiles take a second entry, on the small-M body of
// dequant_smallm.cuh: at an 8-slot decode step a tile holds at most 16
// real rows (N * k token-choices). The caller passes the static bound on a
// tile's real rows (max_tile_rows, at most 32); the small-M body stages and
// multiplies only a tile's real rows, in n8 tiles of tokens against
// 16-byte-load weight tiles (a dense stack: 8 bf16 weights a load), and
// writes the tile's other rows as zeros.
#include "dequant_wgmma.cuh"

// The shape rules of a dense bf16 stack (block: its K multiple, 16 rows,
// the small-M body's load unit).
static bool dense_args_ok(int Kp, int N, int block, int split, int cps,
                          const void* ws, const void* tickets, int cw) {
    const int nchunks = (Kp + dqmma::kChunk - 1) / dqmma::kChunk;
    return block == 16 && Kp >= block && Kp % block == 0 && N >= 4 &&
           N % (4 * cw) == 0 && split >= 1 && cps >= 1 &&
           (split - 1) * cps < nchunks && split * cps >= nchunks &&
           (split == 1 || (ws != nullptr && tickets != nullptr));
}

// Returns 0 or an error code (a cudaError_t, or kEncodeError +
// CUresult for a tensor map that failed to encode). x is bf16 [Np, Kp] with
// Np a multiple of 128; data/scale/zero are the expert-0 planes of an
// [E, ...] stack whose matrices lie data_es bytes and scale_es scale
// elements apart (kind KIND_BF16: data is the bf16 stack, block 16, scale
// and zero unused); tile_expert and tile_rows are int32 [Np / 128]; ws
// holds split * Np * N floats and tickets at least
// (Np / 128) * ceil(N / 256) zeroed counters when split > 1; y is bf16
// [Np, N]; planes_tma as bigdl_dequant_gemm's (data_es and 2 scale_es must
// then be multiples of 16; a dense stack's rows too, N % 8 == 0).
extern "C" int bigdl_ragged_expert_matmul(
    const void* x, const void* data, const void* scale, const void* zero,
    const void* lut, const void* tile_expert, const void* tile_rows,
    void* ws, void* tickets, void* y, int Np, int Kp, int N, int block,
    int kind, int num_experts, long long data_es, long long scale_es,
    int split, int chunks_per_split, int planes_tma, void* stream) {
    if (Np < 128 || Np % 128 || num_experts < 1 || tile_expert == nullptr ||
        tile_rows == nullptr || data_es < 0 || scale_es < 0 ||
        x == nullptr || ((uintptr_t)x & 15)) {
        return (int)cudaErrorInvalidValue;
    }
    if (kind == KIND_BF16) {
        if (!dense_args_ok(Kp, N, block, split, chunks_per_split, ws,
                           tickets, 1) ||
            (planes_tma && !dqwg::dense_tma_ok(N, data, data_es))) {
            return (int)cudaErrorInvalidValue;
        }
    } else if (kind == KIND_I4 ||
               !dqwg::args_ok(x, Np, Kp, N, block, kind, split,
                              chunks_per_split, ws, tickets) ||
               (planes_tma && !dqwg::planes_tma_ok(N, data, scale, zero,
                                                   data_es, scale_es))) {
        return (int)cudaErrorInvalidValue;
    }
    dqwg::Args a{};
    a.lut = (const float*)lut;
    a.ws = (float*)ws;
    a.tickets = (unsigned*)tickets;
    a.y = (uint16_t*)y;
    a.data = (const uint8_t*)data;
    a.scale = (const uint16_t*)scale;
    a.zero = (const uint16_t*)zero;
    a.tile_expert = (const int*)tile_expert;
    a.tile_rows = (const int*)tile_rows;
    a.data_es = data_es;
    a.scale_es = scale_es;
    a.M = Np;
    a.Kp = Kp;
    a.N = N;
    a.cps = chunks_per_split;
    a.num_experts = num_experts;
    a.planes_tma = planes_tma;
    return dqwg::launch<true>(kind, x, data, scale, zero, a, Np, Np / 128,
                              num_experts, split, (cudaStream_t)stream);
}

// Resident blocks per SM of B6's tiles entry for `kind` (0 on error); the
// wrapper sizes its K split from it.
extern "C" int bigdl_moe_dispatch_blocks_per_sm(int kind) {
    return dqwg::occupancy<true>(kind, 128);
}

// B6 on the small-M body (every tile holds at most max_tile_rows <= 32
// real rows). Arguments as bigdl_ragged_expert_matmul, and: ws holds
// split * (Np / 128) * R * N floats, R = 8, 16 or 32 the staged rows of the
// variant (max_tile_rows rounded up); tickets at least
// (Np / 128) * ceil(N / (32 cw)) zeroed counters when split > 1; cw as
// bigdl_dequant_gemv's at M = max_tile_rows for a quantized stack, 2 (16-
// byte loads, N % 8 == 0) or 1 for a dense one.
extern "C" int bigdl_ragged_expert_matmul_smallm(
    const void* x, const void* data, const void* scale, const void* zero,
    const void* lut, const void* tile_expert, const void* tile_rows,
    void* ws, void* tickets, void* y, int Np, int Kp, int N, int block,
    int kind, int num_experts, long long data_es, long long scale_es,
    int split, int chunks_per_split, int max_tile_rows, int cw,
    void* stream) {
    if (Np < 128 || Np % 128 || num_experts < 1 || tile_expert == nullptr ||
        tile_rows == nullptr || data_es < 0 || scale_es < 0 ||
        kind == KIND_I4 || max_tile_rows < 1 || max_tile_rows > 32 ||
        x == nullptr || ((uintptr_t)x & 15)) {
        return (int)cudaErrorInvalidValue;
    }
    const dqmma::RaggedArgs ra{(const int*)tile_expert,
                               (const int*)tile_rows, data_es, scale_es,
                               num_experts};
    cudaStream_t st = (cudaStream_t)stream;
#define BIGDL_RAGGED_LAUNCH(NT, CW, K)                                     \
    return smallm::launch<NT, CW, K, false, true>(                         \
        x, data, scale, zero, lut, ws, tickets, y, Np, Kp, N,              \
        split, chunks_per_split, Np / 128, ra, st);
    if (kind == KIND_BF16) {
        if (!dense_args_ok(Kp, N, block, split, chunks_per_split, ws,
                           tickets, cw)) {
            return (int)cudaErrorInvalidValue;
        }
#define BIGDL_DENSE_VARIANT(NT, CW) BIGDL_RAGGED_LAUNCH(NT, CW, KIND_BF16)
        BIGDL_SMALLM_DENSE_VARIANTS(BIGDL_DENSE_VARIANT, max_tile_rows, cw,
                                    (int)cudaErrorInvalidValue)
#undef BIGDL_DENSE_VARIANT
    }
    if (!smallm::args_ok(Np, Kp, N, block, kind, split, chunks_per_split, ws,
                         tickets, cw)) {
        return (int)cudaErrorInvalidValue;
    }
#define BIGDL_RAGGED_VARIANT(NT, CW)                                       \
    {                                                                      \
        BIGDL_SMALLM_KINDS(BIGDL_RAGGED_LAUNCH, NT, CW)                    \
        return (int)cudaErrorInvalidValue;                                 \
    }
    BIGDL_SMALLM_VARIANTS(BIGDL_RAGGED_VARIANT, max_tile_rows, cw,
                          (int)cudaErrorInvalidValue)
#undef BIGDL_RAGGED_VARIANT
#undef BIGDL_RAGGED_LAUNCH
}

// Resident blocks per SM of the small-M entry's variant for max_tile_rows,
// kind and cw (0 on error).
extern "C" int bigdl_moe_dispatch_smallm_blocks_per_sm(int max_tile_rows,
                                                       int kind, int cw) {
#define BIGDL_RAGGED_OCC(NT, CW, K) \
    return smallm::blocks_per_sm<NT, CW, K, false, true>();
    if (kind == KIND_BF16) {
#define BIGDL_DENSE_OCC(NT, CW) BIGDL_RAGGED_OCC(NT, CW, KIND_BF16)
        BIGDL_SMALLM_DENSE_VARIANTS(BIGDL_DENSE_OCC, max_tile_rows, cw, 0)
#undef BIGDL_DENSE_OCC
    }
#define BIGDL_RAGGED_VARIANT(NT, CW)                  \
    {                                                 \
        BIGDL_SMALLM_KINDS(BIGDL_RAGGED_OCC, NT, CW)  \
        return 0;                                     \
    }
    BIGDL_SMALLM_VARIANTS(BIGDL_RAGGED_VARIANT, max_tile_rows, cw, 0)
#undef BIGDL_RAGGED_VARIANT
#undef BIGDL_RAGGED_OCC
}

// B6: ragged expert matmul over block-quantized expert stacks. For each
// 128-row tile z of a token buffer x[Np, Kp] (bf16; rows sorted by expert
// and padded so that a tile holds one expert's rows),
// y[128 z : 128 z + 128] = x[128 z : 128 z + 128] . W[tile_expert[z]], with
// W an [E, Kp, N] stack of quantized planes.
//
// Replaces bigdl_tpu/ops/pallas/moe_dispatch.py::ragged_expert_matmul (its
// `_ragged_kernel_q` body): every weight is dequantized with B1's
// arithmetic (f32 code times f32 scale, plus zero for asym, one rounding
// to bf16) and multiplied with f32 accumulation, for every qtype B1 and B2
// take; a dense bf16 stack (`_ragged_kernel_dense`) feeds its weights to
// the tensor cores as they are (kind KIND_BF16, K % 32 == 0).
//
// Bound on the H100: at a 256-token prefill chunk of Mixtral-8x7B
// (512 token-choices over 8 experts) the real rows do ~60 GFLOP per
// projection against ~230 MB of packed planes, near the card's ridge; at
// an 8-slot decode step 16 real rows read up to 8 experts' planes, so the
// bytes bound it.
//
// Design: B2's tensor-core body (dequant_mma.cuh, eight m-tiles, x staged
// by cp.async) with a ragged weight address. Block z adds
// tile_expert[z] times the expert stride to the data, scale and zero
// planes, where the TPU kernel's BlockSpec index map did the same from a
// scalar-prefetched id. The rows a tile really holds (tile_rows, computed
// on the device from the routing) bound the m-tiles it stages and
// multiplies, so a decode tile with 2 real rows does 1/8 of the
// tensor-core work, and the trailing tiles past the last expert region
// load nothing and write zeros. K may be split across blocks, summed in a
// fixed order, as in B2.
#include "dequant_mma.cuh"

// Returns the cudaError_t of the launches (0 on success). x is bf16
// [Np, Kp] with Np a multiple of 128; data/scale/zero are the expert-0
// planes of an [E, ...] stack whose matrices lie data_es bytes and
// scale_es scale elements apart (kind KIND_BF16: data is the bf16 stack,
// block 32, scale and zero unused); tile_expert and tile_rows are int32
// [Np / 128]; ws holds split * Np * N floats when split > 1; y is bf16
// [Np, N].
extern "C" int bigdl_ragged_expert_matmul(
    const void* x, const void* data, const void* scale, const void* zero,
    const void* lut, const void* tile_expert, const void* tile_rows,
    void* ws, void* y, int Np, int Kp, int N, int block, int kind,
    int num_experts, long long data_es, long long scale_es, int split,
    int chunks_per_split, void* stream) {
    if (Np < 128 || Np % 128 || num_experts < 1 || tile_expert == nullptr ||
        tile_rows == nullptr ||
        data_es < 0 || scale_es < 0 ||
        !dqmma::args_ok(Np, Kp, N, block, kind, split, chunks_per_split, ws,
                        1)) {
        return (int)cudaErrorInvalidValue;
    }
    const dqmma::RaggedArgs ra{(const int*)tile_expert,
                               (const int*)tile_rows, data_es, scale_es,
                               num_experts};
    return dqmma::launch<8, 1, 2, true>(kind, x, data, scale, zero, lut, ws,
                                        y, Np, Kp, N, block, split,
                                        chunks_per_split,
                                        (cudaStream_t)stream, ra);
}

// Resident blocks per SM of B6's kernel for `kind` (0 on error); the
// wrapper sizes its K split from it (M and cw are B2's arguments: B6 always
// runs 128-row tiles with cw 1).
extern "C" int bigdl_moe_dispatch_blocks_per_sm(int M, int kind, int cw) {
    if (M != 128 || cw != 1) return 0;
    return dqmma::blocks_per_sm<8, 1, 2, true>(kind);
}

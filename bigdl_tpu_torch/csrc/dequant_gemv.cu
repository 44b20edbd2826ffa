// B1: decode GEMV over block-quantized weights, y[M, N] = x[M, Kp] . W[Kp, N]
// for M <= 32.
//
// Replaces bigdl_tpu/ops/pallas/dequant_matmul.py::_q_gemv_pallas (its
// `_gemv_kernel` body): the same per-weight dequantization (f32 code times
// f32 scale, rounded once to bf16), f32 accumulation, bf16 output.
//
// Bound on the H100: bytes. At decode M the product does ~2*M flops per
// weight while each sym_int4 weight costs 4.5 bits of HBM traffic, so the
// packed planes streaming from device memory set the floor (one Llama-2-7B
// decode step reads ~3.7 GB of packed weights: ~1.1 ms at 3.35 TB/s).
//
// Design: the small-M body of dequant_smallm.cuh (weights as the mma A
// operand, x as B in n8 tiles of tokens, a 16-byte-load word ring per warp,
// K split across blocks and summed in split order by the last block of each
// column strip in the same launch) for every canonical kind: sym_int4,
// asym_int4, the 4-bit codebooks and sym_int8.
#include "dequant_smallm.cuh"

// Returns the cudaError_t of the launch (0 on success). ws holds
// split * M * N floats and tickets at least ceil(N / (32 cw)) zeroed
// counters when split > 1 (else both may be null); y is bf16 [M, N]; K is
// cut into chunks of 64, chunks_per_split per block row; cw is the words a
// thread loads per packed row (4 or 1 at M <= 16, 2 or 1 above).
extern "C" int bigdl_dequant_gemv(const void* x, const void* data,
                                  const void* scale, const void* zero,
                                  const void* lut, void* ws, void* tickets,
                                  void* y, int M, int Kp, int N, int block,
                                  int kind, int split, int chunks_per_split,
                                  int cw, void* stream) {
    if (M > 32 || kind == KIND_I4 ||
        !smallm::args_ok(M, Kp, N, block, kind, split, chunks_per_split, ws,
                         tickets, cw)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
#define BIGDL_GEMV_LAUNCH(NT, CW, K)                                       \
    return smallm::launch<NT, CW, K, false, false>(                        \
        x, data, scale, zero, lut, ws, tickets, y, M, Kp, N, split,        \
        chunks_per_split, 1, dqmma::RaggedArgs{}, st);
#define BIGDL_GEMV_VARIANT(NT, CW)                                         \
    {                                                                      \
        BIGDL_SMALLM_KINDS(BIGDL_GEMV_LAUNCH, NT, CW)                      \
        return (int)cudaErrorInvalidValue;                                 \
    }
    BIGDL_SMALLM_VARIANTS(BIGDL_GEMV_VARIANT, M, cw,
                          (int)cudaErrorInvalidValue)
#undef BIGDL_GEMV_VARIANT
#undef BIGDL_GEMV_LAUNCH
}

// Resident blocks per SM of the variant a launch with these M, kind and cw
// takes (0 on error); the wrapper sizes its K split from it.
extern "C" int bigdl_dequant_gemv_blocks_per_sm(int M, int kind, int cw) {
#define BIGDL_GEMV_OCC(NT, CW, K) \
    return smallm::blocks_per_sm<NT, CW, K, false, false>();
#define BIGDL_GEMV_VARIANT(NT, CW)                  \
    {                                               \
        BIGDL_SMALLM_KINDS(BIGDL_GEMV_OCC, NT, CW)  \
        return 0;                                   \
    }
    BIGDL_SMALLM_VARIANTS(BIGDL_GEMV_VARIANT, M, cw, 0)
#undef BIGDL_GEMV_VARIANT
#undef BIGDL_GEMV_OCC
}

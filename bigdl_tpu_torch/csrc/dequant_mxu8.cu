// B1's mxu8 body: y[M, N] = x[M, Kp] . W[Kp, N] for M <= 32 with 8-bit
// activations, against an int4-layout (prepacked sym_int4) or a sym_int8
// weight.
//
// Replaces bigdl_tpu/ops/pallas/dequant_matmul.py::_gemv_kernel_mxu8
// (L284): x quantized per 32-K block to int8 (amax / 127, round half to
// even; the wrapper computes it with the JAX package's expression), an
// exact int8 x int8 -> int32 product per block, then * s[r, n] * sx[m, r]
// in f32.
//
// Bound on the H100: bytes, as B1's other bodies (the packed weight
// streams once; the int8 activations are M * Kp bytes). Design: the body
// of dequant_mma.cuh's q8_mma_kernel, one m16n8k32 s8 mma a quant block
// and n-tile (the card's int8 tensor-core path, twice bf16's rate); the
// weight bytes go from device memory to registers as in the bf16 bodies
// and are widened to s8 with byte permutes.
#include "dequant_mma.cuh"

#define BIGDL_Q8_VARIANTS(F, K)                 \
    if (M <= 16 && cw == 2) F(1, 2, 2, K)       \
    if (M <= 16 && cw == 1) F(1, 1, 4, K)       \
    if (M <= 32 && cw == 1) F(2, 1, 4, K)

// Returns the cudaError_t of the launches (0 on success). xq is int8
// [M, Kp], sx f32 [M, Kp / 32]; kind is KIND_I4 or KIND_SYM8; ws holds
// split * M * N floats when split > 1; y is bf16 [M, N].
extern "C" int bigdl_dequant_mxu8(const void* xq, const void* sx,
                                  const void* data, const void* scale,
                                  void* ws, void* y, int M, int Kp, int N,
                                  int kind, int split, int chunks_per_split,
                                  int cw, void* stream) {
    if ((kind != KIND_I4 && kind != KIND_SYM8) ||
        !dqmma::args_ok(M, Kp, N, 32, kind, split, chunks_per_split, ws,
                        cw)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
#define BIGDL_Q8_LAUNCH(MT, CW, ST, K)                                    \
    {                                                                     \
        return dqmma::launch_q8<MT, CW, ST, K>(xq, sx, data, scale, ws, y, \
                                               M, Kp, N, split,           \
                                               chunks_per_split, st);     \
    }
    if (kind == KIND_I4) {
        BIGDL_Q8_VARIANTS(BIGDL_Q8_LAUNCH, KIND_I4)
    } else {
        BIGDL_Q8_VARIANTS(BIGDL_Q8_LAUNCH, KIND_SYM8)
    }
#undef BIGDL_Q8_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the variant a launch with these M, kind and cw
// takes (0 on error); the wrapper sizes its K split from it.
extern "C" int bigdl_dequant_mxu8_blocks_per_sm(int M, int kind, int cw) {
#define BIGDL_Q8_OCC(MT, CW, ST, K) \
    { return dqmma::q8_blocks_per_sm<MT, CW, ST, K>(); }
    if (kind == KIND_I4) {
        BIGDL_Q8_VARIANTS(BIGDL_Q8_OCC, KIND_I4)
    } else if (kind == KIND_SYM8) {
        BIGDL_Q8_VARIANTS(BIGDL_Q8_OCC, KIND_SYM8)
    }
#undef BIGDL_Q8_OCC
    return 0;
}

// The decode-GEMV bodies (B1) that read a prepacked (int4-layout) weight,
// fold the block scales out of the product, or take 8-bit activations:
//
//   mxu      int4 layout, scale-folded       _gemv_kernel_mxu (L234)
//   fold     canonical packing, scale-folded _gemv_kernel_fold (L172)
//   mxuflat  int4 layout, per-weight scale   _gemv_kernel_mxuflat (L265)
//   mxu8     int4 layout or sym_int8, q8 x   _gemv_kernel_mxu8 (L284)
//
// (bigdl_tpu/ops/pallas/dequant_matmul.py). B2's int4-layout body
// (`_kernel_i4`) is the KIND_I4 decode of dequant_gemm.cu's entry point.
// mxu and fold compute
// y = sum over blocks r of s[r, n] * (x . codes)[r]: the codes are exact in
// bf16 (a codebook value is rounded to bf16 first), each block's product
// sums in f32 and is then scaled once in f32 per column. mxuflat
// dequantizes every weight to bf16 (code times scale, rounded once) as the
// std bodies do, reading the int4 layout. mxu8 quantizes x per 32-K block
// to int8 (amax / 127, round half to even, the JAX package's expression)
// and computes y = sum over r of (xq . codes)[r] * s[r, n] * sx[m, r], the
// integer block partial exact, the scales applied in f32.
//
// Bound on the H100: bytes (decode M moves 4.5 bits a weight, 8 for
// sym_int8, for 2 M flops).
//
// All four run on the small-M body of dequant_smallm.cuh, as B1's std body
// does: the weights are the mma A operand, so the C rows a lane holds are
// the columns whose codes and scales it loaded, and FOLD (mxu, fold) and
// Q8 (mxu8) need no second scale load and no second set of C fragments;
// 16-byte loads at M <= 16, one launch with the K split summed by the last
// block of a strip. fold is the FOLD policy over the canonical kinds
// (sym_int4, the codebooks, sym_int8), mxuflat the STD policy over the int4
// layout. mxu8 quantizes x inside that launch, each warp the chunks it
// stages, and multiplies on the s8 m16n8k32 mma.
#include "dequant_smallm.cuh"

enum Body : int {
    BODY_MXU = 0,
    BODY_FOLD = 1,
    BODY_MXUFLAT = 2,
    BODY_MXU8 = 3
};

// Calls F(NT, CW, KIND, FOLD, Q8) for the small-M variant that a body and
// a weight kind take, or leaves the switch for a pair no variant takes.
#define BIGDL_BODY_KINDS(F, NT, CW)                                         \
    switch (body) {                                                         \
        case BODY_MXU:                                                      \
            if (kind == KIND_I4) F(NT, CW, KIND_I4, true, false)            \
            break;                                                          \
        case BODY_MXUFLAT:                                                  \
            if (kind == KIND_I4) F(NT, CW, KIND_I4, false, false)           \
            break;                                                          \
        case BODY_FOLD:                                                     \
            if (kind == KIND_SYM4) F(NT, CW, KIND_SYM4, true, false)        \
            if (kind == KIND_CODEBOOK4)                                     \
                F(NT, CW, KIND_CODEBOOK4, true, false)                      \
            if (kind == KIND_SYM8) F(NT, CW, KIND_SYM8, true, false)        \
            break;                                                          \
        case BODY_MXU8:                                                     \
            if (kind == KIND_I4) F(NT, CW, KIND_I4, false, true)            \
            if (kind == KIND_SYM8) F(NT, CW, KIND_SYM8, false, true)        \
            break;                                                          \
        default:                                                            \
            break;                                                          \
    }

// Returns the cudaError_t of the launch (0 on success). body picks the
// variant (Body); kind is the weight kind: KIND_SYM4, KIND_CODEBOOK4 or
// KIND_SYM8 for fold, KIND_I4 or KIND_SYM8 for mxu8, KIND_I4 for mxu and
// mxuflat. x is bf16 [M, Kp] (mxu8 quantizes it in the launch); ws holds
// split * M * N floats and tickets at least ceil(N / (32 cw)) zeroed
// counters when split > 1; y is bf16 [M, N]; K is cut into chunks of 64,
// chunks_per_split per block row; cw is the words a thread loads per
// packed row (4 or 1 at M <= 16, 2 or 1 above).
extern "C" int bigdl_dequant_variant(int body, const void* x,
                                     const void* data, const void* scale,
                                     const void* lut, void* ws,
                                     void* tickets, void* y, int M, int Kp,
                                     int N, int block, int kind, int split,
                                     int chunks_per_split, int cw,
                                     void* stream) {
    if (M > 32 || x == nullptr || ((uintptr_t)x & 15) ||
        !smallm::args_ok(M, Kp, N, block, kind, split, chunks_per_split, ws,
                         tickets, cw)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
#define BIGDL_VARIANT_LAUNCH(NT, CW, K, FOLD, Q8)                          \
    return smallm::launch<NT, CW, K, FOLD, false, Q8>(                     \
        x, data, scale, nullptr, lut, ws, tickets, y, M, Kp, N, split,     \
        chunks_per_split, 1, dqmma::RaggedArgs{}, st);
#define BIGDL_VARIANT(NT, CW)                                              \
    {                                                                      \
        BIGDL_BODY_KINDS(BIGDL_VARIANT_LAUNCH, NT, CW)                     \
        return (int)cudaErrorInvalidValue;                                 \
    }
    BIGDL_SMALLM_VARIANTS(BIGDL_VARIANT, M, cw, (int)cudaErrorInvalidValue)
#undef BIGDL_VARIANT
#undef BIGDL_VARIANT_LAUNCH
}

// Resident blocks per SM of the variant a launch with these arguments
// takes (0 on error); the wrapper sizes its K split from it.
extern "C" int bigdl_dequant_variant_blocks_per_sm(int body, int M, int kind,
                                                   int cw) {
#define BIGDL_VARIANT_OCC(NT, CW, K, FOLD, Q8) \
    return smallm::blocks_per_sm<NT, CW, K, FOLD, false, Q8>();
#define BIGDL_VARIANT(NT, CW)                           \
    {                                                   \
        BIGDL_BODY_KINDS(BIGDL_VARIANT_OCC, NT, CW)     \
        return 0;                                       \
    }
    BIGDL_SMALLM_VARIANTS(BIGDL_VARIANT, M, cw, 0)
#undef BIGDL_VARIANT
#undef BIGDL_VARIANT_OCC
}

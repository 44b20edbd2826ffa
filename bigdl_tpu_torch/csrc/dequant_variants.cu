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
// mxu, the load path's decode default, and mxu8 run on the small-M body of
// dequant_smallm.cuh: the weights are the mma A operand, so the C rows a
// lane holds are the columns whose codes and scales it loaded, and FOLD
// (and Q8) need no second scale load and no second set of C fragments;
// 16-byte loads at M <= 16, one launch with the K split summed by the last
// block. mxu8 quantizes x inside that launch, each warp the chunks it
// stages, and multiplies on the s8 m16n8k32 mma. fold and mxuflat
// (flag-selected) run on the tensor-core template of dequant_mma.cuh,
// where x is the A operand: FOLD
// there keeps a second set of f32 C fragments and loads its C columns'
// scales, so fold runs at 2 (M <= 16) or 1 words a thread per row to stay
// under 255 registers, and a K split takes a second kernel.
#include "dequant_smallm.cuh"

enum Body : int {
    BODY_MXU = 0,
    BODY_FOLD = 1,
    BODY_MXUFLAT = 2,
    BODY_MXU8 = 3
};

// Calls F(MT, CW, STAGES, KIND, FOLD) for the dequant_mma.cuh variant a
// launch of fold or mxuflat takes, or returns `err` for a combination
// that no variant takes.
#define BIGDL_VARIANT(F, err)                                               \
    switch (body) {                                                         \
        case BODY_FOLD:                                                     \
            BIGDL_FOLD_KIND(F, KIND_SYM4)                                   \
            BIGDL_FOLD_KIND(F, KIND_CODEBOOK4)                              \
            BIGDL_FOLD_KIND(F, KIND_SYM8)                                   \
            break;                                                          \
        case BODY_MXUFLAT:                                                  \
            if (M <= 16 && cw == 4) F(1, 4, 2, KIND_I4, false)              \
            if (M <= 16 && cw == 1) F(1, 1, 4, KIND_I4, false)              \
            if (M <= 32 && cw == 4) F(2, 4, 2, KIND_I4, false)              \
            if (M <= 32 && cw == 1) F(2, 1, 4, KIND_I4, false)              \
            break;                                                          \
    }                                                                       \
    return err;

#define BIGDL_FOLD_KIND(F, K)                                               \
    if (kind == K) {                                                        \
        if (M <= 16 && cw == 2) F(1, 2, 2, K, true)                         \
        if (M <= 16 && cw == 1) F(1, 1, 4, K, true)                         \
        if (M <= 32 && cw == 1) F(2, 1, 4, K, true)                         \
    }

// Returns the cudaError_t of the launches (0 on success). body picks the
// variant (Body); kind is the weight kind of `fold` (KIND_SYM4,
// KIND_CODEBOOK4 or KIND_SYM8) and of `mxu8` (KIND_I4 or KIND_SYM8); the
// others read KIND_I4. x is bf16 [M, Kp] (mxu8 quantizes it in the launch);
// ws holds split * M * N floats when split > 1; tickets (mxu, mxu8) at
// least ceil(N / (32 cw)) zeroed counters when split > 1; y is bf16
// [M, N]; K is cut into chunks of 64, chunks_per_split per block row; cw
// is the words a thread loads per packed row.
extern "C" int bigdl_dequant_variant(int body, const void* x,
                                     const void* data, const void* scale,
                                     const void* lut, void* ws,
                                     void* tickets, void* y, int M, int Kp,
                                     int N, int block, int kind, int split,
                                     int chunks_per_split, int cw,
                                     void* stream) {
    // the int4 layout is sym_int4 (block 32); fold's block is its kind's
    const bool kind_ok =
        body == BODY_FOLD ? true
        : body == BODY_MXU8 ? (kind == KIND_I4 || kind == KIND_SYM8)
                            : kind == KIND_I4;
    const int want_block = kind == KIND_CODEBOOK4 ? 64 : 32;
    if (!kind_ok || block != want_block || x == nullptr ||
        ((uintptr_t)x & 15) ||
        !dqmma::args_ok(M, Kp, N, block, kind, split, chunks_per_split, ws,
                        cw)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    if (body == BODY_MXU || body == BODY_MXU8) {
        if (M > 32 || !smallm::args_ok(M, Kp, N, block, kind, split,
                                       chunks_per_split, ws, tickets, cw)) {
            return (int)cudaErrorInvalidValue;
        }
#define BIGDL_Q8_LAUNCH(NT, CW, K)                                         \
    return smallm::launch<NT, CW, K, false, false, true>(                  \
        x, data, scale, nullptr, lut, ws, tickets, y, M, Kp, N, split,     \
        chunks_per_split, 1, dqmma::RaggedArgs{}, st);
#define BIGDL_MXU_LAUNCH(NT, CW)                                           \
    {                                                                      \
        if (body == BODY_MXU) {                                            \
            return smallm::launch<NT, CW, KIND_I4, true, false>(           \
                x, data, scale, nullptr, lut, ws, tickets, y, M, Kp, N,    \
                split, chunks_per_split, 1, dqmma::RaggedArgs{}, st);      \
        }                                                                  \
        if (kind == KIND_I4) { BIGDL_Q8_LAUNCH(NT, CW, KIND_I4) }          \
        BIGDL_Q8_LAUNCH(NT, CW, KIND_SYM8)                                 \
    }
        BIGDL_SMALLM_VARIANTS(BIGDL_MXU_LAUNCH, M, cw,
                              (int)cudaErrorInvalidValue)
#undef BIGDL_MXU_LAUNCH
#undef BIGDL_Q8_LAUNCH
    }
#define BIGDL_VARIANT_LAUNCH(MT, CW, ST, K, FOLD)                          \
    {                                                                      \
        return dqmma::launch_variant<MT, CW, ST, K, FOLD>(                 \
            x, data, scale, lut, ws, y, M, Kp, N, block, split,            \
            chunks_per_split, st);                                         \
    }
    BIGDL_VARIANT(BIGDL_VARIANT_LAUNCH, (int)cudaErrorInvalidValue)
#undef BIGDL_VARIANT_LAUNCH
}

// Resident blocks per SM of the variant a launch with these arguments
// takes (0 on error); the wrapper sizes its K split from it.
extern "C" int bigdl_dequant_variant_blocks_per_sm(int body, int M, int kind,
                                                   int cw) {
    if (body == BODY_MXU || body == BODY_MXU8) {
#define BIGDL_SMALLM_OCC(NT, CW, K, FOLD, Q8) \
    return smallm::blocks_per_sm<NT, CW, K, FOLD, false, Q8>();
#define BIGDL_MXU_OCC(NT, CW)                                              \
    {                                                                      \
        if (body == BODY_MXU) {                                            \
            BIGDL_SMALLM_OCC(NT, CW, KIND_I4, true, false)                 \
        }                                                                  \
        if (kind == KIND_I4) {                                             \
            BIGDL_SMALLM_OCC(NT, CW, KIND_I4, false, true)                 \
        }                                                                  \
        if (kind == KIND_SYM8) {                                           \
            BIGDL_SMALLM_OCC(NT, CW, KIND_SYM8, false, true)               \
        }                                                                  \
        return 0;                                                          \
    }
        BIGDL_SMALLM_VARIANTS(BIGDL_MXU_OCC, M, cw, 0)
#undef BIGDL_MXU_OCC
#undef BIGDL_SMALLM_OCC
    }
#define BIGDL_VARIANT_OCC(MT, CW, ST, K, FOLD) \
    { return dqmma::variant_blocks_per_sm<MT, CW, ST, K, FOLD>(); }
    BIGDL_VARIANT(BIGDL_VARIANT_OCC, 0)
#undef BIGDL_VARIANT_OCC
}

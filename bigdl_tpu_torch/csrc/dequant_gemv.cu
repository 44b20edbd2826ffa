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
// Design: the tensor-core dequant matmul of dequant_mma.cuh with one or two
// m-tiles (M <= 16, M <= 32). The packed words go from device memory to
// registers with no shared-memory round trip, one coalesced 4-byte load
// per thread per packed row, and the next 64-K chunk's words are in flight
// while the current one computes. Dequantization is 4 integer/bf16x2
// instructions per weight pair for sym_int4, so the issue rate stays under
// the memory time. Where the 128-column strips alone cannot fill the SMs,
// the wrapper splits K across blocks; the split partials are summed in a
// fixed order by a second pass (no atomics), so results repeat exactly.
#include "dequant_mma.cuh"

// The variants: one or two m-tiles (M <= 16, M <= 32) by cw words per
// thread per packed row: 4 (16-byte loads, 512 columns a block, two chunks
// in the pipeline) where N % 16 == 0, else 1 (four chunks in the pipeline).
#define BIGDL_GEMV_VARIANTS(F, MT) \
    if (cw == 4) F(MT, 4, 2) else F(MT, 1, 4)

// Returns the cudaError_t of the launches (0 on success). ws holds
// split * M * N floats when split > 1 (else it may be null); y is bf16
// [M, N]; K is cut into chunks of 64, chunks_per_split per block row.
extern "C" int bigdl_dequant_gemv(const void* x, const void* data,
                                  const void* scale, const void* zero,
                                  const void* lut, void* ws, void* y, int M,
                                  int Kp, int N, int block, int kind,
                                  int split, int chunks_per_split, int cw,
                                  void* stream) {
    if (M > 32 || (cw != 1 && cw != 4) ||
        !dqmma::args_ok(M, Kp, N, block, kind, split, chunks_per_split, ws,
                        cw)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
#define BIGDL_GEMV_LAUNCH(MT, CW, ST)                                    \
    {                                                                    \
        return dqmma::launch<MT, CW, ST>(kind, x, data, scale, zero, lut, \
                                         ws, y, M, Kp, N, block, split,  \
                                         chunks_per_split, st);          \
    }
    if (M <= 16) BIGDL_GEMV_VARIANTS(BIGDL_GEMV_LAUNCH, 1);
    BIGDL_GEMV_VARIANTS(BIGDL_GEMV_LAUNCH, 2);
#undef BIGDL_GEMV_LAUNCH
}

// Resident blocks per SM of the variant a launch with these M, kind and cw
// takes (0 on error); the wrapper sizes its K split from it.
extern "C" int bigdl_dequant_gemv_blocks_per_sm(int M, int kind, int cw) {
#define BIGDL_GEMV_OCC(MT, CW, ST) \
    { return dqmma::blocks_per_sm<MT, CW, ST>(kind); }
    if (M <= 16) BIGDL_GEMV_VARIANTS(BIGDL_GEMV_OCC, 1);
    BIGDL_GEMV_VARIANTS(BIGDL_GEMV_OCC, 2);
#undef BIGDL_GEMV_OCC
}

// B2: dequant GEMM over block-quantized weights,
// y[M, N] = x[M, Kp] . W[Kp, N] for 32 < M <= 128 (prefill chunks).
//
// Replaces bigdl_tpu/ops/pallas/dequant_matmul.py::_q_matmul_generic (its
// `_kernel_4bit` and `_kernel_int8` bodies): every weight is dequantized
// with B1's arithmetic (f32 code times f32 scale, one rounding to bf16) and
// multiplied with f32 accumulation.
//
// Bound on the H100: at M = 128 and Llama-2-7B widths the product does
// ~0.8 k flops per packed byte, above the card's bf16 ridge (~295 flops per
// byte), so operations bound it; at M = 64 it is near the ridge.
//
// Design: the tensor-core dequant matmul of dequant_mma.cuh with four or
// eight m-tiles (M <= 64, M <= 128). Each warp dequantizes its 32 columns
// of a 16-K step once, in registers, and feeds them to all MT m-tiles
// (4 * MT mma.sync per step), so dequantization costs 1/M of a weight's
// multiply-adds. x is staged per 64-K chunk in shared memory and read with
// ldmatrix. mma.sync reaches only part of the wgmma peak that the bound
// assumes; wgmma/TMA is later work.
#include "dequant_mma.cuh"

// Returns the cudaError_t of the launches (0 on success). ws holds
// split * M * N floats when split > 1 (else it may be null); y is bf16
// [M, N]; K is cut into chunks of 64, chunks_per_split per block row; cw
// (words per thread per packed row) must be 1.
extern "C" int bigdl_dequant_gemm(const void* x, const void* data,
                                  const void* scale, const void* zero,
                                  const void* lut, void* ws, void* y, int M,
                                  int Kp, int N, int block, int kind,
                                  int split, int chunks_per_split, int cw,
                                  void* stream) {
    if (M > 128 || cw != 1 ||
        !dqmma::args_ok(M, Kp, N, block, kind, split, chunks_per_split, ws,
                        cw)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    if (M <= 64) {
        return dqmma::launch<4, 1, 2>(kind, x, data, scale, zero, lut, ws, y,
                                      M, Kp, N, block, split,
                                      chunks_per_split, st);
    }
    return dqmma::launch<8, 1, 2>(kind, x, data, scale, zero, lut, ws, y, M,
                                  Kp, N, block, split, chunks_per_split, st);
}

// Resident blocks per SM of the variant a launch with these M, kind and cw
// takes (0 on error); the wrapper sizes its K split from it.
extern "C" int bigdl_dequant_gemm_blocks_per_sm(int M, int kind, int cw) {
    if (cw != 1) return 0;
    return M <= 64 ? dqmma::blocks_per_sm<4, 1, 2>(kind)
                   : dqmma::blocks_per_sm<8, 1, 2>(kind);
}

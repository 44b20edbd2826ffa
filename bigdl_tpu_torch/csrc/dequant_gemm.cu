// B2: dequant GEMM over block-quantized weights, y[M, N] = x[M, Kp] . W[Kp,
// N] for M <= 128 (the engine sends it prefill chunks of 33-128 rows), on
// the Hopper body of dequant_wgmma.cuh (wgmma, TMA, an mbarrier ring).
//
// Replaces bigdl_tpu/ops/pallas/dequant_matmul.py::_q_matmul_generic (L641:
// `_kernel_4bit` L113 and `_kernel_int8` L125 over the canonical packing,
// `_kernel_i4` L133 over the int4 layout of a prepacked sym_int4 weight):
// one entry point, the weight kind picking the decode (KIND_I4: the int4
// layout). Every weight is dequantized with B1's arithmetic (f32 code times
// f32 scale, one rounding to bf16) and multiplied with f32 accumulation.
//
// Bound on the H100: at M = 128 and Llama-2-7B widths the product does
// ~0.8 k flops per packed byte, above the card's bf16 ridge (~295 flops per
// byte), so operations bound it; at M = 64 it is near the ridge. The design
// is the header's.
#include <chrono>

#include "dequant_wgmma.cuh"

// Returns 0 or an error code (a cudaError_t; kEncodeError + CUresult
// for a tensor map that failed to encode). ws holds split * M * N floats and
// tickets at least ceil(N / 128) zeroed counters when split > 1 (else both
// may be null); y is bf16 [M, N]; K is cut into chunks of 64,
// chunks_per_split per split; planes_tma 1 loads the planes by TMA (they
// must then be 16-byte aligned with N % 16 == 0), 0 by cp.async.
extern "C" int bigdl_dequant_gemm(const void* x, const void* data,
                                  const void* scale, const void* zero,
                                  const void* lut, void* ws, void* tickets,
                                  void* y, int M, int Kp, int N, int block,
                                  int kind, int split, int chunks_per_split,
                                  int planes_tma, void* stream) {
    if (M > 128 || kind == KIND_BF16 ||
        !dqwg::args_ok(x, M, Kp, N, block, kind, split, chunks_per_split, ws,
                       tickets) ||
        (planes_tma &&
         !dqwg::planes_tma_ok(N, data, scale, zero, 0, 0))) {
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
    // one matrix: the maps' expert stride is the matrix itself
    a.data_es = (long long)(row_units(kind) ? Kp : Kp / 2) * N;
    a.scale_es = (long long)(Kp / block) * N;
    a.M = M;
    a.Kp = Kp;
    a.N = N;
    a.cps = chunks_per_split;
    a.num_experts = 1;
    a.planes_tma = planes_tma;
    return dqwg::launch<false>(kind, x, data, scale, zero, a, M, 1, 1, split,
                               (cudaStream_t)stream);
}

// Resident blocks per SM of the variant a launch with these M and kind
// takes (0 on error); the wrapper sizes its K split from it.
extern "C" int bigdl_dequant_gemm_blocks_per_sm(int M, int kind) {
    return dqwg::occupancy<false>(kind, M);
}

// Host nanoseconds one launch spends encoding its tensor maps (x, and the
// planes when planes_tma), the mean of `iters` encodes of these arguments'
// maps; negative (minus the error code) if an encode fails.
extern "C" long long bigdl_dequant_gemm_encode_ns(
    const void* x, const void* data, const void* scale, const void* zero,
    int M, int Kp, int N, int block, int kind, int planes_tma, int iters) {
    dqwg::Maps m;
    const long long data_es = (long long)(row_units(kind) ? Kp : Kp / 2) * N;
    const long long scale_es = (long long)(Kp / block) * N;
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < iters; ++i) {
        const int err = dqwg::encode_maps(m, x, M, Kp, data, scale, zero, N,
                                          kind, 1, data_es, scale_es,
                                          planes_tma != 0);
        if (err) return -(long long)err;
    }
    const auto t1 = std::chrono::steady_clock::now();
    return std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
               .count() / (iters > 0 ? iters : 1);
}

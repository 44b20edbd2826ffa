// Streaming probe for the small-M dequant body (bigdl_tpu_torch/csrc/
// dequant_smallm.cuh): the same weight loads, no arithmetic but a running
// hash, so its time is what the load pattern alone costs on the card.
//
// Block = 4 warps on one strip of 128 packed columns (16-byte loads, lane
// (g, t) on columns 16 g .. 16 g + 15 and packed rows 2t, 2t+1, 2t+8,
// 2t+9 of each 16-row unit); warp w takes chunks c + w + 4 i of 32 packed
// rows (64 K) of its split; two chunks in flight. Built and run by
// tools/bench_smallm.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load_chunk(uint32_t (&w)[2][4][4],
                                           const uint8_t* __restrict__ data,
                                           int p, int N, int ncol, int t) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = p + 16 * u + 2 * t + (r & 1) + 8 * (r >> 1);
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                data + (size_t)row * N + ncol));
            w[u][r][0] = v.x;
            w[u][r][1] = v.y;
            w[u][r][2] = v.z;
            w[u][r][3] = v.w;
        }
    }
}

__global__ void __launch_bounds__(128)
probe_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
             int Kp, int N, int cps) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int ncol = blockIdx.x * 128 + g * 16;
    const int c_begin = blockIdx.y * cps;
    const int c_end = min(Kp / 64, c_begin + cps);
    const int mine = (c_end - c_begin - warp + 3) / 4;
    uint32_t acc = 0;
    uint32_t ring[2][2][4][4];
    if (mine > 0) load_chunk(ring[0], data, (c_begin + warp) * 32, N, ncol, t);
    for (int i0 = 0; i0 < mine; i0 += 2) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int i = i0 + s;
            if (i >= mine) break;
            if (i + 1 < mine) {
                load_chunk(ring[s ^ 1], data,
                           (c_begin + warp + 4 * (i + 1)) * 32, N, ncol, t);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc = acc * 3 + ring[s][u][r][c];
                }
            }
        }
    }
    out[(blockIdx.y * gridDim.x + blockIdx.x) * 128 + threadIdx.x] = acc;
}

}  // namespace

// data: [Kp / 2, N] bytes (N % 128 == 0, Kp % 64 == 0); out: at least
// N / 128 * split * 128 words. Returns the cudaError_t of the launch.
extern "C" int smallm_probe(const void* data, void* out, int Kp, int N,
                            int split, int chunks_per_split, void* stream) {
    if (N % 128 || Kp % 64 || split < 1 || chunks_per_split < 1) {
        return (int)cudaErrorInvalidValue;
    }
    probe_kernel<<<dim3(N / 128, split), 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (uint32_t*)out, Kp, N, chunks_per_split);
    return (int)cudaGetLastError();
}

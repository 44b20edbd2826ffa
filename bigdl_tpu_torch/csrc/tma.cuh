// TMA and mbarrier helpers of the Hopper kernels (the dequant GEMM body
// dequant_wgmma.cuh and the attention bodies decode_attention.cuh and
// prefill_attention.cu):
// barrier init / arrive / expect-tx / wait, 2-D tensor copies completing
// on a barrier, and the host's tensor-map encoder, looked up through the
// CUDA runtime (cudaGetDriverEntryPoint) so no build links -lcuda.
//
// A wait on a barrier phase that never completes traps after kWatchdog
// cycles (~2 s) instead of hanging the card.
#pragma once

#include <cuda.h>

#include "common.cuh"

constexpr long long kWatchdog = 1ll << 32;   // cycles before a trap

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    long long t0 = 0;
    for (;;) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (t0 == 0) {
            t0 = clock64();
        } else if (clock64() - t0 > kWatchdog) {
            __trap();
        }
    }
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
        :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// error codes beyond cudaError_t's: a tensor map that failed to encode
// (kEncodeError + its CUresult), or no cuTensorMapEncodeTiled to encode one
constexpr int kEncodeError = 10000;
constexpr int kNoEncoder = 20000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// build needs no -lcuda
inline EncodeTiled encoder() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
                   ? (EncodeTiled)p : (EncodeTiled) nullptr;
    }();
    return fn;
}


// the barrier's current phase also waits for this thread's cp.async
// copies issued so far (an arrival of its own: count it in the barrier's
// init)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(bar) : "memory");
}

// async-proxy copies (TMA) into shared memory after this thread's generic
// writes to it
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Reads of a tile that TMA laid out as boxes of ROWS rows of W bytes (W
// 128, 64 or 32) with the W-byte swizzle. Byte x of row r: the box of x,
// row r at r * W, then 16-byte chunk bits 4.. xor'ed with row bits 7..
template <int W, int ROWS>
__device__ __forceinline__ int swizzled(int r, int x) {
    const int a = (x / W) * (ROWS * W) + r * W + x % W;
    return a ^ ((a >> 3) & (W - 16));
}

// NW words of row r of such a tile from byte x0 on (16-, 8- or 4-byte
// pieces, each inside one swizzled chunk)
template <int W, int ROWS, int NW>
__device__ __forceinline__ void lds_swizzled(uint32_t (&w)[NW],
                                             const uint8_t* t, int r, int x0) {
    static_assert(W % 16 == 0, "a piece stays inside one chunk");
    if constexpr (NW % 4 == 0) {
#pragma unroll
        for (int i = 0; i < NW; i += 4) {
            const uint4 u = *reinterpret_cast<const uint4*>(
                t + swizzled<W, ROWS>(r, x0 + 4 * i));
            w[i] = u.x;
            w[i + 1] = u.y;
            w[i + 2] = u.z;
            w[i + 3] = u.w;
        }
    } else if constexpr (NW % 2 == 0) {
#pragma unroll
        for (int i = 0; i < NW; i += 2) {
            const uint2 u = *reinterpret_cast<const uint2*>(
                t + swizzled<W, ROWS>(r, x0 + 4 * i));
            w[i] = u.x;
            w[i + 1] = u.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < NW; ++i)
            w[i] = *reinterpret_cast<const uint32_t*>(
                t + swizzled<W, ROWS>(r, x0 + 4 * i));
    }
}

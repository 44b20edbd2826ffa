// B4: blockwise (flash) causal attention for prefill chunks, forward only.
//
// Replaces bigdl_tpu/ops/pallas/prefill_attention.py::_pfa_impl (bf16 body
// `_kernel`): Sq new queries q [B, Sq, H, hd] against S_max cache rows
// k/v [B, S_max, Hkv, hd] at offset pos; key kj is visible to query qi iff
// kj <= pos[b] + qi. Online softmax in f32 (running m, l, acc), the
// probabilities rounded to bf16 before the value product, and the l == 0
// guard for rows with no visible key. Output bf16 [B, Sq, H, hd].
//
// Bound on the H100: bytes at the engine's chunk shapes (Sq 128-256 against
// a cache of a few hundred to a few thousand rows): the visible K/V rows
// and q/out move more bytes than the tensor cores need time for their
// flops, ~4 * hd flops per (query, visible key) pair.
//
// Design (FlashAttention-2 on mma.sync m16n8k16, bf16 in, f32 accumulate):
// one block of 4 warps per (64-query tile, b*h), each warp owning 16 query
// rows. The Q tile and 64-key K/V tiles sit in shared memory (cp.async,
// the next K/V tile in flight while this one computes); the block walks K
// tiles only up to the last key visible to its last query, so masked tiles
// are never read. S = Q K^T comes from ldmatrix fragments, is masked,
// scaled and folded into the running (m, l) in registers; the bf16 P
// fragments feed P V directly (the S accumulator layout is the A operand
// layout), with V read by ldmatrix.trans. Scores never exist in device or
// shared memory.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;                  // queries per block (16 per warp)
constexpr int kBK = 64;                  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// rows [r0, r0 + 64) of one head ([rows, hd] with row stride `rs`
// elements) into a [64][LD] shared tile; rows >= nrows as zeros
template <int HD, int LD>
__device__ __forceinline__ void stage_rows(uint16_t* dst,
                                           const uint16_t* __restrict__ src,
                                           size_t rs, int r0, int nrows,
                                           int tid) {
    constexpr int kPieces = HD / 8;      // 16-byte pieces per row
#pragma unroll
    for (int r = 0; r < 64 * kPieces / kThreads; ++r) {
        const int i = tid + r * kThreads;
        const int row = i / kPieces;
        const int d = 8 * (i % kPieces);
        const bool ok = r0 + row < nrows;
        cp_async16(dst + row * LD + d,
                   ok ? src + (size_t)(r0 + row) * rs + d : src, ok ? 16 : 0);
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const uint16_t* __restrict__ q,   // [B, Sq, H, HD]
                         const uint16_t* __restrict__ k,   // [B, Smax, Hkv, HD]
                         const uint16_t* __restrict__ v,
                         const int* __restrict__ pos,      // [B]
                         uint16_t* __restrict__ out,       // [B, Sq, H, HD]
                         int Sq, int Smax, int H, int Hkv, float scale) {
    constexpr int LD = HD + 8;           // 16-byte aligned rows; ldmatrix
                                         // rows fall in distinct banks
    constexpr int NT = HD / 8;           // 8-wide head-dim tiles of O
    extern __shared__ __align__(16) uint16_t smem[];
    uint16_t* Qs = smem;                 // [kBQ][LD]
    uint16_t* Ks = Qs + kBQ * LD;        // [2][kBK][LD]
    uint16_t* Vs = Ks + 2 * kBK * LD;    // [2][kBK][LD]

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int kh = h / (H / Hkv);
    const int q0 = blockIdx.x * kBQ;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;

    const int p = pos[b];
    const int kend = min(Smax, p + q0 + kBQ);     // keys any row can see
    const int ntiles = (kend + kBK - 1) / kBK;
    const size_t krs = (size_t)Hkv * HD;
    const uint16_t* kb = k + (size_t)b * Smax * krs + (size_t)kh * HD;
    const uint16_t* vb = v + (size_t)b * Smax * krs + (size_t)kh * HD;

    stage_rows<HD, LD>(Qs, q + ((size_t)b * Sq * H + h) * HD, (size_t)H * HD,
                       q0, Sq, tid);
    stage_rows<HD, LD>(Ks, kb, krs, 0, Smax, tid);
    stage_rows<HD, LD>(Vs, vb, krs, 0, Smax, tid);
    cp_async_commit();

    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    // rows g and g + 8 of this warp's 16; query i sees keys <= p + i
    const int qrow = q0 + warp * 16 + g;
    const uint16_t* qw = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

    for (int j = 0; j < ntiles; ++j) {
        const int buf = j & 1;
        if (j + 1 < ntiles) {
            stage_rows<HD, LD>(Ks + (buf ^ 1) * kBK * LD, kb, krs,
                               (j + 1) * kBK, Smax, tid);
            stage_rows<HD, LD>(Vs + (buf ^ 1) * kBK * LD, vb, krs,
                               (j + 1) * kBK, Smax, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const uint16_t* kt = Ks + buf * kBK * LD;
        const uint16_t* vt = Vs + buf * kBK * LD;

        // S = Q K^T for this warp's 16 rows and the tile's 64 keys
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, qw + kk * 16);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
                const int d = kk * 16 + ((lane >> 3) & 1) * 8;
                uint32_t bq[4];
                ldmatrix_x4(bq, kt + key * LD + d);
                mma_bf16(s[2 * np], a, bq[0], bq[1]);
                mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
            }
        }

        // mask, scale, online softmax over the tile (row halves r = 0, 1)
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = j * kBK + 8 * n + 2 * t + (e & 1);
                const int r = e >> 1;
                const bool vis = key <= p + qrow + 8 * r && key < Smax;
                s[n][e] = vis ? s[n][e] * scale : kNegInf;
                mx[r] = fmaxf(mx[r], s[n][e]);
            }
        }
        float corr[2], psum[2] = {0.f, 0.f}, mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            mu[r] = m_new == kNegInf ? 0.f : m_new;   // no key seen yet
            corr[r] = expf(m[r] - mu[r]);
            m[r] = m_new;
        }
        uint32_t pa[4][4];                // P as bf16 A fragments, 16 keys each
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            float pr[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                pr[e] = expf(s[n][e] - mu[e >> 1]);
                psum[e >> 1] += pr[e];
            }
            pa[n >> 1][2 * (n & 1)] = pack_bf16x2(pr[0], pr[1]);
            pa[n >> 1][2 * (n & 1) + 1] = pack_bf16x2(pr[2], pr[3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
            l[r] = l[r] * corr[r] + psum[r];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            o[n][0] *= corr[0];
            o[n][1] *= corr[0];
            o[n][2] *= corr[1];
            o[n][3] *= corr[1];
        }

        // O += P V
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
            for (int dp = 0; dp < HD / 16; ++dp) {
                uint32_t bv[4];
                ldmatrix_x4_trans(
                    bv, vt + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                            + 16 * dp + (lane >> 4) * 8);
                mma_bf16(o[2 * dp], pa[ks], bv[0], bv[1]);
                mma_bf16(o[2 * dp + 1], pa[ks], bv[2], bv[3]);
            }
        }
        __syncthreads();                 // this tile's buffers free for reuse
    }

    const float inv0 = 1.f / (l[0] == 0.f ? 1.f : l[0]);
    const float inv1 = 1.f / (l[1] == 0.f ? 1.f : l[1]);
    uint16_t* o0 = out + (((size_t)b * Sq + qrow) * H + h) * HD + 2 * t;
    uint16_t* o1 = o0 + (size_t)8 * H * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<uint32_t*>(o0 + 8 * n) =
            pack_bf16x2(o[n][0] * inv0, o[n][1] * inv0);
        *reinterpret_cast<uint32_t*>(o1 + 8 * n) =
            pack_bf16x2(o[n][2] * inv1, o[n][3] * inv1);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int Sq, int Smax, int H, int Hkv, float scale,
           cudaStream_t st) {
    const size_t smem = sizeof(uint16_t) * (size_t)(kBQ + 4 * kBK) * (HD + 8);
    cudaError_t e = cudaFuncSetAttribute(
        prefill_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(Sq / kBQ, B * H);
    prefill_attention_kernel<HD><<<grid, kThreads, smem, st>>>(
        (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
        (const int*)pos, (uint16_t*)out, Sq, Smax, H, Hkv, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Sq must be a
// multiple of 64; hd one of 64, 128, 256.
extern "C" int bigdl_prefill_attention(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int B, int Sq, int Smax,
                                       int H, int Hkv, int hd, float scale,
                                       void* stream) {
    if (B < 1 || Sq < kBQ || Sq % kBQ != 0 || Smax < 1 || Hkv < 1 ||
        H % Hkv != 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
#define BIGDL_PFA_CASE(HD) \
    case HD:               \
        return launch<HD>(q, k, v, pos, out, B, Sq, Smax, H, Hkv, scale, st);
    switch (hd) {
        BIGDL_PFA_CASE(64)
        BIGDL_PFA_CASE(128)
        BIGDL_PFA_CASE(256)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef BIGDL_PFA_CASE
}

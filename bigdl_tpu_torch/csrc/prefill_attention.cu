// B4: blockwise (flash) causal attention for prefill chunks, forward only.
//
// Replaces bigdl_tpu/ops/pallas/prefill_attention.py::_pfa_impl: the bf16
// body `_kernel` (with its float8_e5m2 input, upcast in-register) and the
// int8/int4 body `_kernel_scaled`. Sq new queries q [B, Sq, H, hd] against
// S_max cache rows k/v [B, S_max, Hkv, hd] (codes of a kv_storage.cuh kind;
// int8/int4 with f32 scales [B, S_max, Hkv]) at offset pos; key kj is
// visible to query qi iff kj <= pos[b] + qi. Online softmax in f32
// (running m, l, acc), the probabilities rounded to bf16 before the value
// product, and the l == 0 guard for rows with no visible key. Output bf16
// [B, Sq, H, hd].
//
// Bound on the H100: bytes at the engine's chunk shapes (Sq 128-256 against
// a cache of a few hundred to a few thousand rows): the visible K/V rows
// (codes and scales) and q/out move more bytes than the tensor cores need
// time for their flops, ~4 * hd flops per (query, visible key) pair.
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
//
// Narrow storage (fp8_e5m2, int8, int4): the code tiles of K and V and
// their 64 scales each are staged with cp.async into a double-buffered raw
// ring (the next tile in flight while this one computes), then dequantized
// in one pass (scaled4 of kv_storage.cuh, rounded to bf16 as it is packed:
// the bits of the TPU kernels' `_dequant_rows`) into a single bf16
// [64][LD] K and V tile, which the mma code reads as it reads a bf16
// cache's tiles.
#include "common.cuh"
#include "kv_storage.cuh"

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

// the same for narrow codes: rows [r0, r0 + 64) of RB bytes each (row
// stride `rs` bytes) into a packed [64][RB] byte tile; rows >= nrows as
// zeros
template <int RB>
__device__ __forceinline__ void stage_codes(uint8_t* dst,
                                            const uint8_t* __restrict__ src,
                                            size_t rs, int r0, int nrows,
                                            int tid) {
    constexpr int kPieces = RB / 16;     // 16-byte pieces per row
#pragma unroll
    for (int r = 0; r < 64 * kPieces / kThreads; ++r) {
        const int i = tid + r * kThreads;
        const int row = i / kPieces;
        const int c = 16 * (i % kPieces);
        const bool ok = r0 + row < nrows;
        cp_async16(dst + row * RB + c,
                   ok ? src + (size_t)(r0 + row) * rs + c : src, ok ? 16 : 0);
    }
}

// 4-byte cp.async (cache at all levels); src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(addr), "l"(src), "r"(src_bytes) : "memory");
}

// the 64 K scales (threads 0-63) and 64 V scales (64-127) of a tile, from
// planes with row stride `rs` floats; rows >= nrows as zeros
__device__ __forceinline__ void stage_scales(float* dst, const float* ks,
                                             const float* vs, size_t rs,
                                             int r0, int nrows, int tid) {
    const int row = tid & 63;
    const float* src = tid < 64 ? ks : vs;
    const bool ok = r0 + row < nrows;
    cp_async4(dst + tid, ok ? src + (size_t)(r0 + row) * rs : src,
              ok ? 4 : 0);
}

// a staged [64][RB] code tile (and its 64 scales) -> bf16 [64][LD] tile,
// 8 head dims a step
template <class KV, int HD, int LD>
__device__ __forceinline__ void dequant_tile(uint16_t* dst,
                                             const uint8_t* src,
                                             const float* scl, int tid) {
    constexpr int RB = (int)code_bytes<KV>(HD);
    constexpr int kChunks = HD / 8;
    using Word = typename KV::Word4;
#pragma unroll
    for (int r = 0; r < 64 * kChunks / kThreads; ++r) {
        const int i = tid + r * kThreads;
        const int row = i / kChunks;
        const int d = 8 * (i % kChunks);
        const Word* p = reinterpret_cast<const Word*>(
            src + row * RB + code_bytes<KV>(d));
        const float sc = KV::kScaled ? scl[row] : 1.f;
        float f[8];                      // rounded to bf16 by the packing
        scaled4<KV>(p[0], sc, f);
        scaled4<KV>(p[1], sc, f + 4);
        uint4 o;
        o.x = pack_bf16x2(f[0], f[1]);
        o.y = pack_bf16x2(f[2], f[3]);
        o.z = pack_bf16x2(f[4], f[5]);
        o.w = pack_bf16x2(f[6], f[7]);
        *reinterpret_cast<uint4*>(dst + row * LD + d) = o;
    }
}

// tile j of K and V into buffer `buf`: a bf16 cache's rows straight into
// the bf16 tiles Ks/Vs [2][kBK][LD]; narrow codes (and the scales of
// int8/int4) into the raw ring, [2][K, V][kBK][RB] bytes and
// [2][K, V][kBK] floats
template <int HD, int LD, class KV>
__device__ __forceinline__ void stage_kv(uint16_t* Ks, uint16_t* Vs,
                                         uint8_t* raw, float* rsc,
                                         const uint8_t* kb, const uint8_t* vb,
                                         const float* ksb, const float* vsb,
                                         size_t krs, int Hkv, int j, int buf,
                                         int Smax, int tid) {
    if constexpr (KV::kBits == 16) {
        stage_rows<HD, LD>(Ks + buf * kBK * LD,
                           reinterpret_cast<const uint16_t*>(kb), krs,
                           j * kBK, Smax, tid);
        stage_rows<HD, LD>(Vs + buf * kBK * LD,
                           reinterpret_cast<const uint16_t*>(vb), krs,
                           j * kBK, Smax, tid);
    } else {
        constexpr int RB = (int)code_bytes<KV>(HD);
        uint8_t* r = raw + buf * 2 * kBK * RB;
        stage_codes<RB>(r, kb, code_bytes<KV>(krs), j * kBK, Smax, tid);
        stage_codes<RB>(r + kBK * RB, vb, code_bytes<KV>(krs), j * kBK,
                        Smax, tid);
        if constexpr (KV::kScaled) {
            stage_scales(rsc + buf * 2 * kBK, ksb, vsb, Hkv, j * kBK, Smax,
                         tid);
        }
    }
}

// shared memory of one block: Q, the bf16 K/V tiles (two of each for a bf16
// cache, one for narrow codes) and, for narrow codes, the raw ring of code
// tiles and scales
template <int HD, class KV>
constexpr size_t smem_bytes() {
    constexpr size_t LD = HD + 8;
    constexpr bool kWide = KV::kBits == 16;
    const size_t tiles = sizeof(uint16_t) * LD
        * (kBQ + (kWide ? 4 : 2) * kBK);
    if (kWide) return tiles;
    return tiles + 2 * 2 * kBK * code_bytes<KV>(HD)
        + (KV::kScaled ? 2 * 2 * kBK * sizeof(float) : 0);
}

template <int HD, class KV>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const uint16_t* __restrict__ q,   // [B, Sq, H, HD]
                         const uint8_t* __restrict__ k,    // [B, Smax, Hkv,
                         const uint8_t* __restrict__ v,    //   HD] codes
                         const float* __restrict__ ks,     // [B, Smax, Hkv]
                         const float* __restrict__ vs,     //   (int8/int4)
                         const int* __restrict__ pos,      // [B]
                         uint16_t* __restrict__ out,       // [B, Sq, H, HD]
                         int Sq, int Smax, int H, int Hkv, float scale) {
    constexpr int LD = HD + 8;           // 16-byte aligned rows; ldmatrix
                                         // rows fall in distinct banks
    constexpr int NT = HD / 8;           // 8-wide head-dim tiles of O
    constexpr bool kWide = KV::kBits == 16;
    constexpr int RB = (int)code_bytes<KV>(HD);   // code bytes a head row
    extern __shared__ __align__(16) uint16_t smem[];
    uint16_t* Qs = smem;                 // [kBQ][LD]
    uint16_t* Ks = Qs + kBQ * LD;        // [2][kBK][LD] (narrow: [kBK][LD])
    uint16_t* Vs = Ks + (kWide ? 2 : 1) * kBK * LD;
    // narrow: [2 buffers][K, V][kBK][RB] codes, then [2][K, V][kBK] scales
    uint8_t* raw = reinterpret_cast<uint8_t*>(Vs + (kWide ? 2 : 1) * kBK * LD);
    float* rsc = reinterpret_cast<float*>(raw + 2 * 2 * kBK * RB);

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
    const size_t krs = (size_t)Hkv * HD;          // codes a cache row
    const size_t kbase = ((size_t)b * Smax * Hkv + kh) * HD;
    const uint8_t* kb = k + code_bytes<KV>(kbase);
    const uint8_t* vb = v + code_bytes<KV>(kbase);
    // the scale planes' column of this (slot, kv head); unused (and never
    // formed from a null plane) for the scale-free kinds
    const size_t sbase = (size_t)b * Smax * Hkv + kh;
    const float* ksb = KV::kScaled ? ks + sbase : nullptr;
    const float* vsb = KV::kScaled ? vs + sbase : nullptr;

    stage_rows<HD, LD>(Qs, q + ((size_t)b * Sq * H + h) * HD, (size_t)H * HD,
                       q0, Sq, tid);
    stage_kv<HD, LD, KV>(Ks, Vs, raw, rsc, kb, vb, ksb, vsb, krs, Hkv, 0, 0,
                         Smax, tid);
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
            stage_kv<HD, LD, KV>(Ks, Vs, raw, rsc, kb, vb, ksb, vsb, krs,
                                 Hkv, j + 1, buf ^ 1, Smax, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const uint16_t* kt = Ks + (kWide ? buf * kBK * LD : 0);
        const uint16_t* vt = Vs + (kWide ? buf * kBK * LD : 0);
        if constexpr (!kWide) {
            const uint8_t* r = raw + buf * 2 * kBK * RB;
            const float* sc = rsc + buf * 2 * kBK;
            dequant_tile<KV, HD, LD>(Ks, r, sc, tid);
            dequant_tile<KV, HD, LD>(Vs, r + kBK * RB, sc + kBK, tid);
            __syncthreads();
        }

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
        for (int ks_ = 0; ks_ < 4; ++ks_) {
#pragma unroll
            for (int dp = 0; dp < HD / 16; ++dp) {
                uint32_t bv[4];
                ldmatrix_x4_trans(
                    bv, vt + (16 * ks_ + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * LD
                            + 16 * dp + (lane >> 4) * 8);
                mma_bf16(o[2 * dp], pa[ks_], bv[0], bv[1]);
                mma_bf16(o[2 * dp + 1], pa[ks_], bv[2], bv[3]);
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

template <int HD, class KV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, int B, int Sq,
           int Smax, int H, int Hkv, float scale, cudaStream_t st) {
    const size_t smem = smem_bytes<HD, KV>();
    cudaError_t e = cudaFuncSetAttribute(
        prefill_attention_kernel<HD, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(Sq / kBQ, B * H);
    prefill_attention_kernel<HD, KV><<<grid, kThreads, smem, st>>>(
        (const uint16_t*)q, (const uint8_t*)k, (const uint8_t*)v,
        (const float*)ks, (const float*)vs, (const int*)pos, (uint16_t*)out,
        Sq, Smax, H, Hkv, scale);
    return (int)cudaGetLastError();
}

template <class KV>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* ks, const void* vs, const void* pos, void* out,
              int B, int Sq, int Smax, int H, int Hkv, float scale,
              cudaStream_t st) {
    switch (hd) {
        case 64:
            return launch<64, KV>(q, k, v, ks, vs, pos, out, B, Sq, Smax, H,
                                  Hkv, scale, st);
        case 128:
            return launch<128, KV>(q, k, v, ks, vs, pos, out, B, Sq, Smax, H,
                                   Hkv, scale, st);
        case 256:
            return launch<256, KV>(q, k, v, ks, vs, pos, out, B, Sq, Smax, H,
                                   Hkv, scale, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Sq must be a
// multiple of 64; hd one of 64, 128, 256; kind a KvKind (kv_storage.cuh),
// with ks/vs the scale planes of int8/int4 (may be null otherwise).
extern "C" int bigdl_prefill_attention(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* pos,
                                       void* out, int B, int Sq, int Smax,
                                       int H, int Hkv, int hd, int kind,
                                       float scale, void* stream) {
    const bool scaled = kind == KV_INT8 || kind == KV_INT4;
    if (B < 1 || Sq < kBQ || Sq % kBQ != 0 || Smax < 1 || Hkv < 1 ||
        H % Hkv != 0 || (scaled && (ks == nullptr || vs == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case KV_BF16:
            return launch_hd<Kv<KV_BF16>>(hd, q, k, v, ks, vs, pos, out, B,
                                          Sq, Smax, H, Hkv, scale, st);
        case KV_E5M2:
            return launch_hd<Kv<KV_E5M2>>(hd, q, k, v, ks, vs, pos, out, B,
                                          Sq, Smax, H, Hkv, scale, st);
        case KV_INT8:
            return launch_hd<Kv<KV_INT8>>(hd, q, k, v, ks, vs, pos, out, B,
                                          Sq, Smax, H, Hkv, scale, st);
        case KV_INT4:
            return launch_hd<Kv<KV_INT4>>(hd, q, k, v, ks, vs, pos, out, B,
                                          Sq, Smax, H, Hkv, scale, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// One-query (decode) causal GQA attention, split-S flash decoding: the body
// shared by B3 (slab cache, decode_attention.cu) and B5 (paged arena,
// paged_decode_attention.cu). The two differ only in where key j of slot b
// lives, which a `Rows` policy gives as a row index into the [rows, Hkv, hd]
// code planes (and the [rows, Hkv] scale planes):
//
//   struct Rows {
//       __device__ unsigned row(int b, int j);  // row of key j of slot b
//   };
//
// Each thread owns a copy of the policy (it may cache, as the paged one
// caches its current page id). row() is asked once per group of four
// keys, j % 4 == 0 and j < S, whose rows follow one another and all exist
// (a slot or a page holds a multiple of 4 rows; row indices fit in 32 bits,
// code offsets in 64). So all four rows are loaded unconditionally, keeping
// the eight loads of a group (and, for int8/int4, its eight scale loads) in
// flight together, and a key past pos is masked after the load. B5 does
// exactly B3's arithmetic on the same rows, and its output is bit-identical
// to B3's over the same rows laid out densely, for every storage kind.
//
// Storage: a `Kv` policy of kv_storage.cuh (bf16, fp8_e5m2, int8 or int4
// codes). A lane loads the codes of its 4 head dims in one load of 8, 4 or
// 2 bytes and turns them into f32 with dequant4 (int8/int4: times the row's
// f32 scale, rounded to bf16, the bits of the TPU kernels' `_dequant_rows`).
//
// Semantics: q [B, 1, H, hd] against S logical keys per slot; key j counts
// for slot b iff j <= pos[b]; scores scaled in f32, softmax in f32,
// probabilities rounded to bf16 before the value product (as the TPU
// kernels do), output bf16 [B, 1, H, hd].
//
// Bound on the H100: bytes. Each visible row serves only G = H/Hkv query
// rows, ~2G flops per K/V value, far under the ridge; the floor is the
// visible K/V codes and scales, sum_b min(pos[b] + 1, S) * Hkv *
// (hd * bytes_per_code + scale bytes) * 2 (K and V).
//
// Design: S is cut into 256-key spans, one block per (kv head, slot, span),
// so even a batch of 8 slots puts thousands of warps in flight, and spans
// past pos[b] exit before any load (past pos, only the rest of the last
// 4-key group is read, and weighs 0). Inside a
// block each of the four warps owns every fourth group of 4 keys and keeps a
// private online softmax (running max m, sum l, f32 accumulator) in
// registers: lanes hold 4 head dims each (one 8-byte load per K or V row),
// the G query rows of the group share every K/V row read, and no block
// barrier is ever taken. Each warp writes its partial (m, l, acc) to an f32
// workspace; a second pass merges the partials of a (slot, head) in a fixed
// order, so the result does not vary from run to run.
#pragma once

#include "common.cuh"
#include "kv_storage.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerStep = 4;          // keys a warp loads at once
constexpr int kSpan = 256;               // keys per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// G query rows per kv head, NS 128-wide slices of the head dim, codes of
// storage kind KV
template <int G, int NS, class KV, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const uint16_t* __restrict__ q,   // [B, H, hd]
                       const uint8_t* __restrict__ kc,   // [rows, Hkv, hd]
                       const uint8_t* __restrict__ vc,
                       const float* __restrict__ ksc,    // [rows, Hkv]
                       const float* __restrict__ vsc,    //   (int8/int4)
                       Rows rows,
                       const int* __restrict__ pos,      // [B]
                       float* __restrict__ ws_m,         // [B*H, P]
                       float* __restrict__ ws_l,         // [B*H, P]
                       float* __restrict__ ws_acc,       // [B*H, P, hd]
                       int S, int H, int Hkv, int hd, float scale) {
    using Word = typename KV::Word4;
    const int kh = blockIdx.x;
    const int b = blockIdx.y;
    const int span = blockIdx.z;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int P = gridDim.z * kWarps;
    const int part = span * kWarps + warp;

    float qr[G][NS][4];
    float acc[G][NS][4];
    float m[G], l[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        m[g] = -1e30f;
        l[g] = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int d = s * 128 + lane * 4;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                qr[g][s][e] = 0.f;
                acc[g][s][e] = 0.f;
            }
            if (d < hd) {
                dequant4<Kv<KV_BF16>>(
                    *reinterpret_cast<const uint2*>(
                        q + ((size_t)b * H + kh * G + g) * hd + d),
                    1.f, qr[g][s]);
            }
        }
    }

    // keys past S are never addressed: an idle slot's pos may exceed S
    const int nvalid = min(pos[b] + 1, S);
    const int j0 = span * kSpan;
    const int j1 = min(j0 + kSpan, nvalid);
    const unsigned rs = (unsigned)Hkv * (unsigned)hd;   // codes per row
    const size_t head = (size_t)kh * hd;

    for (int j = j0 + warp * kKeysPerStep; j < j1;
         j += kWarps * kKeysPerStep) {
        float kr[kKeysPerStep][NS][4], vr[kKeysPerStep][NS][4];
        // the group's eight row loads (and eight scale loads): addresses
        // first, then loads predicated on nothing but the lane's head-dim
        // range, so all are in flight together; dequantizing waits until
        // after them
        Word kw[kKeysPerStep][NS], vw[kKeysPerStep][NS];
        float ks[kKeysPerStep], vs[kKeysPerStep];
        const unsigned r0 = rows.row(b, j);           // keys j .. j + 3
        const size_t e0 = (size_t)r0 * rs + head;     // code index
#pragma unroll
        for (int kk = 0; kk < kKeysPerStep; ++kk) {
            const size_t e = e0 + (size_t)kk * rs;
            const uint8_t* kp = kc + code_bytes<KV>(e);
            const uint8_t* vp = vc + code_bytes<KV>(e);
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                const int d = s * 128 + lane * 4;
                kw[kk][s] = Word{};
                vw[kk][s] = Word{};
                if (d < hd) {
                    kw[kk][s] = *reinterpret_cast<const Word*>(
                        kp + code_bytes<KV>(d));
                    vw[kk][s] = *reinterpret_cast<const Word*>(
                        vp + code_bytes<KV>(d));
                }
            }
            ks[kk] = 1.f;
            vs[kk] = 1.f;
            if constexpr (KV::kScaled) {
                const size_t si = (size_t)(r0 + kk) * Hkv + kh;
                ks[kk] = ksc[si];
                vs[kk] = vsc[si];
            }
        }
#pragma unroll
        for (int kk = 0; kk < kKeysPerStep; ++kk) {
            // a masked key's V row (stale or null-page data, and its
            // scale) weighs 0
            const bool live = j + kk < j1;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                dequant4<KV>(kw[kk][s], ks[kk], kr[kk][s]);
                dequant4<KV>(live ? vw[kk][s] : Word{}, live ? vs[kk] : 0.f,
                             vr[kk][s]);
            }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float sc[kKeysPerStep];
            float mx = -1e30f;
#pragma unroll
            for (int kk = 0; kk < kKeysPerStep; ++kk) {
                float dot = 0.f;
#pragma unroll
                for (int s = 0; s < NS; ++s) {
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        dot += qr[g][s][e] * kr[kk][s][e];
                }
                dot = warp_sum(dot) * scale;
                sc[kk] = (j + kk < j1) ? dot : kNegInf;
                mx = fmaxf(mx, sc[kk]);
            }
            const float m_new = fmaxf(m[g], mx);
            const float corr = expf(m[g] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int kk = 0; kk < kKeysPerStep; ++kk) {
                const float p = expf(sc[kk] - m_new);
                psum += p;
                sc[kk] = round_bf16(p);
            }
            l[g] = l[g] * corr + psum;
            m[g] = m_new;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float a = acc[g][s][e] * corr;
#pragma unroll
                    for (int kk = 0; kk < kKeysPerStep; ++kk)
                        a += sc[kk] * vr[kk][s][e];
                    acc[g][s][e] = a;
                }
            }
        }
    }

#pragma unroll
    for (int g = 0; g < G; ++g) {
        const size_t idx = ((size_t)b * H + kh * G + g) * P + part;
        if (lane == 0) {
            ws_m[idx] = m[g];
            ws_l[idx] = l[g];
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int d = s * 128 + lane * 4;
            if (d < hd) {
                *reinterpret_cast<float4*>(ws_acc + idx * hd + d) =
                    make_float4(acc[g][s][0], acc[g][s][1], acc[g][s][2],
                                acc[g][s][3]);
            }
        }
    }
}

// merge the P partials of one (slot, head) in order; one thread per dim
__global__ void decode_attention_combine(const float* __restrict__ ws_m,
                                         const float* __restrict__ ws_l,
                                         const float* __restrict__ ws_acc,
                                         uint16_t* __restrict__ out,
                                         int P, int hd) {
    const int bh = blockIdx.x;
    const int d = threadIdx.x;
    const float* mp = ws_m + (size_t)bh * P;
    const float* lp = ws_l + (size_t)bh * P;
    float mx = -1e30f;
    for (int p = 0; p < P; ++p) mx = fmaxf(mx, mp[p]);
    float num = 0.f, den = 0.f;
    for (int p = 0; p < P; ++p) {
        const float w = expf(mp[p] - mx);
        den += lp[p] * w;
        num += ws_acc[((size_t)bh * P + p) * hd + d] * w;
    }
    out[(size_t)bh * hd + d] = f32_to_bf16(num / (den > 0.f ? den : 1.f));
}

// The split pass for one storage kind; false if no kernel is built for
// (G, NS).
template <class KV, class Rows>
bool launch_split(const Rows rows, const void* q, const void* k,
                  const void* v, const void* ks, const void* vs,
                  const void* pos, float* ws_m, float* ws_l, float* ws_acc,
                  int G, int NS, dim3 grid, int S, int H, int Hkv, int hd,
                  float scale, cudaStream_t st) {
#define BIGDL_DA_CASE(GV, NSV)                                              \
    if (G == GV && NS == NSV) {                                             \
        decode_attention_split<GV, NSV, KV, Rows><<<grid, kThreads, 0,      \
                                                    st>>>(                  \
            (const uint16_t*)q, (const uint8_t*)k, (const uint8_t*)v,       \
            (const float*)ks, (const float*)vs, rows, (const int*)pos,      \
            ws_m, ws_l, ws_acc, S, H, Hkv, hd, scale);                      \
        return true;                                                        \
    }
    BIGDL_DA_CASE(1, 1) BIGDL_DA_CASE(2, 1) BIGDL_DA_CASE(4, 1)
    BIGDL_DA_CASE(8, 1) BIGDL_DA_CASE(16, 1) BIGDL_DA_CASE(1, 2)
    BIGDL_DA_CASE(2, 2) BIGDL_DA_CASE(4, 2) BIGDL_DA_CASE(8, 2)
#undef BIGDL_DA_CASE
    return false;
}

// Both passes over S logical keys, codes of KvKind `kind` (ks/vs: the f32
// scale planes of int8/int4, else unused). Returns the cudaError_t of the
// launches (0 on success). ws holds B * H * P * (hd + 2) floats,
// P = ceil(S / 256) * 4 partials per head.
template <class Rows>
int launch_decode_attention(const Rows rows, const void* q, const void* k,
                            const void* v, const void* ks, const void* vs,
                            const void* pos, void* out, void* ws, int B,
                            int S, int H, int Hkv, int hd, int kind,
                            float scale, void* stream) {
    const bool scaled = kind == KV_INT8 || kind == KV_INT4;
    if (B < 1 || S < 1 || S % kKeysPerStep != 0 || Hkv < 1 ||
        H % Hkv != 0 || hd % 4 != 0 || hd > 256 || kind < KV_BF16 ||
        kind > KV_INT4 || (scaled && (ks == nullptr || vs == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    const int G = H / Hkv;
    const int NS = hd > 128 ? 2 : 1;
    const int nspan = (S + kSpan - 1) / kSpan;
    const int P = nspan * kWarps;
    float* ws_m = (float*)ws;
    float* ws_l = ws_m + (size_t)B * H * P;
    float* ws_acc = ws_l + (size_t)B * H * P;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(Hkv, B, nspan);
    bool built = false;
#define BIGDL_DA_KIND(KIND)                                                 \
    case KIND:                                                              \
        built = launch_split<Kv<KIND>, Rows>(rows, q, k, v, ks, vs, pos,    \
                                             ws_m, ws_l, ws_acc, G, NS,     \
                                             grid, S, H, Hkv, hd, scale,    \
                                             st);                           \
        break;
    switch (kind) {
        BIGDL_DA_KIND(KV_BF16)
        BIGDL_DA_KIND(KV_E5M2)
        BIGDL_DA_KIND(KV_INT8)
        BIGDL_DA_KIND(KV_INT4)
    }
#undef BIGDL_DA_KIND
    if (!built) return (int)cudaErrorInvalidValue;
    decode_attention_combine<<<B * H, hd, 0, st>>>(ws_m, ws_l, ws_acc,
                                                   (uint16_t*)out, P, hd);
    return (int)cudaGetLastError();
}

}  // namespace

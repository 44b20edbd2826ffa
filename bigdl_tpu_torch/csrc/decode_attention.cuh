// One-query (decode) causal GQA attention, split-S flash decoding: the body
// shared by B3 (slab cache, decode_attention.cu) and B5 (paged arena,
// paged_decode_attention.cu). The two differ only in where key j of slot b
// lives, which a `Rows` policy gives as an element offset:
//
//   struct Rows {
//       const uint16_t* k; const uint16_t* v;   // bf16 bits
//       int rs;                                 // elements per row
//       __device__ size_t offset(int b, int j); // row (b, j), head 0
//   };
//
// Each thread owns a copy of the policy (it may cache, as the paged one
// caches its current page id). offset() is asked once per group of four
// keys, j % 4 == 0 and j < S, whose rows lie rs apart and all exist (a
// slot or a page holds a multiple of 4 rows; row indices fit in 32 bits,
// element offsets in 64). So all four rows are loaded
// unconditionally, keeping the eight loads of a group in flight together,
// and a key past pos is masked after the load. B5 does exactly B3's
// arithmetic on the same rows, and its output is bit-identical to B3's
// over the same rows laid out densely.
//
// Semantics: q [B, 1, H, hd] against S logical keys per slot; key j counts
// for slot b iff j <= pos[b]; scores scaled in f32, softmax in f32,
// probabilities rounded to bf16 before the value product (as the TPU
// kernels do), output bf16 [B, 1, H, hd].
//
// Bound on the H100: bytes. Each visible row serves only G = H/Hkv query
// rows, ~2G flops per K/V byte, far under the bf16 ridge; the floor is the
// visible K/V bytes, sum_b min(pos[b] + 1, S) * Hkv * hd * 2 (K and V) * 2.
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

// four consecutive bf16 values (8 bytes) -> f32
__device__ __forceinline__ void unpack4(uint2 u, float* out) {
    out[0] = __uint_as_float(u.x << 16);
    out[1] = __uint_as_float(u.x & 0xffff0000u);
    out[2] = __uint_as_float(u.y << 16);
    out[3] = __uint_as_float(u.y & 0xffff0000u);
}

// G query rows per kv head, NS 128-wide slices of the head dim
template <int G, int NS, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const uint16_t* __restrict__ q,   // [B, H, hd]
                       Rows rows,
                       const int* __restrict__ pos,      // [B]
                       float* __restrict__ ws_m,         // [B*H, P]
                       float* __restrict__ ws_l,         // [B*H, P]
                       float* __restrict__ ws_acc,       // [B*H, P, hd]
                       int S, int H, int hd, float scale) {
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
                unpack4(*reinterpret_cast<const uint2*>(
                            q + ((size_t)b * H + kh * G + g) * hd + d),
                        qr[g][s]);
            }
        }
    }

    // keys past S are never addressed: an idle slot's pos may exceed S
    const int nvalid = min(pos[b] + 1, S);
    const int j0 = span * kSpan;
    const int j1 = min(j0 + kSpan, nvalid);
    const size_t head = (size_t)kh * hd;

    for (int j = j0 + warp * kKeysPerStep; j < j1;
         j += kWarps * kKeysPerStep) {
        float kr[kKeysPerStep][NS][4], vr[kKeysPerStep][NS][4];
        // the group's eight row loads: addresses first, then loads
        // predicated on nothing but the lane's head-dim range, so all are
        // in flight together; unpacking waits until after them
        uint2 kw[kKeysPerStep][NS], vw[kKeysPerStep][NS];
        const size_t r0 = rows.offset(b, j) + head;   // keys j .. j + 3
#pragma unroll
        for (int kk = 0; kk < kKeysPerStep; ++kk) {
            const uint16_t* kp = rows.k + r0 + (size_t)kk * rows.rs;
            const uint16_t* vp = rows.v + r0 + (size_t)kk * rows.rs;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                const int d = s * 128 + lane * 4;
                kw[kk][s] = make_uint2(0u, 0u);
                vw[kk][s] = make_uint2(0u, 0u);
                if (d < hd) {
                    kw[kk][s] = *reinterpret_cast<const uint2*>(kp + d);
                    vw[kk][s] = *reinterpret_cast<const uint2*>(vp + d);
                }
            }
        }
#pragma unroll
        for (int kk = 0; kk < kKeysPerStep; ++kk) {
            // a masked key's V row (stale or null-page data) weighs 0
            const bool live = j + kk < j1;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                unpack4(kw[kk][s], kr[kk][s]);
                unpack4(live ? vw[kk][s] : make_uint2(0u, 0u), vr[kk][s]);
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

// Both passes over S logical keys. Returns the cudaError_t of the launches
// (0 on success). ws holds B * H * P * (hd + 2) floats, P = ceil(S / 256)
// * 4 partials per head.
template <class Rows>
int launch_decode_attention(const Rows rows, const void* q, const void* pos,
                            void* out, void* ws, int B, int S, int H,
                            int Hkv, int hd, float scale, void* stream) {
    if (B < 1 || S < 1 || S % kKeysPerStep != 0 || Hkv < 1 ||
        H % Hkv != 0 || hd % 4 != 0 || hd > 256) {
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
#define BIGDL_DA_CASE(GV, NSV)                                              \
    if (G == GV && NS == NSV) {                                             \
        decode_attention_split<GV, NSV, Rows><<<grid, kThreads, 0, st>>>(   \
            (const uint16_t*)q, rows, (const int*)pos, ws_m, ws_l, ws_acc,  \
            S, H, hd, scale);                                               \
    } else
    BIGDL_DA_CASE(1, 1) BIGDL_DA_CASE(2, 1) BIGDL_DA_CASE(4, 1)
    BIGDL_DA_CASE(8, 1) BIGDL_DA_CASE(16, 1) BIGDL_DA_CASE(1, 2)
    BIGDL_DA_CASE(2, 2) BIGDL_DA_CASE(4, 2) BIGDL_DA_CASE(8, 2) {
        return (int)cudaErrorInvalidValue;
    }
#undef BIGDL_DA_CASE
    decode_attention_combine<<<B * H, hd, 0, st>>>(ws_m, ws_l, ws_acc,
                                                   (uint16_t*)out, P, hd);
    return (int)cudaGetLastError();
}

}  // namespace

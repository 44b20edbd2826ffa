// B3: one-query (decode) causal GQA attention over a slab KV cache.
//
// Replaces bigdl_tpu/ops/pallas/decode_attention.py::decode_attention_pallas
// (bf16 bodies `_kernel` and `_kernel_blocked`): q [B, 1, H, hd] against
// k/v [B, S, Hkv, hd]; key j counts for slot b iff j <= pos[b]; scores
// scaled in f32, softmax in f32, probabilities rounded to bf16 before the
// value product (as the TPU kernel does), output bf16 [B, 1, H, hd].
//
// Bound on the H100: bytes. Each visible cache row serves only G = H/Hkv
// query rows, ~2G flops per K/V byte, far under the bf16 ridge; the floor
// is the visible K/V bytes, B * (pos + 1) * Hkv * hd * 2 (K and V) * 2
// bytes per layer.
//
// Design (flash-decoding): the TPU kernel walks S in order inside one grid
// cell; here S is cut into 256-key spans, one block per (kv head, slot,
// span), so even a batch of 8 slots puts thousands of warps in flight, and
// spans past pos[b] exit at once (masked rows are never read). Inside a
// block each of the four warps owns every fourth group of 4 keys and keeps
// a private online softmax (running max m, sum l, f32 accumulator) in
// registers: lanes hold 4 head dims each (one 8-byte load per K or V row),
// the G query rows of the group share every K/V row read, and no block
// barrier is ever taken. Each warp writes its partial (m, l, acc) to an f32
// workspace; a second pass merges the partials of a (slot, head) in a fixed
// order, so the result does not vary from run to run.
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
__device__ __forceinline__ void load4(const uint16_t* p, float* out) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(u.x << 16);
    out[1] = __uint_as_float(u.x & 0xffff0000u);
    out[2] = __uint_as_float(u.y << 16);
    out[3] = __uint_as_float(u.y & 0xffff0000u);
}

// G query rows per kv head, NS 128-wide slices of the head dim
template <int G, int NS>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const uint16_t* __restrict__ q,   // [B, H, hd]
                       const uint16_t* __restrict__ k,   // [B, S, Hkv, hd]
                       const uint16_t* __restrict__ v,
                       const int* __restrict__ pos,      // [B]
                       float* __restrict__ ws_m,         // [B*H, P]
                       float* __restrict__ ws_l,         // [B*H, P]
                       float* __restrict__ ws_acc,       // [B*H, P, hd]
                       int S, int H, int Hkv, int hd, float scale) {
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
            if (d < hd) load4(q + ((size_t)b * H + kh * G + g) * hd + d,
                              qr[g][s]);
        }
    }

    const int nvalid = min(pos[b] + 1, S);
    const int j0 = span * kSpan;
    const int j1 = min(j0 + kSpan, nvalid);
    const size_t rs = (size_t)Hkv * hd;
    const uint16_t* kb = k + (size_t)b * S * rs + (size_t)kh * hd;
    const uint16_t* vb = v + (size_t)b * S * rs + (size_t)kh * hd;

    for (int j = j0 + warp * kKeysPerStep; j < j1;
         j += kWarps * kKeysPerStep) {
        float kr[kKeysPerStep][NS][4], vr[kKeysPerStep][NS][4];
#pragma unroll
        for (int kk = 0; kk < kKeysPerStep; ++kk) {
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                const int d = s * 128 + lane * 4;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    kr[kk][s][e] = 0.f;
                    vr[kk][s][e] = 0.f;
                }
                if (j + kk < j1 && d < hd) {
                    load4(kb + (size_t)(j + kk) * rs + d, kr[kk][s]);
                    load4(vb + (size_t)(j + kk) * rs + d, vr[kk][s]);
                }
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

template <int G, int NS>
void launch_split(dim3 grid, cudaStream_t st, const void* q, const void* k,
                  const void* v, const void* pos, float* ws_m, float* ws_l,
                  float* ws_acc, int S, int H, int Hkv, int hd, float scale) {
    decode_attention_split<G, NS><<<grid, kThreads, 0, st>>>(
        (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
        (const int*)pos, ws_m, ws_l, ws_acc, S, H, Hkv, hd, scale);
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). ws holds
// B * H * P * (hd + 2) floats, P = ceil(S / 256) * 4 partials per head.
extern "C" int bigdl_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* out, void* ws, int B, int S,
                                      int H, int Hkv, int hd, float scale,
                                      void* stream) {
    if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || hd % 4 != 0 ||
        hd > 256) {
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
    dim3 grid(Hkv, B, nspan);
#define BIGDL_DA_CASE(GV, NSV)                                              \
    if (G == GV && NS == NSV) {                                             \
        launch_split<GV, NSV>(grid, st, q, k, v, pos, ws_m, ws_l, ws_acc, S, \
                              H, Hkv, hd, scale);                           \
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

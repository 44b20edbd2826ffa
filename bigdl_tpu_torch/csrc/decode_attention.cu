// B3: one-query (decode) causal GQA attention over a slab KV cache.
//
// Replaces bigdl_tpu/ops/pallas/decode_attention.py::decode_attention_pallas
// (bf16 bodies `_kernel` and `_kernel_blocked`): q [B, 1, H, hd] against
// k/v [B, S, Hkv, hd]; key j counts for slot b iff j <= pos[b].
//
// The TPU kernel walks S in order inside one grid cell; here S is split
// across blocks (flash decoding). Semantics, bound and design are those of
// the shared body in decode_attention.cuh; this file gives it the slab's
// row address, row j of slot b at ((b * S + j) * Hkv + head) * hd.
#include "decode_attention.cuh"

namespace {

struct SlabRows {
    const uint16_t* k;
    const uint16_t* v;
    int rs;           // elements per cache row, Hkv * hd
    int S;

    __device__ __forceinline__ size_t offset(int b, int j) const {
        return (size_t)(unsigned)(b * S + j) * (unsigned)rs;
    }
};

}  // namespace

// Returns the cudaError_t of the launches (0 on success). ws holds
// B * H * P * (hd + 2) floats, P = ceil(S / 256) * 4 partials per head.
extern "C" int bigdl_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* out, void* ws, int B, int S,
                                      int H, int Hkv, int hd, float scale,
                                      void* stream) {
    const SlabRows rows{(const uint16_t*)k, (const uint16_t*)v, Hkv * hd,
                        S};
    return launch_decode_attention(rows, q, pos, out, ws, B, S, H, Hkv, hd,
                                   scale, stream);
}

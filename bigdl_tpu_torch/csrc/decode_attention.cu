// B3: one-query (decode) causal GQA attention over a slab KV cache.
//
// Replaces bigdl_tpu/ops/pallas/decode_attention.py::decode_attention_pallas:
// the bf16 bodies `_kernel` and `_kernel_blocked` (with their float8_e5m2
// input, upcast in-register) and the int8/int4 bodies `_kernel_scaled` and
// `_kernel_blocked_scaled`. q [B, 1, H, hd] against k/v [B, S, Hkv, hd]
// codes (int8/int4 with f32 scales [B, S, Hkv]); key j counts for slot b
// iff j <= pos[b].
//
// The TPU kernel walks S in order inside one grid cell; here S is split
// across blocks (flash decoding). Semantics, storage kinds, bound and
// design are those of the shared body in decode_attention.cuh; this file
// gives it the slab's row index, row j of slot b at b * S + j.
#include "decode_attention.cuh"

namespace {

struct SlabRows {
    int S;

    __device__ __forceinline__ unsigned row(int b, int j) const {
        return (unsigned)(b * S + j);
    }
};

}  // namespace

// Returns the cudaError_t of the launches (0 on success). kind is a KvKind
// (kv_storage.cuh); ks/vs are the scale planes of int8/int4 (may be null
// otherwise). ws holds B * H * P * (hd + 2) floats, P = ceil(S / 256) * 4
// partials per head.
extern "C" int bigdl_decode_attention(const void* q, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, const void* pos,
                                      void* out, void* ws, int B, int S,
                                      int H, int Hkv, int hd, int kind,
                                      float scale, void* stream) {
    return launch_decode_attention(SlabRows{S}, q, k, v, ks, vs, pos, out,
                                   ws, B, S, H, Hkv, hd, kind, scale,
                                   stream);
}

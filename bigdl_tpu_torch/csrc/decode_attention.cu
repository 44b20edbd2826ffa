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
// across blocks (flash decoding) and merged in the same launch. Semantics,
// storage kinds, bound and design are those of the shared body in
// decode_attention.cuh; this file gives it the slab's row index, row j of
// slot b at b * S + j.
#include "decode_attention.cuh"

namespace {

struct SlabRows {
    int S;

    __device__ __forceinline__ unsigned row(int b, int j) const {
        return (unsigned)(b * S + j);
    }
};

}  // namespace

// Returns the cudaError_t of the launch (0 on success) or an error code of
// csrc/tma.cuh (a tensor map that did not encode). kind is a KvKind
// (kv_storage.cuh); ks/vs are the scale planes of int8/int4 (may be null
// otherwise). span: the plan's keys a block at a full cache (a multiple of
// 16), giving nspan = ceil(S / span) blocks a (slot, kv head), over which
// each slot's visible keys are cut evenly; with nspan > 1, ws holds
// B * H * nspan * (hd + 2) floats and tickets B * Hkv zeros, which the
// launch leaves zero.
extern "C" int bigdl_decode_attention(const void* q, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, const void* pos,
                                      void* out, void* ws, void* tickets,
                                      int B, int S, int H, int Hkv, int hd,
                                      int kind, int span, float scale,
                                      void* stream) {
    return dattn::launch_decode_attention(SlabRows{S}, (long long)B * S, q,
                                          k, v, ks, vs, pos, out, ws, tickets,
                                          B, S, H, Hkv, hd, kind, span, scale,
                                          stream);
}

// Resident blocks per SM of the body a launch of (kind, hd, group = H /
// Hkv) takes (the planner's occupancy; B5's plan reads it too, so both
// kernels cut the keys alike); -1 if none is built.
extern "C" int bigdl_decode_attention_blocks_per_sm(int kind, int hd,
                                                    int group) {
    return dattn::decode_attention_blocks(SlabRows{0}, kind, hd, group);
}

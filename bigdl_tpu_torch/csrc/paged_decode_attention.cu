// B5: one-query (decode) causal GQA attention over a paged KV arena.
//
// Replaces bigdl_tpu/ops/pallas/paged_decode_attention.py::
// paged_decode_attention_pallas: the body `_paged_kernel` (bf16 or
// float8_e5m2 pages) and `_paged_kernel_scaled` (int8/int4 pages with f32
// scale planes [P, ps, Hkv]). q [B, 1, H, hd] against one layer's arena k/v
// [P, ps, Hkv, hd] through block_tables [B, NP] int32 (0 = the null page);
// row r of table entry t is logical key t * ps + r, which counts for slot b
// iff it is <= pos[b].
//
// The TPU kernel DMAs page bt[b, t] into VMEM through a scalar-prefetched
// index map, one page per sequential grid step. Hopper has no scalar
// prefetch and its blocks run in parallel: here each warp of B3's body
// (decode_attention.cuh) reads the page id of each 16-key tile it stages
// from the table (a tile never crosses a page: ps is a multiple of 16) and
// asks TMA for the tile's rows at arena row bt[b, j / ps] * ps + j % ps
// (the scales by cp.async from the same rows). Everything else is B3's
// body and plan, so B5 is bit-identical to B3 over the same rows laid out
// densely, for every storage kind (the promise of bigdl_tpu/ops/paged.py:
// paged decode equals slab decode byte for byte).
//
// Bound on the H100: bytes, the visible K/V rows' codes and scales,
// sum_b min(pos[b] + 1, NP * ps) * Hkv * (hd * bytes_per_code + scale
// bytes) * 2, plus q, out and the table. The walk stops at
// min(pos + 1, NP * ps): an idle slot (all-null table row, pos past
// NP * ps) never indexes past column NP - 1; rows past pos inside a tile
// (the tail of its last page, or the null page's) arrive with the box and
// weigh nothing (their V rows are zeroed, their scales copied as zeros).
#include "decode_attention.cuh"

namespace {

struct PagedRows {
    const int* bt;    // [B, NP]
    int np;
    int ps;           // a multiple of 16 (the gate asks for 128)

    __device__ __forceinline__ unsigned row(int b, int j) const {
        const int l = j / ps;
        return (unsigned)(__ldg(bt + b * np + l) * ps + (j - l * ps));
    }
};

}  // namespace

// Returns the cudaError_t of the launch (0 on success) or an error code of
// csrc/tma.cuh (a tensor map that did not encode). kind is a KvKind
// (kv_storage.cuh); ks/vs are the arena's scale planes for int8/int4 (may
// be null otherwise). span and the workspace as bigdl_decode_attention's
// over S = NP * ps logical keys (sized from the table, not the arena).
extern "C" int bigdl_paged_decode_attention(const void* q, const void* k,
                                            const void* v, const void* ks,
                                            const void* vs, const void* bt,
                                            const void* pos, void* out,
                                            void* ws, void* tickets, int B,
                                            int P, int ps, int NP, int H,
                                            int Hkv, int hd, int kind,
                                            int span, float scale,
                                            void* stream) {
    if (P < 1 || ps < 16 || ps % 16 != 0 || NP < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const PagedRows rows{(const int*)bt, NP, ps};
    return dattn::launch_decode_attention(rows, (long long)P * ps, q, k, v,
                                          ks, vs, pos, out, ws, tickets, B,
                                          NP * ps, H, Hkv, hd, kind, span,
                                          scale, stream);
}

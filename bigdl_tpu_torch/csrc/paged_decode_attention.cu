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
// prefetch and its blocks run in parallel: here each block of B3's split-S
// pass (decode_attention.cuh; 256 logical keys, two pages at ps = 128, part
// of one at ps >= 256) loads its own page ids from the table and reads key
// j from arena row bt[b, j / ps] * ps + j % ps (codes and scales). A thread
// keeps its current page id in a register and reads the table again only
// when its keys cross into the next page (once per ps keys, not per key).
// Everything else is B3's body, so B5 is bit-identical to B3 over the same
// rows laid out densely, for every storage kind (the promise of
// bigdl_tpu/ops/paged.py: paged decode equals slab decode byte for byte).
//
// Bound on the H100: bytes, the visible K/V rows' codes and scales,
// sum_b min(pos[b] + 1, NP * ps) * Hkv * (hd * bytes_per_code + scale
// bytes) * 2, plus q, out and the table. The walk stops at
// min(pos + 1, NP * ps): an idle slot (all-null table row, pos past
// NP * ps) never indexes past column NP - 1, and the null page's garbage
// rows are read only where the mask covers them.
#include "decode_attention.cuh"

namespace {

struct PagedRows {
    const int* bt;    // [B, NP]
    int np;
    int ps;           // a multiple of 4 (the gate asks for 128)
    int lp;           // this thread's cached logical page (-1: none)
    int base;         // its first row, bt[b, lp] * ps

    __device__ __forceinline__ unsigned row(int b, int j) {
        const int l = j / ps;
        if (l != lp) {              // warp-uniform: one read per page
            lp = l;
            base = __ldg(bt + b * np + l) * ps;
        }
        return (unsigned)(base + j - l * ps);
    }
};

}  // namespace

// Returns the cudaError_t of the launches (0 on success). kind is a KvKind
// (kv_storage.cuh); ks/vs are the arena's scale planes for int8/int4 (may
// be null otherwise). ws holds B * H * P * (hd + 2) floats,
// P = ceil(NP * ps / 256) * 4 partials per head (sized from the table, not
// the arena).
extern "C" int bigdl_paged_decode_attention(const void* q, const void* k,
                                            const void* v, const void* ks,
                                            const void* vs, const void* bt,
                                            const void* pos, void* out,
                                            void* ws, int B, int P, int ps,
                                            int NP, int H, int Hkv, int hd,
                                            int kind, float scale,
                                            void* stream) {
    if (P < 1 || ps < 4 || ps % 4 != 0 || NP < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const PagedRows rows{(const int*)bt, NP, ps, -1, 0};
    return launch_decode_attention(rows, q, k, v, ks, vs, pos, out, ws, B,
                                   NP * ps, H, Hkv, hd, kind, scale, stream);
}

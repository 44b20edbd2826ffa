// One-query (decode) causal GQA attention in one launch: the body shared
// by B3 (slab cache, decode_attention.cu) and B5 (paged arena,
// paged_decode_attention.cu). The two differ only in where key j of slot b
// lives, which a `Rows` policy gives as a row index into the [rows, Hkv,
// hd] code planes (and the [rows, Hkv] scale planes):
//
//   struct Rows {
//       __device__ unsigned row(int b, int j) const;  // row of key j
//   };
//
// row() is asked once per 16-key tile (j % 16 == 0); the tile's rows
// follow one another (a page holds a multiple of 16 rows). B5 does exactly
// B3's arithmetic on the same rows with the same plan, so its output is
// bit-identical to B3's over the same rows laid out densely, for every
// storage kind.
//
// Semantics: q [B, 1, H, hd] against S logical keys per slot; key j counts
// for slot b iff j <= pos[b]; scores scaled in f32, softmax in f32,
// probabilities rounded to bf16 before the value product, output bf16
// [B, 1, H, hd]. Storage: a kind of kv_storage.cuh. The scaled kinds fold
// their f32 scales out of the products: score = scale * k_scale[j] *
// (q . c_j) over the exact codes, and the probability is multiplied by
// v_scale[j] before its bf16 rounding, where the TPU kernels'
// `_dequant_rows` rounds each c * scale to bf16 first (the difference is
// one bf16 rounding per term, inside the 2e-2 the tests hold both to).
//
// Bound on the H100: bytes. Each visible row serves only G = H/Hkv query
// rows, ~4G flops per K/V code, far under the ridge; the floor is the
// visible K/V codes and scales, sum_b min(pos[b] + 1, S) * Hkv *
// (hd * bytes_per_code + scale bytes) * 2 (K and V).
//
// Design:
// - One block of 4 warps per (kv head, slot, span of keys). The host's
//   planner (ops/cuda/decode_attention.py::plan_spans) picks nspan, the
//   blocks a (slot, kv head): the fewest that reach every SM (a block
//   costs ~4 us beyond its keys: positions, partials, merge); each slot's
//   visible keys min(pos + 1, S) are then cut evenly over its nspan
//   blocks in whole tiles, so a long slot's blocks do no more than a
//   short one's share of its keys (the positions live on the card; the
//   host never reads them). A block past the visible keys exits at once.
// - Each warp streams its own 16-key tiles of the span (tiles w, w + 4,
//   ...) through a private shared-memory ring of 2-8 stages (~16 KB: 2 KB
//   stages for int4, 4 KB for int8/fp8, 8 KB for bf16 at hd 128): lane 0
//   arms a stage's mbarrier and asks TMA for the tile's K and V, each one
//   box of 16 rows of one kv head (the plane viewed as [rows, Hkv * row
//   bytes]; bf16 rows past 128 bytes take two boxes), laid out with the
//   128/64/32-byte swizzle so the rows a quarter-warp reads sit on other
//   banks; the lanes add the tile's 16 K and 16 V scales by 4-byte
//   cp.async (zeros past the span's end, src-size 0). V rows past the
//   span's end are zeroed once they land, so a masked key's V row and
//   scale weigh exactly 0. One copy a tile, not 4-16 16-byte cp.async a
//   row, cut the loads-only time of int4 rows by a fifth. Warp barriers
//   only: up to ~14 KB a warp and ~170 KB an SM in flight, against
//   Little's ~25 KB (3.35 TB/s x ~1 us / 132 SMs).
// - Both products on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//   accumulate), transposed so the tile's 16 keys and 16 of the head dims
//   fill the m16 side and the group's query rows (8 a tile: G <= 8 takes
//   one n8 tile, G <= 16 two) the n8 side: S^T = K Q^T with K as A, then
//   O^T += V^T P^T with V^T as A (hd/16 mma a product, half the count of
//   the q-as-A arrangement, whose 16 rows idle 15 at G = 1). P moves from
//   S^T's C layout to the B layout by four shuffles and two prmt. The
//   order of head dims inside a k step is free, so each kind pairs its
//   codes where a shift leaves them (kv_pair_* of kv_storage.cuh) and q is
//   loaded in the same order; V pairs two keys' codes of one dim with one
//   prmt. The score's k steps sum in two chains, and the accumulators are
//   rescaled only when some query's running max moved (a warp vote).
// - The warps' partials (m, l, acc) merge in warp order in shared memory.
//   A slot whose visible keys span one block is written by it directly.
//   Otherwise each live span writes its partial to the f32 workspace and
//   takes a ticket for its (slot, kv head); the last to arrive merges the
//   live spans in span order (the bits do not depend on arrival order),
//   writes bf16 out and resets the ticket. One launch, no second kernel,
//   no memset, no host sync, no allocation. Tickets assume one stream.
//
// Probe builds (tools/bench_attention.py --probe; their output is not the
// attention, only their time is read): -DBIGDL_DA_PROBE=1 stages the
// tiles and does no arithmetic on them, =2 does the arithmetic on
// whatever the ring holds and copies nothing, =3 takes no tile at all
// (the launch, the q loads and the merges alone).

#pragma once

#include "common.cuh"
#include "kv_storage.cuh"
#include "tma.cuh"

#ifndef BIGDL_DA_PROBE
#define BIGDL_DA_PROBE 0
#endif

namespace dattn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;                // keys a warp stages and multiplies
constexpr int kRingBytes = 16384;        // target size of a warp's ring
constexpr int kMaxSpans = 64;            // blocks a (slot, kv head), at most
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int clampi(int x, int lo, int hi) {
    return x < lo ? lo : x > hi ? hi : x;
}

// the layout of one (storage kind, head dim) instantiation
template <int KIND, int HD>
struct Geo {
    static constexpr bool kScaled = Kv<KIND>::kScaled;
    static constexpr int kRow = HD * Kv<KIND>::kBits / 8;  // bytes a row
    // a K or V tile: kBoxes TMA boxes of 16 rows of kW bytes, each laid
    // out with the kW-byte swizzle (kW the largest of 128, 64, 32 dividing
    // a row), so the rows a quarter-warp reads sit on other banks
    static constexpr int kW = kRow % 128 == 0 ? 128 : kRow % 64 == 0 ? 64
                                                                     : 32;
    static constexpr int kBoxes = kRow / kW;
    static constexpr int kTileBytes = kTile * kRow;
    // a stage: the K tile, then the V tile (a multiple of 1024 bytes, the
    // swizzle's alignment); the stages' 16 K and 16 V scales follow them
    static constexpr int kStage = 2 * kTileBytes;
    static constexpr int kScales = kScaled ? 2 * kTile * 4 : 0;
    static constexpr int kStages =
        clampi(kRingBytes / (kStage + kScales), 2, 8);
    static constexpr int kRing =
        (kStages * (kStage + kScales) + 1023) / 1024 * 1024;
    static constexpr int kKSteps = HD / 16;   // k steps of K Q^T
    static constexpr int kMT = HD / 16;       // m16 tiles of V^T P^T
    static constexpr int kKWords = kRow / 16; // a lane's K slice: HD/4 codes
    static constexpr int kVWords = kRow / 32; // a lane's V slice: HD/8 codes
};

// dynamic shared memory of a block: the warps' rings, reused for the
// warps' partials after the loop, then for the last block's span weights
// (16 rows, kMaxSpans spans); and 1024 bytes of slack to align it for the
// swizzle
template <int KIND, int HD, bool R16>
__host__ __device__ constexpr int smem_bytes() {
    constexpr int ring = Geo<KIND, HD>::kRing * kWarps;
    constexpr int parts = kWarps * (2 * 16 + (R16 ? 16 : 8) * HD) * 4;
    constexpr int weights = (2 * 16 * kMaxSpans + 16) * 4;
    return 1024 + (ring > parts ? (ring > weights ? ring : weights)
                                : (parts > weights ? parts : weights));
}

struct Args {
    const uint16_t* q;       // [B, H, hd] bf16
    const uint8_t* k;        // [rows, Hkv, hd] codes
    const uint8_t* v;
    const float* ks;         // [rows, Hkv] (int8/int4)
    const float* vs;
    const int* pos;          // [B]
    uint16_t* out;           // [B, H, hd] bf16
    float* ws;               // m [B*H, nspan], l [B*H, nspan], acc [.., hd]
    unsigned* tickets;       // [B * Hkv], zero between launches
    int S, H, Hkv, nspan;    // nspan: blocks a (slot, kv head)
    float scale_log2;        // scale * log2(e): scores in base 2
};

// NW words of row r of a K or V tile from byte x0 on (tma.cuh)
template <class Ge, int NW>
__device__ __forceinline__ void lds_words(uint32_t (&w)[NW], const uint8_t* t,
                                          int r, int x0) {
    lds_swizzled<Ge::kW, kTile>(w, t, r, x0);
}

// max / sum over the 8 lanes of one mma column (lanes t, t + 4, ..)
__device__ __forceinline__ float col_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

__device__ __forceinline__ float col_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ void fma4(float4& acc, const float4 v, float f) {
    acc.x += v.x * f;
    acc.y += v.y * f;
    acc.z += v.z * f;
    acc.w += v.w * f;
}

// four dims of a row of out: num / den in bf16 (a row that saw no key is 0)
__device__ __forceinline__ void store_out(uint16_t* out, const float4 num,
                                          float den) {
    const float d = den > 0.f ? den : 1.f;
    *reinterpret_cast<uint2*>(out) = make_uint2(
        pack_bf16x2(num.x / d, num.y / d), pack_bf16x2(num.z / d, num.w / d));
}

// KIND: storage kind; HD: head dim (64, 128, 192, 256); R16: G > 8 (a
// second n8 tile of query rows)
template <int KIND, int HD, bool R16, class Rows>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 3 : 1)
decode_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const Args a, const Rows rows) {
    using Ge = Geo<KIND, HD>;
    constexpr int NQ = R16 ? 2 : 1;      // n8 tiles of queries
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    __shared__ bool is_last;
    __shared__ __align__(8) uint64_t bars[kWarps][8];   // a ring's stages
    uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);

    const int b = blockIdx.y;
    const int sp = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gi = lane >> 2;            // mma group: row / key / dim slot
    const int ti = lane & 3;             // thread in group
    const int G = a.H / a.Hkv;
    const int kh = blockIdx.x;

    // keys past S are never addressed: an idle slot's pos may exceed S.
    // The slot's visible keys are cut evenly over the launch's nspan
    // blocks in whole tiles; a block past them exits.
    const int nvalid = max(0, min(a.pos[b] + 1, a.S));
    const int span =
        max(kTile, ((nvalid + a.nspan - 1) / a.nspan + kTile - 1) / kTile *
                       kTile);
    const int live = max(1, (nvalid + span - 1) / span);
    if (sp >= live) return;
    const int j0 = sp * span;
    const int j1 = min(j0 + span, nvalid);

    // this warp's tiles of the span: w, w + 4, ...
    const int ntiles = j1 > j0 ? (j1 - j0 + kTile - 1) / kTile : 0;
    const int mine = BIGDL_DA_PROBE == 3 || ntiles <= warp
                         ? 0
                         : (ntiles - warp + kWarps - 1) / kWarps;
    uint8_t* ring = smem + warp * Ge::kRing;

    // the warp's ring: one barrier a stage, which lane 0 arms with the
    // tile's K and V boxes (TMA: 16 rows of one kv head); the scales come
    // by 4-byte cp.async (zeros past the span)
    if (lane == 0) {
        for (int i = 0; i < Ge::kStages; ++i)
            mbar_init(smem_u32(&bars[warp][i]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();

    auto load = [&](int i) {
        if (BIGDL_DA_PROBE == 2) return;
        const int jt = j0 + (warp + i * kWarps) * kTile;
        uint8_t* st = ring + (i % Ge::kStages) * Ge::kStage;
        const size_t r0 = rows.row(b, jt);
        if (lane == 0) {
            const uint32_t bar = smem_u32(&bars[warp][i % Ge::kStages]);
            mbar_expect_tx(bar, Ge::kStage);
            mbar_arrive(bar);
#pragma unroll
            for (int j = 0; j < Ge::kBoxes; ++j) {
                const int x = kh * Ge::kRow + j * Ge::kW;
                const int off = j * kTile * Ge::kW;
                tma_2d(smem_u32(st + off), &kmap, bar, x, (int)r0);
                tma_2d(smem_u32(st + Ge::kTileBytes + off), &vmap, bar, x,
                       (int)r0);
            }
        }
        if constexpr (Ge::kScaled) {
            uint8_t* scl = ring + Ge::kStages * Ge::kStage +
                           (i % Ge::kStages) * Ge::kScales;
            const int key = lane & 15;
            const bool ok = jt + key < j1;
            const float* plane = lane < 16 ? a.ks : a.vs;
            cp_async4(scl + 4 * lane,
                      ok ? plane + (r0 + key) * a.Hkv + kh : plane,
                      ok ? 4 : 0);
        }
    };

#pragma unroll
    for (int i = 0; i < Ge::kStages - 1; ++i) {
        if (i < mine) load(i);
        cp_async_commit();
    }
    // q as the B operand, n8 tile j of queries 8 j .. 8 j + 7: query
    // 8 j + gi (zero past G), this lane's dims in kslot_dim order
    uint32_t qb[NQ][Ge::kKSteps][2];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        const int g = 8 * j + gi;
        const bool ok = g < G;
        const uint16_t* qp = a.q +
                             ((size_t)b * a.H + kh * G + (ok ? g : 0)) * HD +
                             ti * (HD / 4);
#pragma unroll
        for (int s = 0; s < Ge::kKSteps; ++s) {
            uint16_t e[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                e[i] = ok ? qp[kslot_dim<KIND>(s, i)] : (uint16_t)0;
            qb[j][s][0] = (uint32_t)e[0] | ((uint32_t)e[1] << 16);
            qb[j][s][1] = (uint32_t)e[2] | ((uint32_t)e[3] << 16);
        }
    }

    // O^T in the C layout of m16 tile i of dims (rows gi and gi + 8: dims
    // gi * HD/8 + i and gi * HD/8 + HD/16 + i) by n8 tile j of queries
    // (columns 2 ti, 2 ti + 1); a lane keeps the running max and sum of
    // its two queries a tile j
    float acc[NQ][Ge::kMT][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < Ge::kMT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;
    float m[NQ][2], l[NQ][2];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            m[j][c] = -1e30f;
            l[j][c] = 0.f;
        }

    for (int i = 0; i < mine; ++i) {
        if (i + Ge::kStages - 1 < mine) load(i + Ge::kStages - 1);
        cp_async_commit();
        cp_async_wait<Ge::kStages - 1>();    // tile i's scales have landed
        const int jt = j0 + (warp + i * kWarps) * kTile;
        uint8_t* st = ring + (i % Ge::kStages) * Ge::kStage;
        if (BIGDL_DA_PROBE != 2) {
            mbar_wait(smem_u32(&bars[warp][i % Ge::kStages]),
                      (i / Ge::kStages) & 1);          // and its codes
            // V rows past the span (stale cache rows, or the null page)
            // weigh 0: zero them (a row's swizzled chunks stay in its kW
            // bytes of each box), before the next boxes land here
            if (jt + kTile > j1) {
                constexpr int n16 = Ge::kW / 16;         // chunks a box row
                const int first = (j1 - jt) * Ge::kBoxes * n16;
                for (int c = first + lane; c < kTile * Ge::kBoxes * n16;
                     c += 32) {
                    const int rr = c / (Ge::kBoxes * n16);
                    const int j = (c / n16) % Ge::kBoxes;
                    *reinterpret_cast<uint4*>(
                        st + Ge::kTileBytes + (j * kTile + rr) * Ge::kW +
                        16 * (c % n16)) = make_uint4(0, 0, 0, 0);
                }
                fence_proxy_async();
            }
        }
        __syncwarp();

        const float* ksc = reinterpret_cast<const float*>(
            ring + Ge::kStages * Ge::kStage +
            (i % Ge::kStages) * Ge::kScales);
        if (BIGDL_DA_PROBE == 1) {
            acc[0][0][0] += __uint_as_float(
                *reinterpret_cast<const uint32_t*>(st + 4 * lane));
            __syncwarp();
            continue;
        }

        // S^T = K Q^T: the tile's 16 keys as A (rows gi, gi + 8: this
        // lane's dims of keys gi and gi + 8), q as B; even and odd k
        // steps sum in two chains (half the dependent mma latency)
        float sc[NQ][4];
        {
            uint32_t k0[Ge::kKWords], k1[Ge::kKWords];
            lds_words<Ge>(k0, st, gi, ti * (Ge::kRow / 4));
            lds_words<Ge>(k1, st, gi + 8, ti * (Ge::kRow / 4));
            float odd[NQ][4];
#pragma unroll
            for (int j = 0; j < NQ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    sc[j][e] = 0.f;
                    odd[j][e] = 0.f;
                }
#pragma unroll
            for (int s = 0; s < Ge::kKSteps; ++s) {
                uint32_t ka[4];
                k_frag<KIND>(k0, s, ka[0], ka[2]);
                k_frag<KIND>(k1, s, ka[1], ka[3]);
#pragma unroll
                for (int j = 0; j < NQ; ++j)
                    mma_bf16((s & 1) ? odd[j] : sc[j], ka, qb[j][s][0],
                             qb[j][s][1]);
            }
#pragma unroll
            for (int j = 0; j < NQ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[j][e] += odd[j][e];
        }

        // this lane's scores: keys gi (sc[j][0..1]) and gi + 8 (sc[j][2..3])
        // for queries 8 j + 2 ti + {0, 1}; the softmax runs down the keys
        // (the 8 lanes of a ti)
        const bool vis0 = jt + gi < j1;
        const bool vis1 = jt + gi + 8 < j1;
        float ks0 = a.scale_log2, ks1 = a.scale_log2, vs0 = 1.f, vs1 = 1.f;
        if constexpr (Ge::kScaled) {
            ks0 *= ksc[gi];
            ks1 *= ksc[gi + 8];
            vs0 = ksc[16 + gi];
            vs1 = ksc[16 + gi + 8];
        }
        uint32_t pb[NQ][2];
        float corr[NQ][2];
        bool moved = false;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            uint32_t lo, hi;             // P' of keys gi / gi + 8, 2 queries
            float p[4];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const float s0 = vis0 ? sc[j][c] * ks0 : kNegInf;
                const float s1 = vis1 ? sc[j][2 + c] * ks1 : kNegInf;
                const float m_new = fmaxf(m[j][c], col_max(fmaxf(s0, s1)));
                corr[j][c] = exp2f(m[j][c] - m_new);
                moved = moved || corr[j][c] != 1.f;
                m[j][c] = m_new;
                p[c] = exp2f(s0 - m_new);
                p[2 + c] = exp2f(s1 - m_new);
                l[j][c] = l[j][c] * corr[j][c] + p[c] + p[2 + c];
            }
            // v_scale folded in before the bf16 rounding
            lo = pack_bf16x2(p[0] * vs0, p[1] * vs0);
            hi = pack_bf16x2(p[2] * vs1, p[3] * vs1);
            // P^T as the B operand of query column gi: keys 2 ti, 2 ti + 1
            // (b0) and 2 ti + 8, 2 ti + 9 (b1), from the lanes of keys
            // 2 ti and 2 ti + 1, the half of query gi
            const int src = 8 * ti + (gi >> 1);
            const uint32_t x0 = __shfl_sync(0xffffffffu, lo, src);
            const uint32_t x1 = __shfl_sync(0xffffffffu, lo, src + 4);
            const uint32_t y0 = __shfl_sync(0xffffffffu, hi, src);
            const uint32_t y1 = __shfl_sync(0xffffffffu, hi, src + 4);
            const uint32_t sel = (gi & 1) ? 0x7632 : 0x5410;
            pb[j][0] = __byte_perm(x0, x1, sel);
            pb[j][1] = __byte_perm(y0, y1, sel);
        }
        // the running max moves on few tiles: rescale only then (a factor
        // of exactly 1 elsewhere)
        if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
            for (int j = 0; j < NQ; ++j)
#pragma unroll
                for (int t = 0; t < Ge::kMT; ++t) {
                    acc[j][t][0] *= corr[j][0];
                    acc[j][t][1] *= corr[j][1];
                    acc[j][t][2] *= corr[j][0];
                    acc[j][t][3] *= corr[j][1];
                }
        }

        // O^T += V^T P^T: m16 tile t of dims as A, from this lane's V slice
        // (dims gi * HD/8 ..) of keys 2 ti, 2 ti + 1, 2 ti + 8, 2 ti + 9
        {
            const uint8_t* vt = st + Ge::kTileBytes;
            const int x0 = gi * (Ge::kRow / 8);
            uint32_t v0[Ge::kVWords], v1[Ge::kVWords], v2[Ge::kVWords],
                v3[Ge::kVWords];
            lds_words<Ge>(v0, vt, 2 * ti, x0);
            lds_words<Ge>(v1, vt, 2 * ti + 1, x0);
            lds_words<Ge>(v2, vt, 8 + 2 * ti, x0);
            lds_words<Ge>(v3, vt, 9 + 2 * ti, x0);
#pragma unroll
            for (int t = 0; t < Ge::kMT; ++t) {
                uint32_t va[4];
                va[0] = v_pair<KIND>(v0, v1, t);
                va[1] = v_pair<KIND>(v0, v1, Ge::kMT + t);
                va[2] = v_pair<KIND>(v2, v3, t);
                va[3] = v_pair<KIND>(v2, v3, Ge::kMT + t);
#pragma unroll
                for (int j = 0; j < NQ; ++j)
                    mma_bf16(acc[j][t], va, pb[j][0], pb[j][1]);
            }
        }
        __syncwarp();                    // before the stage is refilled
    }
    cp_async_wait<0>();

    // the warps' partials: sm_m/sm_l [warp][query], sm_acc
    // [warp][query][HD] over the rings, merged in warp order
    __syncthreads();
    constexpr int RW = R16 ? 16 : 8;
    float* sm_m = reinterpret_cast<float*>(smem);
    float* sm_l = sm_m + kWarps * 16;
    float* sm_acc = sm_l + kWarps * 16;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int row = 8 * j + 2 * ti + c;
            const float lt = col_sum(l[j][c]);
            if (gi == 0) {
                sm_m[warp * 16 + row] = m[j][c];
                sm_l[warp * 16 + row] = lt;
            }
            float* dst = sm_acc + (warp * RW + row) * HD + gi * (HD / 8);
#pragma unroll
            for (int t = 0; t < Ge::kMT; ++t) {
                dst[t] = acc[j][t][c];
                dst[Ge::kMT + t] = acc[j][t][2 + c];
            }
        }
    __syncthreads();

    // the block's rows: the G query heads of its kv head
    const int R = G;
    const size_t bh0 = (size_t)b * a.H + (size_t)kh * G;
    float* ws_m = a.ws;
    float* ws_l = ws_m + (size_t)gridDim.y * a.H * a.nspan;
    float* ws_acc = ws_l + (size_t)gridDim.y * a.H * a.nspan;
    // four dims a thread: (row, d .. d + 3)
    for (int e = tid; e < R * (HD / 4); e += kThreads) {
        const int row = e / (HD / 4);
        const int d = 4 * (e - row * (HD / 4));
        float mx = -1e30f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * 16 + row]);
        float den = 0.f;
        float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float f = exp2f(sm_m[w * 16 + row] - mx);
            den += sm_l[w * 16 + row] * f;
            fma4(num, *reinterpret_cast<const float4*>(
                          sm_acc + (w * RW + row) * HD + d), f);
        }
        if (live == 1) {
            store_out(a.out + (bh0 + row) * HD + d, num, den);
        } else {
            const size_t idx = (bh0 + row) * a.nspan + sp;
            *reinterpret_cast<float4*>(ws_acc + idx * HD + d) = num;
            if (d == 0) {
                ws_m[idx] = mx;
                ws_l[idx] = den;
            }
        }
    }
    if (live == 1) return;

    // the last live span of (slot, kv head) to arrive merges them all,
    // in span order: the partials' m and l first (all loads in flight at
    // once), each row's weights, then acc with eight spans' loads in flight
    __threadfence();
    __syncthreads();
    unsigned* ticket = a.tickets + (size_t)b * a.Hkv + kh;
    if (tid == 0) is_last = atomicAdd(ticket, 1u) == (unsigned)live - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    float* pw = reinterpret_cast<float*>(smem);   // [R][live] m, then weight
    float* pl = pw + R * live;                    // [R][live] l
    float* pden = pl + R * live;                  // [R]
    for (int e = tid; e < R * live; e += kThreads) {
        const int row = e / live;
        const size_t i = (bh0 + row) * a.nspan + (e - row * live);
        pw[e] = __ldcg(ws_m + i);
        pl[e] = __ldcg(ws_l + i);
    }
    __syncthreads();
    for (int row = tid; row < R; row += kThreads) {
        float* w = pw + row * live;
        float mx = -1e30f;
        for (int p = 0; p < live; ++p) mx = fmaxf(mx, w[p]);
        float den = 0.f;
        for (int p = 0; p < live; ++p) {
            w[p] = exp2f(w[p] - mx);
            den += pl[row * live + p] * w[p];
        }
        pden[row] = den;
    }
    __syncthreads();
    for (int e = tid; e < R * (HD / 4); e += kThreads) {
        const int row = e / (HD / 4);
        const int d = 4 * (e - row * (HD / 4));
        const float* src = ws_acc + (bh0 + row) * a.nspan * HD + d;
        float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int p = 0; p < live; ++p) {
            fma4(num,
                 __ldcg(reinterpret_cast<const float4*>(src + (size_t)p * HD)),
                 pw[row * live + p]);
        }
        store_out(a.out + (bh0 + row) * HD + d, num, pden[row]);
    }
    if (tid == 0) *ticket = 0u;
}

// The TMA map of one code plane, viewed as [rows, Hkv * row bytes] in
// boxes of 16 rows of kW bytes with the kW-byte swizzle. Returns 0 or an
// error code (tma.cuh).
template <class Ge>
int encode_plane(CUtensorMap* m, const void* plane, long long rows,
                 int hkv) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return kNoEncoder;
    const cuuint64_t dims[2] = {(cuuint64_t)hkv * Ge::kRow, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)hkv * Ge::kRow};
    const cuuint32_t box[2] = {(cuuint32_t)Ge::kW, (cuuint32_t)kTile};
    const cuuint32_t ones[2] = {1, 1};
    const CUresult r = enc(
        m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(plane), dims,
        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
        Ge::kW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
        : Ge::kW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int KIND, int HD, bool R16, class Rows>
int launch_one(const Args& a, const Rows& rows, long long total_rows, int B,
               cudaStream_t st) {
    using Ge = Geo<KIND, HD>;
    auto kern = decode_attention_kernel<KIND, HD, R16, Rows>;
    constexpr int smem = smem_bytes<KIND, HD, R16>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    CUtensorMap kmap, vmap;
    int err = encode_plane<Ge>(&kmap, a.k, total_rows, a.Hkv);
    if (err == 0) err = encode_plane<Ge>(&vmap, a.v, total_rows, a.Hkv);
    if (err != 0) return err;
    kern<<<dim3(a.Hkv, B, a.nspan), kThreads, smem, st>>>(kmap, vmap, a,
                                                          rows);
    return (int)cudaGetLastError();
}

template <int KIND, int HD, bool R16, class Rows>
int blocks_one(const Rows&) {
    auto kern = decode_attention_kernel<KIND, HD, R16, Rows>;
    constexpr int smem = smem_bytes<KIND, HD, R16>();
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
        return -1;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                      smem) != cudaSuccess)
        return -1;
    return n;
}

// Runs F on the instantiation of (kind, hd, G > 8): every kind at hd 64,
// 128, 192, 256 with G <= 8, and at hd 64, 128 with G <= 16. False if
// none is built.
template <class F>
bool dispatch(int kind, int hd, bool r16, F&& f) {
#define BIGDL_DA_HD(KIND)                                                   \
    if (!r16 && hd == 64) return f.template go<KIND, 64, false>(), true;    \
    if (!r16 && hd == 128) return f.template go<KIND, 128, false>(), true;  \
    if (!r16 && hd == 192) return f.template go<KIND, 192, false>(), true;  \
    if (!r16 && hd == 256) return f.template go<KIND, 256, false>(), true;  \
    if (r16 && hd == 64) return f.template go<KIND, 64, true>(), true;      \
    if (r16 && hd == 128) return f.template go<KIND, 128, true>(), true;    \
    return false;
    switch (kind) {
        case KV_BF16: { BIGDL_DA_HD(KV_BF16) }
        case KV_E5M2: { BIGDL_DA_HD(KV_E5M2) }
        case KV_INT8: { BIGDL_DA_HD(KV_INT8) }
        case KV_INT4: { BIGDL_DA_HD(KV_INT4) }
    }
#undef BIGDL_DA_HD
    return false;
}

template <class Rows>
struct Launch {
    const Args& a;
    const Rows& rows;
    int B;
    cudaStream_t st;
    long long total_rows;
    int err;
    template <int KIND, int HD, bool R16>
    void go() {
        err = launch_one<KIND, HD, R16>(a, rows, total_rows, B, st);
    }
};

template <class Rows>
struct Blocks {
    const Rows& rows;
    int n;
    template <int KIND, int HD, bool R16>
    void go() { n = blocks_one<KIND, HD, R16>(rows); }
};

// One launch over S logical keys, nspan = ceil(S / span) blocks a (slot,
// kv head) (`span` a multiple of 16: the plan's keys a block at a full
// cache), codes of KvKind `kind` (ks/vs: the f32 scale planes of
// int8/int4, else unused). With nspan > 1, ws holds B * H * nspan *
// (hd + 2) floats and tickets B * Hkv zeros (left zero).
// Returns the cudaError_t of the launch (0 on success).
template <class Rows>
int launch_decode_attention(const Rows& rows, long long total_rows,
                            const void* q, const void* k, const void* v,
                            const void* ks, const void* vs, const void* pos,
                            void* out, void* ws, void* tickets, int B, int S,
                            int H, int Hkv, int hd, int kind, int span,
                            float scale, void* stream) {
    const bool scaled = kind == KV_INT8 || kind == KV_INT4;
    if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > 16 ||
        span < kTile || span % kTile != 0 || kind < KV_BF16 ||
        kind > KV_INT4 || (scaled && (ks == nullptr || vs == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    const int nspan = (S + span - 1) / span;
    if (nspan > kMaxSpans || (nspan > 1 && (ws == nullptr ||
                                            tickets == nullptr)))
        return (int)cudaErrorInvalidValue;
    const Args a{(const uint16_t*)q, (const uint8_t*)k, (const uint8_t*)v,
                 (const float*)ks, (const float*)vs, (const int*)pos,
                 (uint16_t*)out, (float*)ws, (unsigned*)tickets, S, H, Hkv,
                 nspan, scale * kLog2e};
    Launch<Rows> f{a, rows, B, (cudaStream_t)stream, total_rows, 0};
    if (!dispatch(kind, hd, H / Hkv > 8, f)) return (int)cudaErrorInvalidValue;
    return f.err;
}

// resident blocks per SM of the instantiation a launch of (kind, hd,
// group) takes; <= 0 if none is built
template <class Rows>
int decode_attention_blocks(const Rows& rows, int kind, int hd, int group) {
    Blocks<Rows> f{rows, -1};
    if (group < 1 || group > 16 || !dispatch(kind, hd, group > 8, f))
        return -1;
    return f.n;
}

}  // namespace dattn

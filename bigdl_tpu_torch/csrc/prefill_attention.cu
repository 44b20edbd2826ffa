// B4: causal flash attention of a prefill chunk, forward only, in one
// launch.
//
// Replaces bigdl_tpu/ops/pallas/prefill_attention.py::_pfa_impl: the bf16
// body `_kernel` (with its float8_e5m2 input, upcast in-register) and the
// int8/int4 body `_kernel_scaled`. Sq new queries q [B, Sq, H, hd] against
// S cache rows k/v [B, S, Hkv, hd] (codes of a kv_storage.cuh kind;
// int8/int4 with f32 scales [B, S, Hkv]) at offset pos[b]; key j is
// visible to query i iff j <= pos[b] + i. Scores and softmax in f32, the
// probabilities rounded to bf16 before the value product, a row that sees
// no key gives 0; output bf16 [B, Sq, H, hd]. The scaled kinds fold their
// f32 scales out of the products as the decode body does
// (decode_attention.cuh): score = scale * k_scale[j] * (q . c_j) over the
// exact codes, and the probability is multiplied by v_scale[j] before its
// bf16 rounding, where the TPU kernels' `_dequant_rows` rounds each
// c * scale to bf16 first (one bf16 rounding a term apart).
//
// Bound on the H100: at the engine's chunks (Sq 128-256 against a few
// hundred to a few thousand visible keys) the bytes of q, out and the
// visible K/V rows take longer than the ~4 hd flops of each (query,
// visible key, head) on the tensor cores, but not by much (Sq 256, pos
// 256, Llama-2-7B's heads: 3.8 us of bytes, 1.6 us of flops), so the body
// has to keep the loads and the mma pipe busy on every SM at once.
//
// Design:
// - Work unit: (slot, kv head, query tile, span of keys). A block's 64
//   rows are the G = H / Hkv query heads of one kv head times 64 / G
//   queries, head-major (at G <= 4 warp w's 16 rows are one head's 16
//   queries), so each K/V tile is loaded once for all G heads. The host's
//   planner (ops/cuda/prefill_attention.py::plan_prefill) picks nspan,
//   the blocks a query tile, without the position (the host never reads
//   pos): the fewest that put a block with keys on every SM at the
//   cache's last chunk. On the card each query tile's visible keys,
//   min(pos + its last query + 1, S), are cut evenly in whole tiles over
//   at most nspan spans and at most one span a kWholeTiles key tiles
//   (rounded up), so a tile that sees 256 keys or fewer, as every tile of
//   a first chunk does, stays one span (a shorter span costs more in q and
//   merge than the SM it fills); the other blocks of its cluster leave at
//   once, and where every tile of the call is one span the first blocks
//   take the tiles and the rest leave. Block indices run from the last
//   query tile (the most keys) to the first, so the heavy blocks start
//   first and the light ones fill in behind them.
// - Loads: the block's q rows come once, 16 contiguous bytes a thread by
//   cp.async into shared memory, then into registers as the A operand.
//   Warp 0 streams the span's K and V tiles into a ring of 2-8 stages
//   (sized to the kind) as TMA boxes: one box a 64-row slab of kW bytes of
//   a row (kW the widest of 128/64/32 dividing it), laid out with the
//   kW-byte swizzle so the rows a quarter-warp reads sit on other banks,
//   completing on the stage's "full" mbarrier; the int8/int4 scales come
//   by 4-byte cp.async (zeros past the span) tracked by the same barrier.
//   The four warps hand a stage back through its "empty" barrier, and
//   warp 0 refills it with the tile kStages on. No block-wide barrier
//   inside the loop. (A fifth, producer-only warp cost registers: five
//   warps a block put three on some SM quarter at two blocks an SM, and
//   ptxas held every thread to 168 registers.)
// - Both products on mma.sync m16n8k16 (bf16 in, f32 accumulate): S = Q K^T
//   with q as the A operand (in the head-dim order the kind pairs its
//   codes in: kslot_dim) and each K tile's B fragments converted straight
//   from the staged codes (k_frag: exact kv_pair_* of kv_storage.cuh; no
//   dequantized tile in shared memory), 16 bytes of each key's slice at a
//   time so the eight mma of a k step do not wait on each other; then
//   O += P V with P taken from S's accumulators and V's B fragments paired
//   two keys one dim by one prmt (v_pair). The accumulators are rescaled
//   only when some row's running max moved (a warp vote). Output rows are
//   scaled by one reciprocal of l: an IEEE division a value took its slow
//   path on the H100 and cost microseconds a block.
// - A query tile cut into several spans merges them in the same launch:
//   its nspan blocks are one thread-block cluster; each leaves its (m, l,
//   acc) in its own shared memory, and after a cluster barrier the warps
//   merge the spans in span order through distributed shared memory (the
//   bits do not depend on which block finishes first) and write bf16 out.
//   One launch, no second kernel, no workspace, no memset, no host sync,
//   no allocation.
//
// Probe builds (tools/bench_attention.py --probe; their output is not the
// attention, only their time is read): -DBIGDL_PFA_PROBE=1 stages the
// tiles and does no arithmetic on them, =2 does the arithmetic on whatever
// the ring holds and loads nothing, =3 takes no tile at all (the launch, q
// into registers and the merges alone).
#include "common.cuh"
#include "kv_storage.cuh"
#include "tma.cuh"

#ifndef BIGDL_PFA_PROBE
#define BIGDL_PFA_PROBE 0
#endif

namespace {

constexpr int kWarps = 4;                     // warps a block, 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;            // (query, head) rows a block
constexpr int kKT = 64;                       // keys a tile
constexpr int kRingBytes = 64 * 1024;         // target size of the ring
constexpr int kMaxStages = 8;
constexpr int kMaxSpans = 8;                  // blocks a query tile
constexpr int kWholeTiles = 4;                // key tiles a span before a
                                              // query tile takes two
constexpr int kMaxGroup = 16;                 // query heads a kv head
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int clampi(int x, int lo, int hi) {
    return x < lo ? lo : x > hi ? hi : x;
}

// the layout of one (storage kind, head dim) instantiation
template <int KIND, int HD>
struct Geo {
    static constexpr bool kScaled = Kv<KIND>::kScaled;
    static constexpr int kRow = HD * Kv<KIND>::kBits / 8;  // bytes a row
    static constexpr int kW = kRow % 128 == 0 ? 128 : kRow % 64 == 0 ? 64
                                                                     : 32;
    static constexpr int kBoxes = kRow / kW;
    static constexpr int kTileBytes = kKT * kRow;   // a multiple of 2048
    static constexpr int kStage = 2 * kTileBytes;   // the K tile, then V
    static constexpr int kScales = kScaled ? 2 * kKT * 4 : 0;
    static constexpr int kStages =
        clampi(kRingBytes / (kStage + kScales), 2, kMaxStages);
    // the code ring, then the stages' K and V scales, then the block's q
    // rows (16 bytes of padding a row); 1024 bytes of slack align the ring
    // for the swizzle
    static constexpr int kQRow = 2 * HD + 16;
    // a block's partial in register order, after the loop: a lane's (m, l)
    // of both rows, then its HD/2 accumulators, 16 bytes at a time, over
    // the ring
    static constexpr int kPart = kWarps * 32 * 16 * (1 + HD / 8);
    static constexpr int kRingAll = kStages * (kStage + kScales);
    static constexpr int kSmem =
        1024 + (kRingAll > kPart ? kRingAll : kPart) + kRows * kQRow;
    static constexpr int kKSteps = HD / 16;     // k steps of Q K^T
    static constexpr int kNT = HD / 8;          // n8 tiles of dims of O
    static constexpr int kKWords = kRow / 16;   // a lane's K slice
    static constexpr int kVWords = kRow / 32;   // a lane's V slice
    // the K slice read 16 bytes (or all of it) at a time: kChunkSteps k
    // steps a chunk
    static constexpr int kCW = kKWords < 4 ? kKWords : 4;
    static constexpr int kChunks = kKWords / kCW;
    static constexpr int kChunkSteps = kKSteps / kChunks;
};

struct Args {
    const uint16_t* q;       // [B, Sq, H, hd] bf16
    const float* ks;         // [B, S, Hkv] (int8/int4)
    const float* vs;
    const int* pos;          // [B]
    uint16_t* out;           // [B, Sq, H, hd] bf16
    int B, Sq, S, H, Hkv;
    int G, QT, nqt, nspan;   // heads a kv head, queries a tile, tiles,
                             // blocks (a cluster) a query tile
    float scale_log2;        // scale * log2(e): scores in base 2
};

// NW words from base + off[0] (16-, 8- or 4-byte pieces; a 16-byte piece
// p at base + off[p], the offsets swizzled() gives)
template <int NW, int NP>
__device__ __forceinline__ void lds_at(uint32_t (&w)[NW], const uint8_t* base,
                                       const int (&off)[NP]) {
    if constexpr (NW >= 4) {
        static_assert(NP * 4 == NW, "a 16-byte piece a word quad");
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            const uint4 u = *reinterpret_cast<const uint4*>(base + off[p]);
            w[4 * p] = u.x;
            w[4 * p + 1] = u.y;
            w[4 * p + 2] = u.z;
            w[4 * p + 3] = u.w;
        }
    } else if constexpr (NW == 2) {
        const uint2 u = *reinterpret_cast<const uint2*>(base + off[0]);
        w[0] = u.x;
        w[1] = u.y;
    } else {
        w[0] = *reinterpret_cast<const uint32_t*>(base + off[0]);
    }
}

// Trace build (-DBIGDL_PFA_TRACE, tools/bench_attention.py --trace):
// thread 0 of each of the first 4096 blocks stamps %globaltimer (ns) at
// 0 its start, 1 q in registers, 2 the loop's end, 3 its partial written
// (several spans), 4 past the cluster barrier, 5 out written (by the
// block whose warp 0 writes it), 6 + i tile i's data in (i < 8); read
// with bigdl_pfa_trace.
#ifdef BIGDL_PFA_TRACE
__device__ unsigned long long g_trace[4096][16];
#define TRACE(k)                                                            \
    do {                                                                    \
        if (threadIdx.x == 0 && blockIdx.x < 4096) {                        \
            unsigned long long t_;                                          \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));          \
            g_trace[blockIdx.x][k] = t_;                                    \
        }                                                                   \
    } while (0)
#else
#define TRACE(k)
#endif

// all threads of the cluster: release this block's shared-memory writes,
// acquire the others'
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared address `addr` of this block in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
    uint32_t r;
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
    float4 v;
    asm("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
    return v;
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, -inf -> 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

template <int KIND, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
prefill_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const Args a) {
    using Ge = Geo<KIND, HD>;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
    uint8_t* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
    float* scl = reinterpret_cast<float*>(ring + Ge::kStages * Ge::kStage);
    uint8_t* qs = ring + (Ge::kRingAll > Ge::kPart ? Ge::kRingAll : Ge::kPart);

    // the block's unit, the last query tiles (most keys) first; the nspan
    // blocks of a unit are one cluster, span sp its rank. Where no tile of
    // the call sees more than kWholeTiles key tiles (a first chunk), every
    // tile is one span: block i takes unit i and the blocks past the units
    // leave (a leaving block beside each live one put two live blocks on
    // some SMs and none on others: +2.5 us at Sq 256, pos 0). One block a
    // tile reads no position here.
    bool whole = true;
    if (a.nspan > 1) {
        int most = 0;
        for (int i = 0; i < a.B; ++i)
            most = max(most, min(a.pos[i] + a.Sq, a.S));
        whole = most <= kWholeTiles * kKT;
    }
    const int sp = whole ? 0 : (int)blockIdx.x % a.nspan;
    const int unit = whole ? (int)blockIdx.x : (int)blockIdx.x / a.nspan;
    if (unit >= a.nqt * a.Hkv * a.B) return;
    const int qt = a.nqt - 1 - unit / (a.Hkv * a.B);
    const int kh = unit / a.B % a.Hkv;
    const int b = unit % a.B;

    // the tile's visible keys, cut evenly in whole tiles over nsp spans:
    // at most nspan, and one a kWholeTiles key tiles (rounded up)
    const int p = a.pos[b];
    const int q0 = qt * a.QT;
    const int nvis = max(0, min(p + min(q0 + a.QT, a.Sq), a.S));
    const int nsp = clampi(
        ((nvis + kKT - 1) / kKT + kWholeTiles - 1) / kWholeTiles, 1, a.nspan);
    const int span = max(kKT, ((nvis + nsp - 1) / nsp + kKT - 1) / kKT * kKT);
    const int live = max(1, (nvis + span - 1) / span);
    // a tile of one span: the cluster's other blocks have nothing to do
    if (live == 1 && sp != 0) return;
    // a span past the visible keys has none (it still takes part in its
    // cluster's merge, with an empty partial)
    const int j0 = min(sp * span, nvis);
    const int j1 = min(j0 + span, nvis);
    const int ntiles =
        BIGDL_PFA_PROBE == 3 ? 0 : (j1 - j0 + kKT - 1) / kKT;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    TRACE(0);
    if (tid == 0) {
        for (int i = 0; i < Ge::kStages; ++i) {
            mbar_init(smem_u32(&full[i]), 1 + (Ge::kScaled ? 32 : 0));
            mbar_init(smem_u32(&empty[i]), kWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // warp 0 fills the ring: lane 0 arms a stage's barrier with its K and
    // V boxes; every lane adds two keys' K and V scales by cp.async
    auto load = [&](int i) {
        if (BIGDL_PFA_PROBE == 2) return;
        const int st = i % Ge::kStages;
        const int jt = j0 + i * kKT;
        const int row0 = b * a.S;
        uint8_t* dst = ring + st * Ge::kStage;
        const uint32_t bar = smem_u32(&full[st]);
        if (lane == 0) {
            mbar_expect_tx(bar, Ge::kStage);
            mbar_arrive(bar);
#pragma unroll
            for (int j = 0; j < Ge::kBoxes; ++j) {
                const int x = kh * Ge::kRow + j * Ge::kW;
                const int off = j * kKT * Ge::kW;
                tma_2d(smem_u32(dst + off), &kmap, bar, x, row0 + jt);
                tma_2d(smem_u32(dst + Ge::kTileBytes + off), &vmap, bar, x,
                       row0 + jt);
            }
        }
        if constexpr (Ge::kScaled) {
            float* sd = scl + st * 2 * kKT;
#pragma unroll
            for (int h = 0; h < kKT / 32; ++h) {
                const int key = lane + 32 * h;
                const bool ok = jt + key < j1;
                const size_t src = ((size_t)row0 + jt + key) * a.Hkv + kh;
                cp_async4(sd + key, ok ? a.ks + src : a.ks, ok ? 4 : 0);
                cp_async4(sd + kKT + key, ok ? a.vs + src : a.vs, ok ? 4 : 0);
            }
            cp_async_mbar_arrive(bar);
        }
    };
    // the block's q rows into shared memory, 16 contiguous bytes a thread
    // (zeros for a row past the tile), where the span has keys; the first
    // tiles load meanwhile
    for (int i = j1 > j0 ? tid : kRows * (HD / 8); i < kRows * (HD / 8);
         i += kThreads) {
        const int r = i / (HD / 8);
        const int hh = r / a.QT;
        const int qq = q0 + r % a.QT;
        const bool ok = hh < a.G && qq < a.Sq;
        const uint16_t* src =
            a.q + (((size_t)b * a.Sq + qq) * a.H + (size_t)kh * a.G + hh) * HD;
        cp_async16(qs + r * Ge::kQRow + 16 * (i % (HD / 8)),
                   ok ? src + 8 * (i % (HD / 8)) : a.q, ok ? 16 : 0);
    }
    cp_async_commit();
    if (warp == 0) {
        for (int i = 0; i < min(ntiles, Ge::kStages - 1); ++i) load(i);
    }

    // lane (g, t) holds rows r = 16 warp + g and r + 8 of the block (head
    // r / QT, query q0 + r % QT)
    const int g = lane >> 2;
    const int t = lane & 3;
    int lim[2];              // last key a row sees, its query's causal edge
    bool valid[2];
    size_t rowoff[2];        // the row's q / out offset
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        const int r = 16 * warp + g + 8 * c;
        const int hh = r / a.QT;
        const int qq = q0 + r % a.QT;
        valid[c] = hh < a.G && qq < a.Sq;
        lim[c] = p + qq;
        rowoff[c] = valid[c]
            ? (((size_t)b * a.Sq + qq) * a.H + (size_t)kh * a.G + hh) * HD
            : 0;
    }

    // q as the A operand: this lane's quarter of the dims of rows g and
    // g + 8, k step s in kslot_dim order
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qa[Ge::kKSteps][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        uint32_t w[HD / 8];
        const uint4* src = reinterpret_cast<const uint4*>(
            qs + (16 * warp + g + 8 * c) * Ge::kQRow + t * (HD / 2));
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) {
            const uint4 u = src[i];
            w[4 * i] = u.x;
            w[4 * i + 1] = u.y;
            w[4 * i + 2] = u.z;
            w[4 * i + 3] = u.w;
        }
#pragma unroll
        for (int s = 0; s < Ge::kKSteps; ++s) {
            uint32_t e[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int d = kslot_dim<KIND>(s, i);
                e[i] = (w[d >> 1] >> (16 * (d & 1))) & 0xffffu;
            }
            qa[s][c] = e[0] | (e[1] << 16);        // k slots 2t, 2t + 1
            qa[s][2 + c] = e[2] | (e[3] << 16);    // 2t + 8, 2t + 9
        }
    }

    // O in the C layout of n8 tile i of dims: rows g / g + 8, dims
    // (2t) HD/8 + i and (2t + 1) HD/8 + i (v_pair's slices); the running
    // max and sum of the two rows (the sum a lane's share of the keys)
    float o[Ge::kNT][4];
#pragma unroll
    for (int i = 0; i < Ge::kNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};
    TRACE(1);

    // this lane's swizzled offsets in a K or V tile, for its first rows:
    // the swizzle of a row r depends only on r % 8, so rows 8 n on sit
    // 8 n kW bytes further. K: chunk ch of key g's slice; V: the pieces of
    // keys 2t and 2t + 1's slices
    constexpr int kVP = Ge::kVWords >= 4 ? Ge::kVWords / 4 : 1;
    int kofs[Ge::kChunks][1], vofs[2][kVP];
#pragma unroll
    for (int ch = 0; ch < Ge::kChunks; ++ch)
        kofs[ch][0] = swizzled<Ge::kW, kKT>(g, t * (Ge::kRow / 4) + 16 * ch);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int pc = 0; pc < kVP; ++pc)
            vofs[e][pc] = swizzled<Ge::kW, kKT>(2 * t + e,
                                                g * (Ge::kRow / 8) + 16 * pc);

    for (int i = 0; i < ntiles; ++i) {
        const int st = i % Ge::kStages;
        const int jt = j0 + i * kKT;
        if (warp == 0 && i + Ge::kStages - 1 < ntiles) {
            // tile i - 1's stage, once every warp has let it go
            if (i >= 1)
                mbar_wait(smem_u32(&empty[(i - 1) % Ge::kStages]),
                          ((i - 1) / Ge::kStages) & 1);
            load(i + Ge::kStages - 1);
        }
        if (BIGDL_PFA_PROBE != 2)
            mbar_wait(smem_u32(&full[st]), (i / Ge::kStages) & 1);
        if (i < 8) TRACE(6 + i);
        const uint8_t* kt = ring + st * Ge::kStage;
        const uint8_t* vt = kt + Ge::kTileBytes;
        const float* sc = scl + st * 2 * kKT;
        if (BIGDL_PFA_PROBE == 1) {
            o[0][0] += __uint_as_float(
                *reinterpret_cast<const uint32_t*>(kt + 4 * lane));
            __syncwarp();
            if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
            continue;
        }

        // S = Q K^T: keys 8 n + g of the tile as B, from this lane's K
        // slice, 16 bytes of every key at a time, so the kKT / 8 mma of a
        // k step are independent of each other
        float s[kKT / 8][4];
#pragma unroll
        for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int ch = 0; ch < Ge::kChunks; ++ch) {
            uint32_t kw[kKT / 8][Ge::kCW];
#pragma unroll
            for (int n = 0; n < kKT / 8; ++n)
                lds_at(kw[n], kt + 8 * n * Ge::kW, kofs[ch]);
#pragma unroll
            for (int ls = 0; ls < Ge::kChunkSteps; ++ls) {
#pragma unroll
                for (int n = 0; n < kKT / 8; ++n) {
                    uint32_t b0, b1;
                    k_frag<KIND>(kw[n], ls, b0, b1);
                    const int ks = ch * Ge::kChunkSteps + ls;
                    mma_bf16(s[n], qa[ks], b0, b1);
                }
            }
        }

        // mask (past the span, past a row's query) and scale; this lane
        // holds keys 8 n + 2 t, + 1 of rows g (e 0, 1) and g + 8 (e 2, 3)
        const int e0 = min(j1 - 1, lim[0]) - jt;
        const int e1 = min(j1 - 1, lim[1]) - jt;
        float mx[2] = {-1e30f, -1e30f};
#pragma unroll
        for (int n = 0; n < kKT / 8; ++n) {
            const int key = 8 * n + 2 * t;
            float k0 = a.scale_log2, k1 = a.scale_log2;
            if constexpr (Ge::kScaled) {
                const float2 f = *reinterpret_cast<const float2*>(sc + key);
                k0 *= f.x;
                k1 *= f.y;
            }
            s[n][0] = key <= e0 ? s[n][0] * k0 : kNegInf;
            s[n][1] = key + 1 <= e0 ? s[n][1] * k1 : kNegInf;
            s[n][2] = key <= e1 ? s[n][2] * k0 : kNegInf;
            s[n][3] = key + 1 <= e1 ? s[n][3] * k1 : kNegInf;
            mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
        }
        float corr[2];
        bool moved = false;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], 1));
            mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], 2));
            const float m_new = fmaxf(m[c], mx[c]);
            corr[c] = ex2(m[c] - m_new);
            moved = moved || corr[c] != 1.f;
            m[c] = m_new;
        }
        // P as bf16 A fragments of 16 keys each, v_scale folded in before
        // the rounding; l takes the unscaled probabilities
        uint32_t pa[kKT / 16][4];
        float ps[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kKT / 8; ++n) {
            float v0 = 1.f, v1 = 1.f;
            if constexpr (Ge::kScaled) {
                const float2 f =
                    *reinterpret_cast<const float2*>(sc + kKT + 8 * n + 2 * t);
                v0 = f.x;
                v1 = f.y;
            }
            const float p0 = ex2(s[n][0] - m[0]);
            const float p1 = ex2(s[n][1] - m[0]);
            const float p2 = ex2(s[n][2] - m[1]);
            const float p3 = ex2(s[n][3] - m[1]);
            ps[0] += p0 + p1;
            ps[1] += p2 + p3;
            pa[n >> 1][2 * (n & 1)] = pack_bf16x2(p0 * v0, p1 * v1);
            pa[n >> 1][2 * (n & 1) + 1] = pack_bf16x2(p2 * v0, p3 * v1);
        }
        l[0] = l[0] * corr[0] + ps[0];
        l[1] = l[1] * corr[1] + ps[1];
        if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
            for (int d = 0; d < Ge::kNT; ++d) {
                o[d][0] *= corr[0];
                o[d][1] *= corr[0];
                o[d][2] *= corr[1];
                o[d][3] *= corr[1];
            }
        }

        // O += P V: V's B fragments of keys 2t, 2t + 1 (b0) and 2t + 8,
        // 2t + 9 (b1) of each 16, dims of this lane's V slice
#pragma unroll
        for (int kk = 0; kk < kKT / 16; ++kk) {
            uint32_t v0[Ge::kVWords], v1[Ge::kVWords], v2[Ge::kVWords],
                v3[Ge::kVWords];
            lds_at(v0, vt + 16 * kk * Ge::kW, vofs[0]);
            lds_at(v1, vt + 16 * kk * Ge::kW, vofs[1]);
            lds_at(v2, vt + (16 * kk + 8) * Ge::kW, vofs[0]);
            lds_at(v3, vt + (16 * kk + 8) * Ge::kW, vofs[1]);
#pragma unroll
            for (int d = 0; d < Ge::kNT; ++d)
                mma_bf16(o[d], pa[kk], v_pair<KIND>(v0, v1, d),
                         v_pair<KIND>(v2, v3, d));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
    }

#pragma unroll
    for (int c = 0; c < 2; ++c) {
        l[c] += __shfl_xor_sync(0xffffffffu, l[c], 1);
        l[c] += __shfl_xor_sync(0xffffffffu, l[c], 2);
    }
    // this lane's dims of row c: [d0, d0 + HD/4), the first HD/8 in
    // o[.][2c], the rest in o[.][2c + 1]
    const int d0 = 2 * t * (HD / 8);
    auto val = [&](int c, int d) -> float {
        return d < HD / 8 ? o[d][2 * c] : o[d - HD / 8][2 * c + 1];
    };
    auto store = [&](int c, const float (&num)[HD / 4], float den) {
        if (!valid[c]) return;
        const float r = __frcp_rn(den > 0.f ? den : 1.f);
        uint16_t* dst = a.out + rowoff[c] + d0;
#pragma unroll
        for (int d = 0; d < HD / 4; d += 8) {
            uint4 u;
            u.x = pack_bf16x2(num[d] * r, num[d + 1] * r);
            u.y = pack_bf16x2(num[d + 2] * r, num[d + 3] * r);
            u.z = pack_bf16x2(num[d + 4] * r, num[d + 5] * r);
            u.w = pack_bf16x2(num[d + 6] * r, num[d + 7] * r);
            *reinterpret_cast<uint4*>(dst + d) = u;
        }
    };
    TRACE(2);
    if (live == 1) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            float num[HD / 4];
#pragma unroll
            for (int d = 0; d < HD / 4; ++d) num[d] = val(c, d);
            store(c, num, l[c]);
        }
        TRACE(5);
        return;
    }

    // several spans: each block leaves its partial in its own shared
    // memory in register order; after a cluster barrier the warps of the
    // cluster merge the rows of their own warp index w in the blocks with
    // w % nspan == their rank, reading the live spans' partials in span
    // order through distributed shared memory, then a second barrier keeps
    // every block's memory until the reads are done. No global workspace,
    // no ticket.
    float4* part = reinterpret_cast<float4*>(ring);   // [warp][1 + HD/8][32]
    auto own = [&](int j) -> float4 {
        const int c = 4 * j / (HD / 4);
        const int d = 4 * j % (HD / 4);
        return make_float4(val(c, d), val(c, d + 1), val(c, d + 2),
                           val(c, d + 3));
    };
    __syncthreads();                     // every warp is done with the ring
    float4* mine = part + warp * (1 + HD / 8) * 32 + lane;
    mine[0] = make_float4(m[0], m[1], l[0], l[1]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) mine[(1 + j) * 32] = own(j);
    TRACE(3);
    cluster_sync();
    TRACE(4);
    if (warp % a.nspan == sp) {
        // the spans in span order, each rescaled to the running max
        float mx[2] = {-1e30f, -1e30f}, den[2] = {0.f, 0.f};
        float num[2][HD / 4];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int d = 0; d < HD / 4; ++d) num[c][d] = 0.f;
        const uint32_t at = smem_u32(mine);
#pragma unroll 1
        for (int q = 0; q < live; ++q) {
            const uint32_t src = mapa(at, q);
            float4 x[HD / 8];
            const float4 ml = ld_cluster4(src);
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                x[j] = ld_cluster4(src + 16 * 32 * (1 + j));
            const float mq[2] = {ml.x, ml.y}, lq[2] = {ml.z, ml.w};
            float f_old[2], f_new[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const float m_new = fmaxf(mx[c], mq[c]);
                f_old[c] = exp2f(mx[c] - m_new);
                f_new[c] = exp2f(mq[c] - m_new);
                den[c] = den[c] * f_old[c] + lq[c] * f_new[c];
                mx[c] = m_new;
            }
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                const int c = 4 * j / (HD / 4);
                const int d = 4 * j % (HD / 4);
                num[c][d] = num[c][d] * f_old[c] + x[j].x * f_new[c];
                num[c][d + 1] = num[c][d + 1] * f_old[c] + x[j].y * f_new[c];
                num[c][d + 2] = num[c][d + 2] * f_old[c] + x[j].z * f_new[c];
                num[c][d + 3] = num[c][d + 3] * f_old[c] + x[j].w * f_new[c];
            }
        }
        store(0, num[0], den[0]);
        store(1, num[1], den[1]);
        TRACE(5);
    }
    cluster_sync();
}

// The TMA map of one code plane, viewed as [rows, Hkv * row bytes] in
// boxes of 64 rows of kW bytes with the kW-byte swizzle. Returns 0 or an
// error code (tma.cuh).
template <class Ge>
int encode_plane(CUtensorMap* m, const void* plane, long long rows,
                 int hkv) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return kNoEncoder;
    const cuuint64_t dims[2] = {(cuuint64_t)hkv * Ge::kRow, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)hkv * Ge::kRow};
    const cuuint32_t box[2] = {(cuuint32_t)Ge::kW, (cuuint32_t)kKT};
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

template <int KIND, int HD>
int launch_one(const Args& a, const void* k, const void* v,
               cudaStream_t st) {
    using Ge = Geo<KIND, HD>;
    auto kern = prefill_attention_kernel<KIND, HD>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ge::kSmem);
    if (attr != cudaSuccess) return (int)attr;
    CUtensorMap kmap, vmap;
    const long long rows = (long long)a.B * a.S;
    int err = encode_plane<Ge>(&kmap, k, rows, a.Hkv);
    if (err == 0) err = encode_plane<Ge>(&vmap, v, rows, a.Hkv);
    if (err != 0) return err;
    // the nspan blocks of a query tile are one cluster
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.nqt * a.nspan * a.Hkv * a.B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Ge::kSmem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = a.nspan;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, kmap, vmap, a);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int KIND>
int launch_hd(int hd, const Args& a, const void* k, const void* v,
              cudaStream_t st) {
    switch (hd) {
        case 64: return launch_one<KIND, 64>(a, k, v, st);
        case 128: return launch_one<KIND, 128>(a, k, v, st);
        case 256: return launch_one<KIND, 256>(a, k, v, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success) or an error code of
// csrc/tma.cuh (a tensor map that did not encode). hd is 64, 128 or 256;
// kind a KvKind (kv_storage.cuh), with ks/vs the scale planes of int8/int4
// (may be null otherwise); H / Hkv <= 16. A block takes 64 rows: 64 / G
// queries (G = H / Hkv) of the G heads of one kv head, so a launch has
// nqt = ceil(Sq / (64 / G)) query tiles, each taking nspan blocks (1..8),
// the blocks of one cluster, of which those its keys need take part.
extern "C" int bigdl_prefill_attention(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* pos,
                                       void* out, int B, int Sq, int Smax,
                                       int H, int Hkv, int hd, int kind,
                                       int nspan, float scale, void* stream) {
    const bool scaled = kind == KV_INT8 || kind == KV_INT4;
    if (B < 1 || Sq < 1 || Smax < 1 || Hkv < 1 || H % Hkv != 0 ||
        H / Hkv > kMaxGroup || nspan < 1 || nspan > kMaxSpans ||
        (scaled && (ks == nullptr || vs == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    const int G = H / Hkv;
    const int QT = kRows / G;
    const Args a{(const uint16_t*)q, (const float*)ks, (const float*)vs,
                 (const int*)pos, (uint16_t*)out, B, Sq, Smax, H, Hkv, G, QT,
                 (Sq + QT - 1) / QT, nspan, scale * kLog2e};
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case KV_BF16: return launch_hd<KV_BF16>(hd, a, k, v, st);
        case KV_E5M2: return launch_hd<KV_E5M2>(hd, a, k, v, st);
        case KV_INT8: return launch_hd<KV_INT8>(hd, a, k, v, st);
        case KV_INT4: return launch_hd<KV_INT4>(hd, a, k, v, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

#ifdef BIGDL_PFA_TRACE
extern "C" int bigdl_pfa_trace(void* host) {
    return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
extern "C" int bigdl_pfa_trace_clear() {
    static unsigned long long zero[4096][16];
    return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(g_trace));
}
#endif

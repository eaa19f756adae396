// packed_attn_bwd_f32 — the float32 backward of the packed (varlen) segment
// attention of the HLLM item tower on Hopper (sm_90a): the float32 towers'
// route (`precision: 32`) of packed_attn_bwd, whose bfloat16 route lives in
// packed_attn_bwd.cu. With
//     P[i, j] = exp(scale · q_i·k_j − lse_i)   (the forward's probabilities)
//     dP[i, j] = dO_i·v_j,   Δ_i = Σ_d dO[i, d]·O[i, d],
//     dS = P ⊙ (dP − Δ)
// it computes dq_i = scale · Σ_j dS[i, j] k_j, dk_j = scale · Σ_i dS[i, j] q_i
// and dv_j = Σ_i P[i, j] dO_i over the pairs the forward attends (key j ≤ i
// of query i's segment > 0, i − j ≤ window); dk and dv of a KV head sum over
// the H / Hkv query heads that read it (head h reads KV head h / (H / Hkv)).
// Every product, sum and statistic is full float32 on the CUDA cores: the
// tensor cores would take float32 as TF32, and the float32 towers exist for
// float32 numbers. Rows of segment 0 get dq = 0, keys no real query attends
// dk = dv = 0.
//
// Replaces, in float32, the two TPU kernels of the splash attention's
// custom_vjp that _splash_call (mhrec_tpu/models/llm/packed.py:45)
// differentiates through: _splash_attention_bwd_dq (pallas_call at
// jax/experimental/pallas/ops/tpu/splash_attention/
// splash_attention_kernel.py:1635) and _splash_attention_bwd_dkv (:2196).
// Two passes, as splash's: the dq pass also writes Δ to a float32 [C, H, S]
// scratch, which the dk/dv pass, launched after it on the same stream, reads.
// No state is carried between blocks and no output is summed with atomics,
// so a repeat gives the same bits; dk/dv sum their query heads in a fixed
// order inside one block.
//
// Bound on the H100: operations. At the corpus shape (16 chunk rows of 2048
// tokens, H = 32 over Hkv = 4, dh = 64, band 257, 22,980 real tokens) the
// band's 10·dh flops a pair and head (S and dP recomputed, dq, dk, dv) take
// 0.62 ms at 67 TFLOP/s of float32 FMAs, against 0.36 ms for the bytes.
// Three limits held the first float32 kernels (one 16 x 16 thread grid on
// 64 x 64 tiles) at 12% of that, and the design answers each:
// 1. Shared-memory operand traffic. Tiles are float32 in shared memory,
//    row-major with rows padded by 4 floats, so the lanes reading different
//    rows at one depth hit different bank quads, and every operand is read
//    with a 16-byte ld.shared.v4 along dh. A warp owns 16 rows and meets
//    the streamed side 16 rows at a time: a lane owns 4 own rows x 2 stage
//    rows of S and of dP, so a depth step of 4 takes 12 loads for 64 FMAs
//    (the first kernels: one float a load, 16 loads for 32 FMAs). dS (and
//    P) leave the score registers once a sub-tile, into a padded 16 x 16
//    tile of the warp's own, read back along the depth with 16-byte loads
//    by the second products (dq += dS·K; dV += Pᵀ·dO, then dK += dSᵀ·Q
//    through the same tile), whose lane tiles (4 rows x 8 columns at
//    dh = 64) take 12 loads for 128 FMAs. The scale and log2(e) fold into
//    one FMA ahead of exp2f. Wider score tiles (4 x 4 over two sub-tiles)
//    were tried and lost: at three blocks an SM they spill, at two the SM
//    has too few warps.
// 2. Pairs masked anyway. A block owns 64 rows, 16 a warp; the other side
//    streams in sub-tiles of 16 rows. Each warp keeps the span its own rows
//    attend, found on the card from the segment ids: in the dq pass from
//    max(start of its first real row's segment, that row − window) to its
//    last real row, in the dk/dv pass from its first real key to the end of
//    its last key's segment (at most window rows past it). A warp computes
//    a streamed sub-tile only where it meets that span; the block streams
//    only the union of its warps' spans. At the corpus shape this computes
//    about 1.24 times the band's pairs, against 2.0-2.2 times for the
//    64 x 64 tiles. The spans need no host synchronisation, no atomics on
//    outputs and no state between blocks.
// 3. Copies overlapped. The streamed k/v tiles (dq pass) and q/dO tiles
//    (dk/dv pass) and their segment ids, lse and Δ come through a ring of two
//    stages filled by cp.async (16 bytes a copy for rows, 4 for the row
//    statistics): the next stage is in flight while this one is multiplied.
//    A block is 4 warps with 57,344 bytes of dynamic shared memory at
//    dh = 64 (either pass), so three blocks share an SM (two at dh = 128,
//    whose tiles are twice as wide), and the blocks of a wave fall out of
//    step.
#include <climits>

#include "packed_attn_common.cuh"
#include "tc_bf16.cuh"

namespace packed {
namespace f32bwd {

constexpr int WARPS = 4;
constexpr int NTH = 32 * WARPS;  // threads a block
constexpr int BM = 16 * WARPS;   // a block's own rows: query rows (dq), key rows (dk/dv)
constexpr int BS = 16;           // rows of a sub-tile on the streamed side
constexpr int SP = BS + 4;       // pitch of a warp's 16 x 16 dS (or P) tile
constexpr float LOG2E = 1.4426950408889634f;
static_assert(NTH == 2 * BM, "the dq pass sums Δ with two threads a row");

// floats of dynamic shared memory of either pass: the block's own q/dO (k/v)
// tiles, the two-stage ring of streamed k/v (q/dO) tiles, the warps' dS (P)
// tiles
__host__ __device__ constexpr int smem_floats(int dh) {
    return 2 * BM * (dh + 4) + 2 * 2 * BS * (dh + 4) + WARPS * 16 * SP;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void fma4(float4& acc, float s, const float4& x) {
    acc.x = fmaf(s, x.x, acc.x);
    acc.y = fmaf(s, x.y, acc.y);
    acc.z = fmaf(s, x.z, acc.z);
    acc.w = fmaf(s, x.w, acc.w);
}
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float comp(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 4 bytes from global to shared memory, or 4 zero bytes when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_addr(dst)),
                 "l"(src), "r"(pred ? 4 : 0)
                 : "memory");
}

// rows [0, n) of an R x DH float32 tile at src (row stride `stride` floats,
// rows 16-byte aligned) into shared memory at dst (pitch DH + 4); rows
// n..R-1 zero-filled. All NTH threads take part.
template <int R, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long stride, int n,
                                           int tid) {
    constexpr int CPR = DH / 4;  // 16-byte chunks a row
#pragma unroll
    for (int e0 = 0; e0 < R * CPR; e0 += NTH) {
        const int e = e0 + tid, r = e / CPR, ch = e % CPR;
        if (e < R * CPR) {
            const bool in = r < n;
            tc::cp_async16(dst + r * (DH + 4) + ch * 4, in ? src + r * stride + ch * 4 : src, in);
        }
    }
}

// The thread tiles of a warp's 16 own rows (i) against the 16 rows of a
// stage (j). Scores: lane = 8·rg + cg owns own rows rg + 4·t (t < 4) and
// stage rows cg + 8·u (u < 2). The second products ([16 own rows][DH]):
// lane = CG·rq + cq owns own rows rq + RG·t (t < QR) and 4-float chunks
// cq + CG·u (u < QC).
template <int DH>
struct Tile {
    static constexpr int LD = DH + 4;
    static constexpr int NC = DH / 4;
    static constexpr int CG = NC < 8 ? NC : 8;
    static constexpr int RG = 32 / CG;
    static constexpr int QR = 16 / RG;
    static constexpr int QC = NC / CG;
};

// s[t][u] = a_t·b_u and dp[t][u] = g_t·w_u over DH: own rows a, g (own
// tile rows rg + 4t from `own`, `own2`), stage rows b, w (rows cg + 8u from
// `st`, `st2`), each pointer at its tile's row for this lane
template <int DH>
__device__ __forceinline__ void scores(const float* own, const float* own2, const float* st,
                                       const float* st2, float (&s)[4][2], float (&dp)[4][2]) {
    constexpr int LD = DH + 4;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int u = 0; u < 2; ++u) s[t][u] = dp[t][u] = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < DH / 4; ++cc) {
        float4 b[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) b[u] = ld4(st + 8 * u * LD + 4 * cc);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const float4 a = ld4(own + 4 * t * LD + 4 * cc);
#pragma unroll
            for (int u = 0; u < 2; ++u) s[t][u] = dot4(a, b[u], s[t][u]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) b[u] = ld4(st2 + 8 * u * LD + 4 * cc);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const float4 g = ld4(own2 + 4 * t * LD + 4 * cc);
#pragma unroll
            for (int u = 0; u < 2; ++u) dp[t][u] = dot4(g, b[u], dp[t][u]);
        }
    }
}

// acc[t][u] += Σ_j x[own row][j] · y[j][chunk] over the 16 stage rows j of a
// sub-tile: x the warp's 16 x 16 tile (pitch SP), y the stage's rows (pitch
// DH + 4), 4 rows j a step
template <int DH>
__device__ __forceinline__ void mix(const float* x, const float* y, int rq, int cq,
                                    float4 (&acc)[Tile<DH>::QR][Tile<DH>::QC]) {
    using TL = Tile<DH>;
#pragma unroll
    for (int jj = 0; jj < BS / 4; ++jj) {
        float4 d[TL::QR];
#pragma unroll
        for (int t = 0; t < TL::QR; ++t) d[t] = ld4(x + (rq + TL::RG * t) * SP + 4 * jj);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int u = 0; u < TL::QC; ++u) {
                const float4 yv = ld4(y + (4 * jj + e) * TL::LD + 4 * (cq + TL::CG * u));
#pragma unroll
                for (int t = 0; t < TL::QR; ++t) fma4(acc[t][u], comp(d[t], e), yv);
            }
    }
}

// dq of query rows [q0, q0 + BM) of head h of chunk row c, and Δ of those
// rows. Warp w owns query rows 16·w .. 16·w + 15; stages of BS keys and
// their values stream through a ring of two.
template <int DH>
__global__ void __launch_bounds__(NTH, DH == 128 ? 2 : 3) dq_kernel(BwdArgs p) {
    using TL = Tile<DH>;
    constexpr int LD = TL::LD, NC = TL::NC, CG = TL::CG, RG = TL::RG, QR = TL::QR,
                  QC = TL::QC;
    extern __shared__ __align__(16) float smem[];
    float* sq = smem;               // [BM][LD]
    float* sdo = sq + BM * LD;      // [BM][LD]
    float* sk = sdo + BM * LD;      // [2][BS][LD]
    float* sv = sk + 2 * BS * LD;   // [2][BS][LD]
    float* sds = sv + 2 * BS * LD;  // [WARPS][16][SP]
    __shared__ int qseg[BM];
    __shared__ __align__(16) int kseg[2][BS];
    __shared__ float slse[BM], sdl[BM];
    __shared__ int band_lo, wlo[WARPS], whi[WARPS];

    const int S = p.S, H = p.H, win = p.window;
    const int c = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int hk = h / (H / p.Hkv);
    const int* segc = p.seg + (long long)c * S;
    const int qn = min(BM, S - q0);
    const float* qb = static_cast<const float*>(p.q) + c * p.sqc + q0 * p.sqs + (long long)h * DH;
    const float* kb = static_cast<const float*>(p.k) + c * p.skc + (long long)hk * DH;
    const float* vb = static_cast<const float*>(p.v) + c * p.svc + (long long)hk * DH;
    const long long rs = (long long)H * DH;                                   // row stride of o, dO, dq
    const long long base = ((long long)c * S + q0) * rs + (long long)h * DH;  // (c, q0, h, 0)
    const float* ob = static_cast<const float*>(p.o) + base;
    const float* gb = static_cast<const float*>(p.dout) + base;
    float* dqb = static_cast<float*>(p.dq) + base;
    const float* lseb = p.lse + ((long long)c * H + h) * S + q0;
    float* deltab = p.delta + ((long long)c * H + h) * S + q0;

    const int lo0 = max(0, q0 - win);
    if (tid == 0) band_lo = lo0;
    const int my_seg = tid < qn ? segc[q0 + tid] : 0;  // NTH >= BM
    if (tid < BM) qseg[tid] = my_seg;
    if (!__syncthreads_or(my_seg > 0)) {  // a tile of padding rows
        for (int e = tid; e < qn * NC; e += NTH)
            *reinterpret_cast<float4*>(dqb + (e / NC) * rs + (e % NC) * 4) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        if (tid < qn) deltab[tid] = 0.f;
        return;
    }
    stage_rows<BM, DH>(sq, qb, p.sqs, qn, tid);
    stage_rows<BM, DH>(sdo, gb, rs, qn, tid);
    tc::cp_async_commit();
    // the band of row q0 starts after the last key before q0 whose segment
    // differs from row q0's (packed_attn_fwd.cu)
    const int seg0 = qseg[0];
    for (int j = lo0 + tid; j < q0; j += NTH)
        if (segc[j] != seg0) atomicMax(&band_lo, j + 1);
    __syncthreads();
    {  // this warp's key span [lo, hi]: from the first key its first real row
       // attends to its last real row (each segment is one run)
        const int r = warp * 16 + (lane & 15);
        const unsigned m = __ballot_sync(0xffffffffu, lane < 16 && qseg[r] > 0) & 0xffffu;
        if (lane == 0) {
            int lo = INT_MAX, hi = -1;
            if (m) {
                const int rf = warp * 16 + __ffs(m) - 1, rl = warp * 16 + 31 - __clz(m);
                const int s = qseg[rf];
                int start = band_lo;  // row q0's segment, or a window bound
                if (s != seg0) {      // a segment that starts inside the tile
                    int i = rf;
                    while (qseg[i - 1] == s) --i;
                    start = q0 + i;
                }
                lo = max(start, q0 + rf - win);
                hi = q0 + rl;
            }
            wlo[warp] = lo;
            whi[warp] = hi;
        }
    }
    __syncthreads();
    int kbeg = INT_MAX, kend = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        kbeg = min(kbeg, wlo[w]);
        kend = max(kend, whi[w] + 1);
    }
    const int nst = (kend - kbeg + BS - 1) / BS;
    const int lo_w = wlo[warp], hi_w = whi[warp];

    auto load_kv = [&](int st, int buf) {
        const int k0 = kbeg + st * BS, nk = min(BS, S - k0);
        stage_rows<BS, DH>(sk + buf * BS * LD, kb + k0 * p.sks, p.sks, nk, tid);
        stage_rows<BS, DH>(sv + buf * BS * LD, vb + k0 * p.svs, p.svs, nk, tid);
        if (tid < BS) cp_async4(&kseg[buf][tid], segc + k0 + (tid < nk ? tid : 0), tid < nk);
    };
    load_kv(0, 0);  // in flight while Δ is summed
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // q and dO have landed
    __syncthreads();
    {  // Δ = rowsum(dO ⊙ O) in float32, two threads a row
        const int r = tid >> 1, half = tid & 1;
        float part = 0.f;
        if (r < qn) {
            const float* orow = ob + r * rs + half * (DH / 2);
            const float* grow = sdo + r * LD + half * (DH / 2);
#pragma unroll
            for (int ch = 0; ch < DH / 8; ++ch)
                part = dot4(ld4(grow + 4 * ch), *reinterpret_cast<const float4*>(orow + 4 * ch),
                            part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (half == 0) {
            sdl[r] = part;
            slse[r] = r < qn ? lseb[r] * LOG2E : 0.f;
            if (r < qn) deltab[r] = part;
        }
    }
    __syncthreads();

    // this thread's rows of the score tiles: warp·16 + rg + 4t (their
    // segment ids and statistics are read from shared memory where dS is
    // formed, to leave the registers to the products)
    const int rg = lane >> 3, cg = lane & 7;
    const float sl2 = p.scale * LOG2E;
    const float* sqw = sq + (warp * 16 + rg) * LD;
    const float* sdow = sdo + (warp * 16 + rg) * LD;
    float* sdsw = sds + warp * 16 * SP;
    const int rq = lane / CG, cq = lane % CG;

    float4 acc[QR][QC];
#pragma unroll
    for (int t = 0; t < QR; ++t)
#pragma unroll
        for (int u = 0; u < QC; ++u) acc[t][u] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int st = 0; st < nst; ++st) {
        const int buf = st & 1;
        tc::cp_async_wait<0>();  // this stage has landed
        // one barrier a stage: this stage is seen by every warp, and every
        // warp is done with the last one, whose buffer the next stage fills
        __syncthreads();
        if (st + 1 < nst) load_kv(st + 1, buf ^ 1);
        tc::cp_async_commit();
        const int k0 = kbeg + st * BS;
        if (k0 <= hi_w && k0 + BS - 1 >= lo_w) {  // a sub-tile this warp's rows attend
            const float* skb = sk + buf * BS * LD;
            float s[4][2], dp[4][2];
            scores<DH>(sqw, sdow, skb + cg * LD, sv + buf * BS * LD + cg * LD, s, dp);
            // dS = P ⊙ (dP − Δ) on the attended pairs, into the warp's tile
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int i = warp * 16 + rg + 4 * t, row = q0 + i, sg = qseg[i];
                const float ls = slse[i], dl = sdl[i];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int j = cg + 8 * u, col = k0 + j;
                    const bool keep =
                        sg > 0 && kseg[buf][j] == sg && col <= row && row - col <= win;
                    const float x = keep ? fmaf(s[t][u], sl2, -ls) : -INFINITY;
                    sdsw[(rg + 4 * t) * SP + j] = exp2f(x) * (dp[t][u] - dl);
                }
            }
            __syncwarp();
            mix<DH>(sdsw, skb, rq, cq, acc);  // dq += dS · K
            __syncwarp();  // the tile is read before the next sub-tile writes it
        }
    }

    const float scale = p.scale;
#pragma unroll
    for (int t = 0; t < QR; ++t) {
        const int i = warp * 16 + rq + RG * t;
        if (i >= qn) continue;
#pragma unroll
        for (int u = 0; u < QC; ++u) {
            const float4 a = acc[t][u];
            *reinterpret_cast<float4*>(dqb + i * rs + 4 * (cq + CG * u)) =
                make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
        }
    }
}

// dk and dv of key rows [k0, k0 + BM) of KV head hk of chunk row c, summed
// over its query heads. Warp w owns key rows 16·w .. 16·w + 15; the work
// items (query head, stage of BS query rows) stream their q, dO, segment
// ids, lse and Δ through a ring of two, one item ahead across the heads.
template <int DH>
__global__ void __launch_bounds__(NTH, DH == 128 ? 2 : 3) dkv_kernel(BwdArgs p) {
    using TL = Tile<DH>;
    constexpr int LD = TL::LD, NC = TL::NC, CG = TL::CG, RG = TL::RG, QR = TL::QR,
                  QC = TL::QC;
    extern __shared__ __align__(16) float smem[];
    float* sk = smem;                    // [BM][LD]
    float* sv = sk + BM * LD;            // [BM][LD]
    float* sq = sv + BM * LD;       // [2][BS][LD]
    float* sdo = sq + 2 * BS * LD;  // [2][BS][LD]
    float* sp = sdo + 2 * BS * LD;  // [WARPS][16][SP] Pᵀ, then dSᵀ, of a sub-tile
    __shared__ int kseg[BM];
    __shared__ __align__(16) int qseg[2][BS];
    __shared__ __align__(16) float slse[2][BS], sdl[2][BS];
    __shared__ int band_hi, wlo[WARPS], whi[WARPS];

    const int S = p.S, H = p.H, Hkv = p.Hkv, G = H / Hkv, win = p.window;
    const int c = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BM;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int* segc = p.seg + (long long)c * S;
    const int nk = min(BM, S - k0);
    const float* kb = static_cast<const float*>(p.k) + c * p.skc + k0 * p.sks + (long long)hk * DH;
    const float* vb = static_cast<const float*>(p.v) + c * p.svc + k0 * p.svs + (long long)hk * DH;
    const long long kvs = (long long)Hkv * DH;  // row stride of dk, dv
    const long long kvbase = ((long long)c * S + k0) * kvs + (long long)hk * DH;
    float* dkb = static_cast<float*>(p.dk) + kvbase;
    float* dvb = static_cast<float*>(p.dv) + kvbase;
    const long long rs = (long long)H * DH;  // row stride of dO

    const int hi0 = min(S, k0 + nk + win);
    if (tid == 0) band_hi = hi0;
    const int my_seg = tid < nk ? segc[k0 + tid] : 0;  // NTH >= BM
    if (tid < BM) kseg[tid] = my_seg;
    if (!__syncthreads_or(my_seg > 0)) {  // padding keys: no query reads them
        for (int e = tid; e < nk * NC; e += NTH) {
            const long long at = (e / NC) * kvs + (e % NC) * 4;
            *reinterpret_cast<float4*>(dkb + at) = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(dvb + at) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        return;
    }
    stage_rows<BM, DH>(sk, kb, p.sks, nk, tid);
    stage_rows<BM, DH>(sv, vb, p.svs, nk, tid);
    tc::cp_async_commit();
    // queries of key j lie in [j, j + window] within j's segment. A tile
    // whose last key is padding holds only segments that end inside it.
    const int seg_last = kseg[nk - 1];
    if (seg_last == 0) {
        if (tid == 0) band_hi = k0 + nk;
    } else {
        for (int i = k0 + nk + tid; i < hi0; i += NTH)
            if (segc[i] != seg_last) atomicMin(&band_hi, i);
    }
    __syncthreads();
    {  // this warp's query span [lo, hi): from its first real key to the end
       // of its last real key's segment, at most window rows past that key
        const int j = warp * 16 + (lane & 15);
        const unsigned m = __ballot_sync(0xffffffffu, lane < 16 && kseg[j] > 0) & 0xffffu;
        if (lane == 0) {
            int lo = INT_MAX, hi = 0;
            if (m) {
                const int kf = warp * 16 + __ffs(m) - 1, kl = warp * 16 + 31 - __clz(m);
                const int s = kseg[kl];
                int end = band_hi;    // the block's last segment runs on past the tile
                if (s != seg_last) {  // a segment that ends inside the tile
                    int i = kl;
                    while (kseg[i + 1] == s) ++i;
                    end = k0 + i + 1;
                }
                lo = k0 + kf;
                hi = min(end, k0 + kl + win + 1);
            }
            wlo[warp] = lo;
            whi[warp] = hi;
        }
    }
    __syncthreads();
    int qbeg = INT_MAX, qend = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        qbeg = min(qbeg, wlo[w]);
        qend = max(qend, whi[w]);
    }
    const int nst = (qend - qbeg + BS - 1) / BS;  // sub-tiles a query head
    const int items = G * nst;
    const int lo_w = wlo[warp], hi_w = whi[warp];

    auto load_item = [&](int item, int buf) {
        const int h = hk * G + item / nst, q0 = qbeg + (item % nst) * BS, qn = min(BS, S - q0);
        const float* qb = static_cast<const float*>(p.q) + c * p.sqc + q0 * p.sqs + (long long)h * DH;
        const float* gb = static_cast<const float*>(p.dout) + ((long long)c * S + q0) * rs +
                          (long long)h * DH;
        stage_rows<BS, DH>(sq + buf * BS * LD, qb, p.sqs, qn, tid);
        stage_rows<BS, DH>(sdo + buf * BS * LD, gb, rs, qn, tid);
        if (tid < BS) {
            const bool in = tid < qn;
            const long long at = ((long long)c * H + h) * S + q0 + (in ? tid : 0);
            cp_async4(&qseg[buf][tid], segc + q0 + (in ? tid : 0), in);
            cp_async4(&slse[buf][tid], p.lse + at, in);
            cp_async4(&sdl[buf][tid], p.delta + at, in);
        }
    };

    // this thread's key rows of the score tiles: warp·16 + rg + 4t (their
    // segment ids are read from shared memory where P and dS are formed)
    const int rg = lane >> 3, cg = lane & 7;
    const float sl2 = p.scale * LOG2E;
    const float* skw = sk + (warp * 16 + rg) * LD;
    const float* svw = sv + (warp * 16 + rg) * LD;
    float* spw = sp + warp * 16 * SP;
    const int rq = lane / CG, cq = lane % CG;

    float4 ak[QR][QC], av[QR][QC];
#pragma unroll
    for (int t = 0; t < QR; ++t)
#pragma unroll
        for (int u = 0; u < QC; ++u) ak[t][u] = av[t][u] = make_float4(0.f, 0.f, 0.f, 0.f);

    load_item(0, 0);
    tc::cp_async_commit();
    for (int it = 0; it < items; ++it) {
        const int buf = it & 1;
        tc::cp_async_wait<0>();  // this item (and k, v) have landed
        // one barrier an item: this item is seen by every warp, and every
        // warp is done with the last one, whose buffer the next item fills
        __syncthreads();
        if (it + 1 < items) load_item(it + 1, buf ^ 1);
        tc::cp_async_commit();
        const int q0 = qbeg + (it % nst) * BS;
        if (q0 < hi_w && q0 + BS > lo_w) {  // a sub-tile that attends this warp's keys
            const float* sqb = sq + buf * BS * LD;
            const float* sdob = sdo + buf * BS * LD;
            float s[4][2], dp[4][2], ds[4][2];
            scores<DH>(skw, svw, sqb + cg * LD, sdob + cg * LD, s, dp);
            // Pᵀ and dSᵀ = Pᵀ ⊙ (dPᵀ − Δ) on the attended pairs, key-major:
            // dV += Pᵀ · dO through the warp's tile, then dK += dSᵀ · Q
            // through the same tile
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int i = cg + 8 * u, query = q0 + i, qs = qseg[buf][i];
                const float l = slse[buf][i] * LOG2E, d = sdl[buf][i];
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    const int j = warp * 16 + rg + 4 * t, key = k0 + j;
                    const bool keep =
                        qs > 0 && qs == kseg[j] && key <= query && query - key <= win;
                    const float pr = exp2f(keep ? fmaf(s[t][u], sl2, -l) : -INFINITY);
                    spw[(rg + 4 * t) * SP + i] = pr;
                    ds[t][u] = pr * (dp[t][u] - d);
                }
            }
            __syncwarp();
            mix<DH>(spw, sdob, rq, cq, av);
            __syncwarp();
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int t = 0; t < 4; ++t) spw[(rg + 4 * t) * SP + cg + 8 * u] = ds[t][u];
            __syncwarp();
            mix<DH>(spw, sqb, rq, cq, ak);
            __syncwarp();  // the tile is read before the next sub-tile writes it
        }
    }

    const float scale = p.scale;
#pragma unroll
    for (int t = 0; t < QR; ++t) {
        const int j = warp * 16 + rq + RG * t;
        if (j >= nk) continue;
#pragma unroll
        for (int u = 0; u < QC; ++u) {
            const long long at = j * kvs + 4 * (cq + CG * u);
            const float4 a = ak[t][u];
            *reinterpret_cast<float4*>(dkb + at) =
                make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
            *reinterpret_cast<float4*>(dvb + at) = av[t][u];
        }
    }
}

// Sets each pass's shared-memory limit (and the largest carve-out, so that
// three blocks share an SM); returns the first cudaError_t
template <int DH>
int prepare() {
    const int smem = (int)(sizeof(float) * smem_floats(DH));
    const void* fns[2] = {(const void*)dq_kernel<DH>, (const void*)dkv_kernel<DH>};
    cudaError_t err = cudaSuccess;
    for (const void* fn : fns) {
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
    }
    return (int)err;
}

template <int DH>
int launch(const BwdArgs& p, int C, cudaStream_t stream) {
    const int err = prepare<DH>();
    if (err != 0) return err;
    const int tiles = (p.S + BM - 1) / BM;
    const size_t smem = sizeof(float) * smem_floats(DH);
    // the dq pass writes Δ, which the dk/dv pass reads: same stream, in order
    dq_kernel<DH><<<dim3(tiles, p.H, C), NTH, smem, stream>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dkv_kernel<DH><<<dim3(tiles, p.Hkv, C), NTH, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// per pass (dq, then dk/dv): registers a thread, local (spilled) bytes a
// thread, dynamic and static shared bytes a block, blocks an SM can hold
template <int DH>
int info(int* out) {
    int err = prepare<DH>();
    if (err != 0) return err;
    const void* fns[2] = {(const void*)dq_kernel<DH>, (const void*)dkv_kernel<DH>};
    const int smem = (int)(sizeof(float) * smem_floats(DH));
    for (int k = 0; k < 2; ++k) {
        cudaFuncAttributes a;
        cudaError_t e = cudaFuncGetAttributes(&a, fns[k]);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5 * k + 4], fns[k], NTH, smem);
        if (e != cudaSuccess) return (int)e;
        out[5 * k] = a.numRegs;
        out[5 * k + 1] = (int)a.localSizeBytes;
        out[5 * k + 2] = smem;
        out[5 * k + 3] = (int)a.sharedSizeBytes;
    }
    return 0;
}

}  // namespace f32bwd
}  // namespace packed

// C interface, loaded with ctypes. q is [C, S, H, dh], k and v [C, S, Hkv,
// dh], float32, each with its heads contiguous (head stride dh, last stride
// 1) and 16-byte aligned rows: the pointers 16-byte aligned, the chunk-row
// and token strides (in elements) multiples of 4. o, dout and dq contiguous
// [C, S, H, dh]; dk, dv contiguous [C, S, Hkv, dh]; lse and delta contiguous
// float32 [C, H, S] (delta is scratch, overwritten); seg a contiguous int32
// [C, S]. window >= 0 bounds i - j (pass S - 1 for none); dh one of 16, 32,
// 64, 128. Launches the dq pass, then the dk/dv pass; returns the first
// cudaError_t (0 = cudaSuccess).
extern "C" int packed_attn_bwd_f32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, const int* seg, void* dq, void* dk, void* dv, float* delta,
    int C, int S, int H, int Hkv, int dh,
    long long sqc, long long sqs, long long skc, long long sks, long long svc, long long svs,
    int window, float scale, void* stream) {
    packed::BwdArgs p{q, k, v, o, dout, lse, seg, dq, dk, dv, delta, S, H, Hkv, window,
                      sqc, sqs, skc, sks, svc, svs, scale};
    auto st = static_cast<cudaStream_t>(stream);
    using namespace packed::f32bwd;
    switch (dh) {
        case 16: return launch<16>(p, C, st);
        case 32: return launch<32>(p, C, st);
        case 64: return launch<64>(p, C, st);
        case 128: return launch<128>(p, C, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The plan of both passes at head width dh: out[10] gets, for the dq pass
// then the dk/dv pass, registers a thread, spilled bytes a thread, dynamic
// and static shared bytes a block, and the blocks an SM holds at once.
extern "C" int packed_attn_bwd_f32_info(int dh, int* out) {
    using namespace packed::f32bwd;
    switch (dh) {
        case 16: return info<16>(out);
        case 32: return info<32>(out);
        case 64: return info<64>(out);
        case 128: return info<128>(out);
        default: return (int)cudaErrorInvalidValue;
    }
}

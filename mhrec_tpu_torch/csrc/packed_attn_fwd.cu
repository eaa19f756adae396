// packed_attn_fwd — forward of the packed (varlen) segment attention of the
// HLLM item tower on Hopper (sm_90a):
//     out[c, i, h] = softmax_j(q[c, i, h] · k[c, j, h / (H / Hkv)] / sqrt(dh)) · v[c, j, ...]
// over the keys j with j <= i, seg[c, j] == seg[c, i] > 0 and i - j <= window,
// for q [C, S, H, dh] and k, v [C, S, Hkv, dh] (float32 or bfloat16), segment
// ids [C, S] int32 (0 = padding). Softmax statistics and sums are float32;
// the output is [C, S, H, dh] in the input type. Rows of segment 0 are
// written as zeros. When asked (training), the kernel also writes each row's
// float32 log-sum-exp of its scaled scores, lse [C, H, S] (-inf on rows of
// segment 0): the residual splash's forward saves under its custom_vjp
// (save_residuals), which the backward (packed_attn_bwd.cu) reads.
//
// Replaces the TPU kernel reached by _splash_call
// (mhrec_tpu/models/llm/packed.py:45, JAX's splash attention with
// SegmentIds and a LocalMask band of width `window`), which the packed item
// tower runs once per layer per chunk row (packed_attention_splash, :64-72).
// GQA reads KV head h / (H / Hkv) directly, the jnp.repeat of llama.py:200-203
// without its copies.
//
// Precondition (pack_items guarantees it): each segment id occupies one
// contiguous run of a chunk row. The key band of a query tile then starts at
// max(q0 - window, start of q0's run), the band _splash_call bounds its grid
// with, so the work is O(S·window) rather than O(S²). The run start is found
// on the card from the segment ids, so no host synchronisation is needed.
//
// Bound on the H100: bytes. At the corpus shape (bf16, S = 2048, H = 32,
// Hkv = 4, dh = 64, window = 257) it reads q, k, v once and writes out once,
// against 4·dh flops per (query, key) pair of the band on the bf16 tensor
// cores: about 64 flops per byte, below the card's balance.
//
// Two routes, by the input type:
// * bfloat16 (the serving and training route; packed_attn_fwd_tc_kernel):
//   one block of 4 warps per (64-row query tile, query head, chunk row),
//   each warp owning 16 query rows. q is staged once, key and value tiles of
//   64 rows stream through a ring of two stages filled by 16-byte cp.async
//   (the next tile is in flight while this one is multiplied); tiles are
//   bf16 in shared memory, rows padded by 16 bytes (tc_bf16.cuh). S = Q·Kᵀ
//   and O += P·V run as mma.sync m16n8k16 with bf16 operands from ldmatrix
//   (V transposed on the way) and float32 accumulators. The mask, the scale
//   and the online softmax stay in float32 in registers: a row's statistics
//   live in the 4 lanes of a quad, m stays -inf until the row meets a key,
//   and P is rounded to bf16 once, as the plain version rounds its
//   probabilities to v's type, straight from the score accumulators into the
//   A fragments of P·V. The query heads of one KV head are neighbours in the
//   grid, so they read its K/V tiles from L2.
// * float32 (packed_attn_fwd_kernel) keeps every product in full float32 on
//   the CUDA cores (the tensor cores would take float32 as TF32): q is staged
//   once, key and value tiles of TK rows stream through shared memory in
//   float32, and an online softmax (running max and sum per row, in
//   registers) folds each tile into TQ·dh accumulators, 16 a thread. It is
//   bound by its FMAs out of shared memory.
#include "packed_attn_common.cuh"
#include "tc_bf16.cuh"

namespace packed {

__host__ __device__ constexpr int smem_floats(int dh) {
    return TQ * (dh + 1) + TK * (dh + 1) + TK * dh + TQ * (TK + 1);
}

// Thread (ty, tx) owns query rows ty + 16·r (r < RQ), score columns
// tx + 16·j (j < RK) of each key tile and output columns tx + 16·n (n < DH/16).
// Rows of q and k in shared memory are padded by one float, so the 16 lanes
// reading 16 different rows at one column hit 16 different banks.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
packed_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ seg,
                       T* __restrict__ out, float* __restrict__ lse, int S, int H, int Hkv,
                       long long sqc, long long sqs, long long skc, long long sks,
                       long long svc, long long svs, int window, float scale) {
    constexpr int LD = DH + 1;
    constexpr int NJ = DH / 16;
    extern __shared__ float smem[];
    float* sq = smem;                 // [TQ][LD]
    float* sk = sq + TQ * LD;         // [TK][LD]
    float* sv = sk + TK * LD;         // [TK][DH]
    float* sp = sv + TK * DH;         // [TQ][TK + 1] probabilities of one tile
    __shared__ int qseg[TQ], kseg[TK];
    __shared__ int band_lo;

    const int c = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int hk = h / (H / Hkv);
    const int* segc = seg + (long long)c * S;
    const int qn = min(TQ, S - q0);
    const T* qb = q + c * sqc + (long long)h * DH;
    const T* kb = k + c * skc + (long long)hk * DH;
    const T* vb = v + c * svc + (long long)hk * DH;

    const int lo0 = max(0, q0 - window);
    if (tid == 0) band_lo = lo0;
    const int my_seg = tid < qn ? segc[q0 + tid] : 0;  // NT >= TQ
    if (tid < TQ) qseg[tid] = my_seg;
    T* ob = out + ((long long)c * S * H + h) * DH;
    float* lb = lse == nullptr ? nullptr : lse + ((long long)c * H + h) * S + q0;
    if (!__syncthreads_or(my_seg > 0)) {  // a tile of padding rows: zeros
        for (int e = tid; e < qn * DH; e += NT)
            ob[(long long)(q0 + e / DH) * H * DH + e % DH] = from_f<T>(0.f);
        if (lb != nullptr && tid < qn) lb[tid] = -INFINITY;
        return;
    }
    for (int e = tid; e < TQ * DH; e += NT) {
        const int i = e / DH, d = e % DH;
        sq[i * LD + d] = i < qn ? to_f<T>(qb[(long long)(q0 + i) * sqs + d]) : 0.f;
    }
    __syncthreads();
    // the run holding row q0 starts after the last key before q0 whose
    // segment differs; keys before lo0 are outside every row's window
    const int seg0 = qseg[0];
    for (int j = lo0 + tid; j < q0; j += NT)
        if (segc[j] != seg0) atomicMax(&band_lo, j + 1);
    __syncthreads();
    const int kbeg = band_lo, kend = q0 + qn;

    float acc[RQ][NJ], m[RQ], l[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int n = 0; n < NJ; ++n) acc[r][n] = 0.f;
    }

    for (int k0 = kbeg; k0 < kend; k0 += TK) {
        const int nk = min(TK, kend - k0);
        __syncthreads();  // the previous tile's readers are done
        for (int e = tid; e < TK * DH; e += NT) {
            const int j = e / DH, d = e % DH;
            const bool in = j < nk;
            sk[j * LD + d] = in ? to_f<T>(kb[(long long)(k0 + j) * sks + d]) : 0.f;
            sv[j * DH + d] = in ? to_f<T>(vb[(long long)(k0 + j) * svs + d]) : 0.f;
        }
        for (int j = tid; j < TK; j += NT) kseg[j] = j < nk ? segc[k0 + j] : 0;
        __syncthreads();

        float s[RQ][RK];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
            for (int j = 0; j < RK; ++j) s[r][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
            float a[RQ], b[RK];
#pragma unroll
            for (int r = 0; r < RQ; ++r) a[r] = sq[(ty + 16 * r) * LD + d];
#pragma unroll
            for (int j = 0; j < RK; ++j) b[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
            for (int r = 0; r < RQ; ++r)
#pragma unroll
                for (int j = 0; j < RK; ++j) s[r][j] = fmaf(a[r], b[j], s[r][j]);
        }

#pragma unroll
        for (int r = 0; r < RQ; ++r) {
            const int i = ty + 16 * r, row = q0 + i, sg = qseg[i];
            float tmax = -INFINITY;
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const int jj = tx + 16 * j, col = k0 + jj;
                const bool keep = sg > 0 && kseg[jj] == sg && col <= row && row - col <= window;
                s[r][j] = keep ? s[r][j] * scale : -INFINITY;
                tmax = fmaxf(tmax, s[r][j]);
            }
            // the 16 lanes of one row are one half-warp
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
            const float mnew = fmaxf(m[r], tmax);
            // a row with no key yet keeps m = -inf: scale nothing, add nothing
            const bool none = mnew == -INFINITY;
            const float alpha = none ? 1.f : expf(m[r] - mnew);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const float p = none ? 0.f : expf(s[r][j] - mnew);
                sp[i * (TK + 1) + tx + 16 * j] = p;
                psum += p;
            }
            l[r] = l[r] * alpha + half_warp_sum(psum);
            m[r] = mnew;
#pragma unroll
            for (int n = 0; n < NJ; ++n) acc[r][n] *= alpha;
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < nk; ++j) {
            float b[NJ];
#pragma unroll
            for (int n = 0; n < NJ; ++n) b[n] = sv[j * DH + tx + 16 * n];
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
                const float p = sp[(ty + 16 * r) * (TK + 1) + j];
#pragma unroll
                for (int n = 0; n < NJ; ++n) acc[r][n] = fmaf(p, b[n], acc[r][n]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        const int i = ty + 16 * r;
        if (i >= qn) continue;
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // segment-0 rows: zeros
#pragma unroll
        for (int n = 0; n < NJ; ++n)
            ob[(long long)(q0 + i) * H * DH + tx + 16 * n] = from_f<T>(acc[r][n] * inv);
        // every lane of the row's half-warp holds the same m and l
        if (lb != nullptr && tx == 0) lb[i] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* seg, void* out,
           float* lse, int C, int S, int H, int Hkv, long long sqc, long long sqs, long long skc,
           long long sks, long long svc, long long svs, int window, float scale,
           cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)smem_floats(DH);
    cudaError_t err = cudaFuncSetAttribute(
        packed_attn_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + TQ - 1) / TQ, H, C);
    packed_attn_fwd_kernel<T, DH><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
        static_cast<T*>(out), lse, S, H, Hkv, sqc, sqs, skc, sks, svc, svs, window, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, const int* seg, void* out,
             float* lse, int C, int S, int H, int Hkv, long long sqc, long long sqs, long long skc,
             long long sks, long long svc, long long svs, int window, float scale,
             cudaStream_t st) {
    switch (dh) {
        case 16: return launch<T, 16>(q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                      svc, svs, window, scale, st);
        case 32: return launch<T, 32>(q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                      svc, svs, window, scale, st);
        case 64: return launch<T, 64>(q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                      svc, svs, window, scale, st);
        case 128: return launch<T, 128>(q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                        svc, svs, window, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---- the bfloat16 route: tensor-core kernel ---------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;
constexpr int TC_NT = 32 * TC_WARPS;  // threads a block
constexpr int TC_BM = 16 * TC_WARPS;  // query rows a block, 16 a warp
constexpr int TC_BN = 64;             // key rows of a streamed tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// out (and lse) of query rows [q0, q0 + TC_BM) of head h of chunk row c.
// Warp w owns query rows 16·w .. 16·w + 15 (its rows of sq are read by it
// alone); key and value tiles of TC_BN rows stream through a ring of two
// stages. Scores are kept in the log2 domain: x = s · scale · log2(e).
template <int DH>
__global__ void __launch_bounds__(TC_NT)
packed_attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ seg,
                          bf16* __restrict__ out, float* __restrict__ lse, int S, int H, int Hkv,
                          long long sqc, long long sqs, long long skc, long long sks,
                          long long svc, long long svs, int window, float scale) {
    constexpr int LD = DH + tc::PAD;
    constexpr int KS = DH / 16;     // depth steps of S
    constexpr int NB = TC_BN / 8;   // 8-key column blocks of a score tile
    constexpr int ND = DH / 8;      // 8-column blocks of out (16 bytes of bf16 each)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [TC_BM][LD]
    bf16* sk = sq + TC_BM * LD;                    // [2][TC_BN][LD]
    bf16* sv = sk + 2 * TC_BN * LD;                // [2][TC_BN][LD]
    __shared__ int qseg[TC_BM], kseg[2][TC_BN];
    __shared__ int band_lo;

    // the grid's x is the query head: the H / Hkv heads of one KV head run
    // side by side on the same tiles
    const int h = blockIdx.x, q0 = blockIdx.y * TC_BM, c = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int hk = h / (H / Hkv);
    const int* segc = seg + (long long)c * S;
    const int qn = min(TC_BM, S - q0);
    const bf16* qb = q + c * sqc + q0 * sqs + (long long)h * DH;
    const bf16* kb = k + c * skc + (long long)hk * DH;
    const bf16* vb = v + c * svc + (long long)hk * DH;
    const long long rs = (long long)H * DH;  // row stride of out
    bf16* ob = out + ((long long)c * S + q0) * rs + (long long)h * DH;
    float* lb = lse == nullptr ? nullptr : lse + ((long long)c * H + h) * S + q0;

    const int lo0 = max(0, q0 - window);
    if (tid == 0) band_lo = lo0;
    const int my_seg = tid < qn ? segc[q0 + tid] : 0;  // TC_NT >= TC_BM
    if (tid < TC_BM) qseg[tid] = my_seg;
    if (!__syncthreads_or(my_seg > 0)) {  // a tile of padding rows: zeros
        for (int e = tid; e < qn * ND; e += TC_NT)
            *reinterpret_cast<uint4*>(ob + (e / ND) * rs + (e % ND) * 8) = make_uint4(0, 0, 0, 0);
        if (lb != nullptr && tid < qn) lb[tid] = -INFINITY;
        return;
    }
    tc::stage_rows<TC_BM, DH, TC_NT>(sq, qb, sqs, qn, tid);
    tc::cp_async_commit();
    // the run holding row q0 starts after the last key before q0 whose
    // segment differs; keys before lo0 are outside every row's window
    const int seg0 = qseg[0];
    for (int j = lo0 + tid; j < q0; j += TC_NT)
        if (segc[j] != seg0) atomicMax(&band_lo, j + 1);
    __syncthreads();
    const int kbeg = band_lo, kend = q0 + qn;
    const int ntiles = (kend - kbeg + TC_BN - 1) / TC_BN;

    auto load_kv = [&](int tile, int buf) {
        const int k0 = kbeg + tile * TC_BN, nk = min(TC_BN, kend - k0);
        tc::stage_rows<TC_BN, DH, TC_NT>(sk + buf * TC_BN * LD, kb + k0 * sks, sks, nk, tid);
        tc::stage_rows<TC_BN, DH, TC_NT>(sv + buf * TC_BN * LD, vb + k0 * svs, svs, nk, tid);
        if (tid < TC_BN) kseg[buf][tid] = tid < nk ? segc[k0 + tid] : 0;
    };
    load_kv(0, 0);
    tc::cp_async_commit();

    // this thread's rows of every score tile: ra and ra + 8 of the block
    const int ra = warp * 16 + g, rb = ra + 8;
    const int rowa = q0 + ra, rowb = q0 + rb;
    const int sga = qseg[ra], sgb = qseg[rb];
    const float sl2 = scale * LOG2E;
    const bf16* sqw = sq + warp * 16 * LD;
    // the warp's first and last query rows: a key tile that none of them
    // reaches (past the diagonal, or more than window before) adds nothing
    const int wfirst = q0 + warp * 16, wlast = wfirst + 15;

    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    // running max (log2 domain) of rows ra, rb, and this lane's part of
    // their running sums (the quad's four parts are summed at the end)
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lsb = 0.f;

    for (int tile = 0; tile < ntiles; ++tile) {
        const int buf = tile & 1;
        if (tile + 1 < ntiles) load_kv(tile + 1, buf ^ 1);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // this tile (and q) have landed
        __syncthreads();
        const int k0 = kbeg + tile * TC_BN;
        if (k0 <= wlast && wfirst - (k0 + TC_BN - 1) <= window) {
            const bf16* skb = sk + buf * TC_BN * LD;
            const bf16* svb = sv + buf * TC_BN * LD;
            const int* ks = kseg[buf];
            float s[NB][4];
#pragma unroll
            for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                uint32_t a[4];
                tc::ld_a(a, sqw, LD, kk * 16, lane);
#pragma unroll
                for (int np = 0; np < NB / 2; ++np) {
                    uint32_t b[4];
                    tc::ld_b_nk(b, skb, LD, np * 16, kk * 16, lane);
                    tc::mma(s[2 * np], a, b[0], b[1]);
                    tc::mma(s[2 * np + 1], a, b[2], b[3]);
                }
            }
            // mask and scale; the tile's row maxima over the quad
            float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
            for (int n = 0; n < NB; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int j = n * 8 + 2 * t4 + (e & 1), col = k0 + j;
                    const int row = e < 2 ? rowa : rowb, sg = e < 2 ? sga : sgb;
                    const bool keep = sg > 0 && ks[j] == sg && col <= row && row - col <= window;
                    s[n][e] = keep ? s[n][e] * sl2 : -INFINITY;
                    if (e < 2) xa = fmaxf(xa, s[n][e]);
                    else xb = fmaxf(xb, s[n][e]);
                }
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
                xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, o));
                xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, o));
            }
            const float mna = fmaxf(ma, xa), mnb = fmaxf(mb, xb);
            // a row with no key yet keeps m = -inf; subtracting 0 then makes
            // every exp2 below exactly 0, never exp2(-inf + inf)
            const float ca = mna == -INFINITY ? 0.f : mna, cb = mnb == -INFINITY ? 0.f : mnb;
            const float aa = exp2f(ma - ca), ab = exp2f(mb - cb);
            ma = mna;
            mb = mnb;
            la *= aa;
            lsb *= ab;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                acc[n][0] *= aa;
                acc[n][1] *= aa;
                acc[n][2] *= ab;
                acc[n][3] *= ab;
            }
            // P rounded to bf16 as the A fragments of P·V (depth: the tile's keys)
            uint32_t pa[TC_BN / 16][4];
#pragma unroll
            for (int n = 0; n < NB; ++n) {
                const float p0 = exp2f(s[n][0] - ca), p1 = exp2f(s[n][1] - ca);
                const float p2 = exp2f(s[n][2] - cb), p3 = exp2f(s[n][3] - cb);
                la += p0 + p1;
                lsb += p2 + p3;
                pa[n >> 1][(n & 1) * 2] = tc::pack_bf16(p0, p1);
                pa[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(p2, p3);
            }
#pragma unroll
            for (int kk = 0; kk < TC_BN / 16; ++kk)
#pragma unroll
                for (int np = 0; np < DH / 16; ++np) {
                    uint32_t b[4];
                    tc::ld_b_kn(b, svb, LD, kk * 16, np * 16, lane);
                    tc::mma(acc[2 * np], pa[kk], b[0], b[1]);
                    tc::mma(acc[2 * np + 1], pa[kk], b[2], b[3]);
                }
        }
        __syncthreads();  // the readers of this stage are done before it is refilled
    }

#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        la += __shfl_xor_sync(0xffffffffu, la, o);
        lsb += __shfl_xor_sync(0xffffffffu, lsb, o);
    }
    // out = acc / l rounded once, through this warp's rows of sq, so that the
    // stores are 16 bytes a lane; rows that met no key (segment 0) get zeros
    const float ia = la > 0.f ? 1.f / la : 0.f, ib = lsb > 0.f ? 1.f / lsb : 0.f;
    bf16* st = sq + warp * 16 * LD;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(st + g * LD + col) =
            tc::pack_bf16(acc[n][0] * ia, acc[n][1] * ia);
        *reinterpret_cast<uint32_t*>(st + (g + 8) * LD + col) =
            tc::pack_bf16(acc[n][2] * ib, acc[n][3] * ib);
    }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * ND; e += 32) {
        const int r = e / ND, ch = e % ND, row = warp * 16 + r;
        if (row < qn)
            *reinterpret_cast<uint4*>(ob + row * rs + ch * 8) =
                *reinterpret_cast<const uint4*>(st + r * LD + ch * 8);
    }
    if (lb != nullptr && t4 == 0) {
        if (ra < qn) lb[ra] = la > 0.f ? (ma + log2f(la)) * LN2 : -INFINITY;
        if (rb < qn) lb[rb] = lsb > 0.f ? (mb + log2f(lsb)) * LN2 : -INFINITY;
    }
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, const int* seg, void* out,
              float* lse, int C, int S, int H, int Hkv, long long sqc, long long sqs,
              long long skc, long long sks, long long svc, long long svs, int window,
              float scale, cudaStream_t stream) {
    const size_t smem = sizeof(bf16) * (size_t)(TC_BM + 4 * TC_BN) * (DH + tc::PAD);
    cudaError_t err = cudaFuncSetAttribute(
        packed_attn_fwd_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(H, (S + TC_BM - 1) / TC_BM, C);
    packed_attn_fwd_tc_kernel<DH><<<grid, TC_NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        seg, static_cast<bf16*>(out), lse, S, H, Hkv, sqc, sqs, skc, sks, svc, svs, window,
        scale);
    return (int)cudaGetLastError();
}

inline int dispatch_tc(int dh, const void* q, const void* k, const void* v, const int* seg,
                       void* out, float* lse, int C, int S, int H, int Hkv, long long sqc,
                       long long sqs, long long skc, long long sks, long long svc, long long svs,
                       int window, float scale, cudaStream_t st) {
    switch (dh) {
        case 16: return launch_tc<16>(q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                      svc, svs, window, scale, st);
        case 32: return launch_tc<32>(q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                      svc, svs, window, scale, st);
        case 64: return launch_tc<64>(q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                      svc, svs, window, scale, st);
        case 128: return launch_tc<128>(q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc,
                                        sks, svc, svs, window, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace packed

// C interface, loaded with ctypes. q is [C, S, H, dh], k and v [C, S, Hkv, dh],
// each with its heads contiguous (head stride dh, last stride 1); the strides
// of the chunk-row and token dimensions are in elements. seg is a contiguous
// int32 [C, S]; out a contiguous [C, S, H, dh]; lse a contiguous float32
// [C, H, S], or null to skip it. window >= 0 bounds i - j (pass S - 1 for
// none). dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernel, which also needs q, k, v 16-byte aligned and their
// chunk-row and token strides multiples of 8); dh one of 16, 32, 64, 128.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int packed_attn_fwd(
    const void* q, const void* k, const void* v, const int* seg, void* out, float* lse,
    int C, int S, int H, int Hkv, int dh,
    long long sqc, long long sqs, long long skc, long long sks, long long svc, long long svs,
    int window, float scale, int dtype, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return packed::dispatch_tc(dh, q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                   svc, svs, window, scale, st);
    if (dtype == 0)
        return packed::dispatch<float>(dh, q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                       svc, svs, window, scale, st);
    return (int)cudaErrorInvalidValue;
}

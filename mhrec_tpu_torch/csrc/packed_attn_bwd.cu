// packed_attn_bwd — backward of the packed (varlen) segment attention of the
// HLLM item tower (packed_attn_fwd.cu) on Hopper (sm_90a). With
//     P[i, j] = exp(scale · q_i·k_j − lse_i)   (the forward's probabilities)
//     dP[i, j] = dO_i·v_j,   Δ_i = Σ_d dO[i, d]·O[i, d],
//     dS = P ⊙ (dP − Δ)
// it computes dq_i = scale · Σ_j dS[i, j] k_j, dk_j = scale · Σ_i dS[i, j] q_i
// and dv_j = Σ_i P[i, j] dO_i over the pairs the forward attends (key j ≤ i
// of query i's segment > 0, i − j ≤ window); dk and dv of a KV head sum over
// the H / Hkv query heads that read it. q, dq [C, S, H, dh], k, v, dk, dv
// [C, S, Hkv, dh] (float32 or bfloat16), o and dO [C, S, H, dh] contiguous,
// lse [C, H, S] float32 from the forward, segment ids [C, S] int32.
// Products accumulate and statistics are kept in float32; dq, dk, dv come out
// in the input type.
// Rows of segment 0 get dq = 0, keys no real query attends get dk = dv = 0,
// and exp(· − lse) is never formed where lse = −inf.
//
// Replaces the two TPU kernels of the splash attention's custom_vjp that
// _splash_call (mhrec_tpu/models/llm/packed.py:45) differentiates through:
// _splash_attention_bwd_dq (pallas_call at jax/experimental/pallas/ops/tpu/
// splash_attention/splash_attention_kernel.py:1635) and
// _splash_attention_bwd_dkv (:2196). Like splash (which computes Δ with jnp
// outside its kernels), two passes: the dq pass also writes Δ to a float32
// [C, H, S] scratch, which the dk/dv pass, launched after it on the same
// stream, reads.
//
// Design (as hstu_attn_bwd.cuh): no state carried between blocks and no
// atomics on the outputs, so a repeat gives the same bits. The dq pass has
// one block per (query tile, query head, chunk row) and walks the key tiles
// of the band [i − window, i] within the tile's segments, found on the card
// as the forward finds it. The dk/dv pass has one block per (key tile, KV
// head, chunk row); it walks, for each of the KV head's query heads, the
// query tiles from the key tile to the end of its last key's segment (at
// most window rows past it), so GQA needs neither atomics nor a repeat. Both
// passes recompute the scores.
//
// Bound on the H100: bytes. At the corpus shape (bf16, 16 chunk rows of 2048
// tokens, H = 32 over Hkv = 4, dh = 64, band 257, 22,980 real tokens) reading
// q, k, v, o, dO, lse and the segment ids once and writing dq, dk, dv once
// takes 0.1816 ms at 3.35 TB/s, against 0.042 ms for the band's 10·dh flops
// a pair and head (S and dP recomputed, dq, dk, dv) on the bf16 tensor cores.
//
// Two routes, by the input type:
// * bfloat16 (the training route; packed_attn_bwd_{dq,dkv}_tc_kernel) runs
//   all five products on the tensor cores (mma.sync m16n8k16, bf16 operands
//   fed by ldmatrix, float32 accumulators; tc_bf16.cuh): S = Q·Kᵀ, dP = dO·Vᵀ
//   and dQ += dS·K in the dq pass; Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV += Pᵀ·dO and
//   dK += dSᵀ·Q in the dk/dv pass, whose transposed scores land where Pᵀ and
//   dSᵀ are the A operands of the next products. The exp, the Δ subtraction
//   and the mask stay float32 in registers; P and dS are rounded to bf16 once
//   to enter the next product, and the score accumulators become its A
//   fragments without a trip through shared memory. Tiles are bf16 in shared
//   memory (rows padded by 16 bytes, so ldmatrix meets no bank conflict),
//   copied with 16-byte cp.async into a ring of two stages: the next K/V
//   tile (dq pass) or Q/dO tile (dk/dv pass) is in flight while this one is
//   multiplied. Tiles with no attended pair are never loaded: every key
//   tile the dq pass visits lies in the band of its first row's segment or
//   on the diagonal, and every query tile the dk/dv pass visits in the band
//   of its last key's segment or on the diagonal (each segment is one run),
//   so the loops need no test of their own. 4 warps a block, each owning 16
//   rows of the block's own tile (query rows, resp. key rows); the dk/dv
//   pass streams query tiles of 64 rows (32 at dh = 128, to keep dK, dV and
//   the scores in registers). The dq pass stages each K/V tile once per
//   query head: serving a KV head's 8 query heads from one staged tile would
//   multiply its dq accumulators, and it already holds 166 registers a
//   thread at dh = 64 (251 at dh = 128).
// * float32 runs the CUDA-core kernels below (packed_attn_bwd_{dq,dkv}_kernel),
//   which keep every product in full float32: the tensor cores would take
//   float32 as TF32. They are bound by their FMAs out of shared memory.
#include "packed_attn_common.cuh"
#include "tc_bf16.cuh"

namespace packed {

// Pointers and strides of one backward call; strides in elements
struct BwdArgs {
    const void* q;        // [C, S, H, dh], chunk-row / token strides sqc, sqs
    const void* k;        // [C, S, Hkv, dh], skc, sks
    const void* v;        // [C, S, Hkv, dh], svc, svs
    const void* o;        // [C, S, H, dh] contiguous
    const void* dout;     // [C, S, H, dh] contiguous
    const float* lse;     // [C, H, S]
    const int* seg;       // [C, S]
    void* dq;             // [C, S, H, dh] contiguous
    void* dk;             // [C, S, Hkv, dh] contiguous
    void* dv;             // [C, S, Hkv, dh] contiguous
    float* delta;         // [C, H, S] scratch: written by the dq pass
    int S, H, Hkv, window;
    long long sqc, sqs, skc, sks, svc, svs;
    float scale;
};

// floats of dynamic shared memory of each pass: q and dO tiles, k and v
// tiles (rows padded by one float), and one or two score tiles
__host__ __device__ constexpr int dq_smem_floats(int dh) {
    return 2 * TQ * (dh + 1) + 2 * TK * (dh + 1) + TQ * (TK + 1);
}
__host__ __device__ constexpr int dkv_smem_floats(int dh) {
    return 2 * TQ * (dh + 1) + 2 * TK * (dh + 1) + 2 * TK * (TQ + 1);
}

// dq of query rows [q0, q0 + TQ) of head h of chunk row c; Δ of those rows.
// Thread (ty, tx) owns query rows ty + 16·r, key columns tx + 16·j of a
// score tile and dq columns tx + 16·n.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) packed_attn_bwd_dq_kernel(BwdArgs p) {
    constexpr int LD = DH + 1;
    constexpr int NJ = DH / 16;
    extern __shared__ float smem[];
    float* sq = smem;                 // [TQ][LD]
    float* sdo = sq + TQ * LD;        // [TQ][LD]
    float* sk = sdo + TQ * LD;        // [TK][LD]
    float* sv = sk + TK * LD;         // [TK][LD]
    float* sds = sv + TK * LD;        // [TQ][TK + 1] dS of one tile
    __shared__ int qseg[TQ], kseg[TK];
    __shared__ int band_lo;

    const int S = p.S, H = p.H;
    const int c = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int hk = h / (H / p.Hkv);
    const int* segc = p.seg + (long long)c * S;
    const int qn = min(TQ, S - q0);
    const T* qb = static_cast<const T*>(p.q) + c * p.sqc + (long long)h * DH;
    const T* kb = static_cast<const T*>(p.k) + c * p.skc + (long long)hk * DH;
    const T* vb = static_cast<const T*>(p.v) + c * p.svc + (long long)hk * DH;
    const long long rs = (long long)H * DH;                  // row stride of o, dO, dq
    const long long base = ((long long)c * S * H + h) * DH;  // (c, 0, h, 0)
    const T* ob = static_cast<const T*>(p.o) + base;
    const T* gb = static_cast<const T*>(p.dout) + base;
    T* dqb = static_cast<T*>(p.dq) + base;
    const float* lseb = p.lse + ((long long)c * H + h) * S + q0;
    float* deltab = p.delta + ((long long)c * H + h) * S + q0;

    const int lo0 = max(0, q0 - p.window);
    if (tid == 0) band_lo = lo0;
    const int my_seg = tid < qn ? segc[q0 + tid] : 0;  // NT >= TQ
    if (tid < TQ) qseg[tid] = my_seg;
    if (!__syncthreads_or(my_seg > 0)) {  // a tile of padding rows
        for (int e = tid; e < qn * DH; e += NT)
            dqb[(long long)(q0 + e / DH) * rs + e % DH] = from_f<T>(0.f);
        if (tid < qn) deltab[tid] = 0.f;
        return;
    }
    for (int e = tid; e < TQ * DH; e += NT) {
        const int i = e / DH, d = e % DH;
        const bool in = i < qn;
        sq[i * LD + d] = in ? to_f<T>(qb[(long long)(q0 + i) * p.sqs + d]) : 0.f;
        sdo[i * LD + d] = in ? to_f<T>(gb[(long long)(q0 + i) * rs + d]) : 0.f;
    }
    __syncthreads();
    // the band starts after the last key before q0 whose segment differs
    // from row q0's (packed_attn_fwd.cu)
    const int seg0 = qseg[0];
    for (int j = lo0 + tid; j < q0; j += NT)
        if (segc[j] != seg0) atomicMax(&band_lo, j + 1);
    // Δ and lse of this thread's rows
    float dl[RQ], ls[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        const int i = ty + 16 * r;
        float part = 0.f;
        if (i < qn) {
#pragma unroll
            for (int n = 0; n < NJ; ++n)
                part = fmaf(sdo[i * LD + tx + 16 * n],
                            to_f<T>(ob[(long long)(q0 + i) * rs + tx + 16 * n]), part);
        }
        dl[r] = half_warp_sum(part);
        ls[r] = i < qn ? lseb[i] : -INFINITY;
        if (tx == 0 && i < qn) deltab[i] = dl[r];
    }
    __syncthreads();
    const int kbeg = band_lo, kend = q0 + qn;
    const float scale = p.scale;

    float acc[RQ][NJ];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int n = 0; n < NJ; ++n) acc[r][n] = 0.f;

    for (int k0 = kbeg; k0 < kend; k0 += TK) {
        const int nk = min(TK, kend - k0);
        __syncthreads();  // the previous tile's readers are done
        for (int e = tid; e < TK * DH; e += NT) {
            const int j = e / DH, d = e % DH;
            const bool in = j < nk;
            sk[j * LD + d] = in ? to_f<T>(kb[(long long)(k0 + j) * p.sks + d]) : 0.f;
            sv[j * LD + d] = in ? to_f<T>(vb[(long long)(k0 + j) * p.svs + d]) : 0.f;
        }
        for (int j = tid; j < TK; j += NT) kseg[j] = j < nk ? segc[k0 + j] : 0;
        __syncthreads();

        float s[RQ][RK], dp[RQ][RK];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
            for (int j = 0; j < RK; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DH; ++d) {
            float a[RQ], g[RQ], b[RK], w[RK];
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
                a[r] = sq[(ty + 16 * r) * LD + d];
                g[r] = sdo[(ty + 16 * r) * LD + d];
            }
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                b[j] = sk[(tx + 16 * j) * LD + d];
                w[j] = sv[(tx + 16 * j) * LD + d];
            }
#pragma unroll
            for (int r = 0; r < RQ; ++r)
#pragma unroll
                for (int j = 0; j < RK; ++j) {
                    s[r][j] = fmaf(a[r], b[j], s[r][j]);
                    dp[r][j] = fmaf(g[r], w[j], dp[r][j]);
                }
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
            const int i = ty + 16 * r, row = q0 + i, sg = qseg[i];
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const int jj = tx + 16 * j, col = k0 + jj;
                const bool keep = sg > 0 && kseg[jj] == sg && col <= row && row - col <= p.window;
                float ds = 0.f;
                if (keep) ds = expf(s[r][j] * scale - ls[r]) * (dp[r][j] - dl[r]);
                sds[i * (TK + 1) + jj] = ds;
            }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < nk; ++j) {
            float b[NJ];
#pragma unroll
            for (int n = 0; n < NJ; ++n) b[n] = sk[j * LD + tx + 16 * n];
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
                const float d = sds[(ty + 16 * r) * (TK + 1) + j];
#pragma unroll
                for (int n = 0; n < NJ; ++n) acc[r][n] = fmaf(d, b[n], acc[r][n]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        const int i = ty + 16 * r;
        if (i >= qn) continue;
#pragma unroll
        for (int n = 0; n < NJ; ++n)
            dqb[(long long)(q0 + i) * rs + tx + 16 * n] = from_f<T>(acc[r][n] * scale);
    }
}

// dk and dv of key rows [k0, k0 + TK) of KV head hk of chunk row c, summed
// over its query heads. Thread (ty, tx) owns key rows ty + 16·r, query
// columns tx + 16·j of a score tile and dk/dv columns tx + 16·n.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) packed_attn_bwd_dkv_kernel(BwdArgs p) {
    constexpr int LD = DH + 1;
    constexpr int NJ = DH / 16;
    extern __shared__ float smem[];
    float* sk = smem;                 // [TK][LD]
    float* sv = sk + TK * LD;         // [TK][LD]
    float* sq = sv + TK * LD;         // [TQ][LD]
    float* sdo = sq + TQ * LD;        // [TQ][LD]
    float* sp = sdo + TQ * LD;        // [TK][TQ + 1] P of one tile, key-major
    float* sds = sp + TK * (TQ + 1);  // [TK][TQ + 1] dS of one tile
    __shared__ int kseg[TK], qseg[TQ];
    __shared__ float slse[TQ], sdl[TQ];
    __shared__ int band_hi;

    const int S = p.S, H = p.H, Hkv = p.Hkv, G = H / Hkv;
    const int c = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * TK;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int* segc = p.seg + (long long)c * S;
    const int nk = min(TK, S - k0);
    const T* kb = static_cast<const T*>(p.k) + c * p.skc + (long long)hk * DH;
    const T* vb = static_cast<const T*>(p.v) + c * p.svc + (long long)hk * DH;
    const long long kvs = (long long)Hkv * DH;  // row stride of dk, dv
    T* dkb = static_cast<T*>(p.dk) + ((long long)c * S * Hkv + hk) * DH;
    T* dvb = static_cast<T*>(p.dv) + ((long long)c * S * Hkv + hk) * DH;

    // queries of key j lie in [j, j + window] within j's segment, which ends
    // no later than the segment of the tile's last key
    const int hi0 = min(S, k0 + nk + p.window);
    if (tid == 0) band_hi = hi0;
    const int my_seg = tid < nk ? segc[k0 + tid] : 0;  // NT >= TK
    if (tid < TK) kseg[tid] = my_seg;
    if (!__syncthreads_or(my_seg > 0)) {  // padding keys: no query reads them
        for (int e = tid; e < nk * DH; e += NT) {
            const long long at = (long long)(k0 + e / DH) * kvs + e % DH;
            dkb[at] = from_f<T>(0.f);
            dvb[at] = from_f<T>(0.f);
        }
        return;
    }
    for (int e = tid; e < TK * DH; e += NT) {
        const int j = e / DH, d = e % DH;
        const bool in = j < nk;
        sk[j * LD + d] = in ? to_f<T>(kb[(long long)(k0 + j) * p.sks + d]) : 0.f;
        sv[j * LD + d] = in ? to_f<T>(vb[(long long)(k0 + j) * p.svs + d]) : 0.f;
    }
    const int seg_last = kseg[nk - 1];
    for (int i = k0 + nk + tid; i < hi0; i += NT)
        if (segc[i] != seg_last) atomicMin(&band_hi, i);
    __syncthreads();
    const int qend = band_hi;
    const float scale = p.scale;

    float ak[RK][NJ], av[RK][NJ];
#pragma unroll
    for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int n = 0; n < NJ; ++n) ak[r][n] = av[r][n] = 0.f;

    for (int h = hk * G; h < hk * G + G; ++h) {
        const T* qb = static_cast<const T*>(p.q) + c * p.sqc + (long long)h * DH;
        const long long rs = (long long)H * DH;
        const T* gb = static_cast<const T*>(p.dout) + ((long long)c * S * H + h) * DH;
        const float* lseb = p.lse + ((long long)c * H + h) * S;
        const float* deltab = p.delta + ((long long)c * H + h) * S;
        for (int q0 = k0; q0 < qend; q0 += TQ) {
            const int qn = min(TQ, qend - q0);
            __syncthreads();  // the previous tile's readers are done
            for (int e = tid; e < TQ * DH; e += NT) {
                const int i = e / DH, d = e % DH;
                const bool in = i < qn;
                sq[i * LD + d] = in ? to_f<T>(qb[(long long)(q0 + i) * p.sqs + d]) : 0.f;
                sdo[i * LD + d] = in ? to_f<T>(gb[(long long)(q0 + i) * rs + d]) : 0.f;
            }
            for (int i = tid; i < TQ; i += NT) {
                const bool in = i < qn;
                qseg[i] = in ? segc[q0 + i] : 0;
                slse[i] = in ? lseb[q0 + i] : -INFINITY;
                sdl[i] = in ? deltab[q0 + i] : 0.f;
            }
            __syncthreads();

            float s[RK][RQ], dp[RK][RQ];
#pragma unroll
            for (int r = 0; r < RK; ++r)
#pragma unroll
                for (int j = 0; j < RQ; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
            for (int d = 0; d < DH; ++d) {
                float a[RK], w[RK], b[RQ], g[RQ];
#pragma unroll
                for (int r = 0; r < RK; ++r) {
                    a[r] = sk[(ty + 16 * r) * LD + d];
                    w[r] = sv[(ty + 16 * r) * LD + d];
                }
#pragma unroll
                for (int j = 0; j < RQ; ++j) {
                    b[j] = sq[(tx + 16 * j) * LD + d];
                    g[j] = sdo[(tx + 16 * j) * LD + d];
                }
#pragma unroll
                for (int r = 0; r < RK; ++r)
#pragma unroll
                    for (int j = 0; j < RQ; ++j) {
                        s[r][j] = fmaf(a[r], b[j], s[r][j]);
                        dp[r][j] = fmaf(w[r], g[j], dp[r][j]);
                    }
            }
#pragma unroll
            for (int r = 0; r < RK; ++r) {
                const int jr = ty + 16 * r, col = k0 + jr, ks = kseg[jr];
#pragma unroll
                for (int j = 0; j < RQ; ++j) {
                    const int ii = tx + 16 * j, row = q0 + ii, sg = qseg[ii];
                    const bool keep = sg > 0 && ks == sg && col <= row && row - col <= p.window;
                    float pr = 0.f, ds = 0.f;
                    if (keep) {
                        pr = expf(s[r][j] * scale - slse[ii]);
                        ds = pr * (dp[r][j] - sdl[ii]);
                    }
                    sp[jr * (TQ + 1) + ii] = pr;
                    sds[jr * (TQ + 1) + ii] = ds;
                }
            }
            __syncthreads();
#pragma unroll 4
            for (int i = 0; i < qn; ++i) {
                float g[NJ], b[NJ];
#pragma unroll
                for (int n = 0; n < NJ; ++n) {
                    g[n] = sdo[i * LD + tx + 16 * n];
                    b[n] = sq[i * LD + tx + 16 * n];
                }
#pragma unroll
                for (int r = 0; r < RK; ++r) {
                    const float pr = sp[(ty + 16 * r) * (TQ + 1) + i];
                    const float ds = sds[(ty + 16 * r) * (TQ + 1) + i];
#pragma unroll
                    for (int n = 0; n < NJ; ++n) {
                        av[r][n] = fmaf(pr, g[n], av[r][n]);
                        ak[r][n] = fmaf(ds, b[n], ak[r][n]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RK; ++r) {
        const int j = ty + 16 * r;
        if (j >= nk) continue;
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
            const long long at = (long long)(k0 + j) * kvs + tx + 16 * n;
            dkb[at] = from_f<T>(ak[r][n] * scale);
            dvb[at] = from_f<T>(av[r][n]);
        }
    }
}

template <typename T, int DH>
int launch(const BwdArgs& p, int C, cudaStream_t stream) {
    const size_t smem_dq = sizeof(float) * (size_t)dq_smem_floats(DH);
    const size_t smem_dkv = sizeof(float) * (size_t)dkv_smem_floats(DH);
    cudaError_t err = cudaFuncSetAttribute(packed_attn_bwd_dq_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_dq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(packed_attn_bwd_dkv_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
    if (err != cudaSuccess) return (int)err;
    // the dq pass writes Δ, which the dk/dv pass reads: same stream, in order
    packed_attn_bwd_dq_kernel<T, DH>
        <<<dim3((p.S + TQ - 1) / TQ, p.H, C), NT, smem_dq, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    packed_attn_bwd_dkv_kernel<T, DH>
        <<<dim3((p.S + TK - 1) / TK, p.Hkv, C), NT, smem_dkv, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const BwdArgs& p, int C, cudaStream_t st) {
    switch (dh) {
        case 16: return launch<T, 16>(p, C, st);
        case 32: return launch<T, 32>(p, C, st);
        case 64: return launch<T, 64>(p, C, st);
        case 128: return launch<T, 128>(p, C, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---- the bfloat16 route: tensor-core kernels --------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;
constexpr int TC_NT = 32 * TC_WARPS;  // threads a block
constexpr int TC_BM = 16 * TC_WARPS;  // rows of a block's own tile, 16 a warp
constexpr int TC_BN = 64;             // key rows of a streamed tile (dq pass)
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TC_NT == 2 * TC_BM, "the dq pass sums Δ with two threads a row");

// query rows of a streamed tile of the dk/dv pass
template <int DH>
__host__ __device__ constexpr int tc_dkv_tq() { return DH == 128 ? 32 : 64; }

// dq of query rows [q0, q0 + TC_BM) of head h of chunk row c, and Δ of those
// rows. Warp w owns query rows 16·w .. 16·w + 15 (its rows of sq and sdo are
// read by it alone); key and value tiles of TC_BN rows stream through a ring
// of two stages.
template <int DH>
__global__ void __launch_bounds__(TC_NT) packed_attn_bwd_dq_tc_kernel(BwdArgs p) {
    constexpr int LD = DH + tc::PAD;
    constexpr int KS = DH / 16;     // depth steps of S and dP
    constexpr int NB = TC_BN / 8;   // 8-key column blocks of a score tile
    constexpr int ND = DH / 8;      // 8-column blocks of dq
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [TC_BM][LD]
    bf16* sdo = sq + TC_BM * LD;                   // [TC_BM][LD]
    bf16* sk = sdo + TC_BM * LD;                   // [2][TC_BN][LD]
    bf16* sv = sk + 2 * TC_BN * LD;                // [2][TC_BN][LD]
    __shared__ int qseg[TC_BM], kseg[2][TC_BN];
    __shared__ float slse[TC_BM], sdl[TC_BM];
    __shared__ int band_lo;

    const int S = p.S, H = p.H;
    const int c = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TC_BM;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int hk = h / (H / p.Hkv);
    const int* segc = p.seg + (long long)c * S;
    const int qn = min(TC_BM, S - q0);
    const bf16* qb = static_cast<const bf16*>(p.q) + c * p.sqc + q0 * p.sqs + (long long)h * DH;
    const bf16* kb = static_cast<const bf16*>(p.k) + c * p.skc + (long long)hk * DH;
    const bf16* vb = static_cast<const bf16*>(p.v) + c * p.svc + (long long)hk * DH;
    const long long rs = (long long)H * DH;                               // row stride of o, dO, dq
    const long long base = ((long long)c * S + q0) * rs + (long long)h * DH;  // (c, q0, h, 0)
    const bf16* ob = static_cast<const bf16*>(p.o) + base;
    const bf16* gb = static_cast<const bf16*>(p.dout) + base;
    bf16* dqb = static_cast<bf16*>(p.dq) + base;
    const float* lseb = p.lse + ((long long)c * H + h) * S + q0;
    float* deltab = p.delta + ((long long)c * H + h) * S + q0;

    const int lo0 = max(0, q0 - p.window);
    if (tid == 0) band_lo = lo0;
    const int my_seg = tid < qn ? segc[q0 + tid] : 0;  // TC_NT >= TC_BM
    if (tid < TC_BM) qseg[tid] = my_seg;
    if (!__syncthreads_or(my_seg > 0)) {  // a tile of padding rows
        for (int e = tid; e < qn * (DH / 8); e += TC_NT)
            *reinterpret_cast<uint4*>(dqb + (e / (DH / 8)) * rs + (e % (DH / 8)) * 8) =
                make_uint4(0, 0, 0, 0);
        if (tid < qn) deltab[tid] = 0.f;
        return;
    }
    tc::stage_rows<TC_BM, DH, TC_NT>(sq, qb, p.sqs, qn, tid);
    tc::stage_rows<TC_BM, DH, TC_NT>(sdo, gb, rs, qn, tid);
    tc::cp_async_commit();
    // the band starts after the last key before q0 whose segment differs
    // from row q0's (packed_attn_fwd.cu)
    const int seg0 = qseg[0];
    for (int j = lo0 + tid; j < q0; j += TC_NT)
        if (segc[j] != seg0) atomicMax(&band_lo, j + 1);
    __syncthreads();
    const int kbeg = band_lo, kend = q0 + qn;
    const int ntiles = (kend - kbeg + TC_BN - 1) / TC_BN;

    auto load_kv = [&](int tile, int buf) {
        const int k0 = kbeg + tile * TC_BN, nk = min(TC_BN, kend - k0);
        tc::stage_rows<TC_BN, DH, TC_NT>(sk + buf * TC_BN * LD, kb + k0 * p.sks, p.sks, nk, tid);
        tc::stage_rows<TC_BN, DH, TC_NT>(sv + buf * TC_BN * LD, vb + k0 * p.svs, p.svs, nk, tid);
        if (tid < TC_BN) kseg[buf][tid] = tid < nk ? segc[k0 + tid] : 0;
    };
    load_kv(0, 0);  // in flight while Δ is summed
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // q and dO have landed
    __syncthreads();
    {  // Δ = rowsum(dO ⊙ O) in float32, two threads a row
        const int r = tid >> 1, half = tid & 1;
        float part = 0.f;
        if (r < qn) {
            const bf16* orow = ob + r * rs + half * (DH / 2);
            const bf16* grow = sdo + r * LD + half * (DH / 2);
#pragma unroll
            for (int ch = 0; ch < DH / 16; ++ch) {
                const uint4 ov = *reinterpret_cast<const uint4*>(orow + ch * 8);
                const uint4 gv = *reinterpret_cast<const uint4*>(grow + ch * 8);
                const bf16* o8 = reinterpret_cast<const bf16*>(&ov);
                const bf16* g8 = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    part = fmaf(__bfloat162float(g8[e]), __bfloat162float(o8[e]), part);
            }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (half == 0) {
            sdl[r] = part;
            slse[r] = r < qn ? lseb[r] * LOG2E : 0.f;
            if (r < qn) deltab[r] = part;
        }
    }
    __syncthreads();
    // this thread's rows of every score tile: ra and ra + 8 of the block
    const int ra = warp * 16 + g, rb = ra + 8;
    const int sga = qseg[ra], sgb = qseg[rb];
    const float la = slse[ra], lb = slse[rb], da = sdl[ra], db = sdl[rb];
    const float sl2 = p.scale * LOG2E;
    const bf16* sqw = sq + warp * 16 * LD;
    const bf16* sdow = sdo + warp * 16 * LD;

    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int tile = 0; tile < ntiles; ++tile) {
        const int buf = tile & 1;
        if (tile + 1 < ntiles) load_kv(tile + 1, buf ^ 1);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // this tile has landed
        __syncthreads();
        const int k0 = kbeg + tile * TC_BN;
        const bf16* skb = sk + buf * TC_BN * LD;
        const bf16* svb = sv + buf * TC_BN * LD;
        const int* ks = kseg[buf];
        float s[NB][4], dp[NB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            uint32_t a[4], ga[4];
            tc::ld_a(a, sqw, LD, kk * 16, lane);
            tc::ld_a(ga, sdow, LD, kk * 16, lane);
#pragma unroll
            for (int np = 0; np < NB / 2; ++np) {
                uint32_t b[4], w[4];
                tc::ld_b_nk(b, skb, LD, np * 16, kk * 16, lane);
                tc::ld_b_nk(w, svb, LD, np * 16, kk * 16, lane);
                tc::mma(s[2 * np], a, b[0], b[1]);
                tc::mma(s[2 * np + 1], a, b[2], b[3]);
                tc::mma(dp[2 * np], ga, w[0], w[1]);
                tc::mma(dp[2 * np + 1], ga, w[2], w[3]);
            }
        }
        // dS = P ⊙ (dP − Δ) on the attended pairs, rounded to bf16 as the
        // A fragments of dS·K (depth: the tile's keys)
        uint32_t dsa[TC_BN / 16][4];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = n * 8 + 2 * t4 + (e & 1), col = k0 + j;
                const int row = q0 + (e < 2 ? ra : rb), sg = e < 2 ? sga : sgb;
                const bool keep = sg > 0 && ks[j] == sg && col <= row && row - col <= p.window;
                const float x = keep ? fmaf(s[n][e], sl2, -(e < 2 ? la : lb)) : -INFINITY;
                ds[e] = exp2f(x) * (dp[n][e] - (e < 2 ? da : db));
            }
            dsa[n >> 1][(n & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
            dsa[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
        }
#pragma unroll
        for (int kk = 0; kk < TC_BN / 16; ++kk)
#pragma unroll
            for (int np = 0; np < DH / 16; ++np) {
                uint32_t b[4];
                tc::ld_b_kn(b, skb, LD, kk * 16, np * 16, lane);
                tc::mma(acc[2 * np], dsa[kk], b[0], b[1]);
                tc::mma(acc[2 * np + 1], dsa[kk], b[2], b[3]);
            }
        __syncthreads();  // the readers of this stage are done before it is refilled
    }

    // dq = scale · acc rounded once, through this warp's rows of sq, so that
    // the stores are 16 bytes a lane
    bf16* st = sq + warp * 16 * LD;
    const float scale = p.scale;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(st + g * LD + col) =
            tc::pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
        *reinterpret_cast<uint32_t*>(st + (g + 8) * LD + col) =
            tc::pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
    }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * (DH / 8); e += 32) {
        const int r = e / (DH / 8), ch = e % (DH / 8), row = warp * 16 + r;
        if (row < qn)
            *reinterpret_cast<uint4*>(dqb + row * rs + ch * 8) =
                *reinterpret_cast<const uint4*>(st + r * LD + ch * 8);
    }
}

// dk and dv of key rows [k0, k0 + TC_BM) of KV head hk of chunk row c,
// summed over its query heads. Warp w owns key rows 16·w .. 16·w + 15 (its
// rows of sk and sv are read by it alone); the work items (query head, query
// tile of TQ rows) stream their q, dO, lse and Δ through a ring of two
// stages, one item ahead across the heads.
template <int DH>
__global__ void __launch_bounds__(TC_NT) packed_attn_bwd_dkv_tc_kernel(BwdArgs p) {
    constexpr int LD = DH + tc::PAD;
    constexpr int TQ = tc_dkv_tq<DH>();
    constexpr int KS = DH / 16;  // depth steps of Sᵀ and dPᵀ
    constexpr int NB = TQ / 8;   // 8-query column blocks of a score tile
    constexpr int ND = DH / 8;   // 8-column blocks of dk, dv
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [TC_BM][LD]
    bf16* sv = sk + TC_BM * LD;                    // [TC_BM][LD]
    bf16* sq = sv + TC_BM * LD;                    // [2][TQ][LD]
    bf16* sdo = sq + 2 * TQ * LD;                  // [2][TQ][LD]
    __shared__ int kseg[TC_BM];
    __shared__ __align__(16) int qseg[2][TQ];
    __shared__ __align__(16) float slse[2][TQ], sdl[2][TQ];
    __shared__ int band_hi;

    const int S = p.S, H = p.H, Hkv = p.Hkv, G = H / Hkv;
    const int c = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * TC_BM;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int* segc = p.seg + (long long)c * S;
    const int nk = min(TC_BM, S - k0);
    const bf16* kb = static_cast<const bf16*>(p.k) + c * p.skc + k0 * p.sks + (long long)hk * DH;
    const bf16* vb = static_cast<const bf16*>(p.v) + c * p.svc + k0 * p.svs + (long long)hk * DH;
    const long long kvs = (long long)Hkv * DH;  // row stride of dk, dv
    const long long kvbase = ((long long)c * S + k0) * kvs + (long long)hk * DH;
    bf16* dkb = static_cast<bf16*>(p.dk) + kvbase;
    bf16* dvb = static_cast<bf16*>(p.dv) + kvbase;
    const long long rs = (long long)H * DH;  // row stride of dO

    const int hi0 = min(S, k0 + nk + p.window);
    if (tid == 0) band_hi = hi0;
    const int my_seg = tid < nk ? segc[k0 + tid] : 0;  // TC_NT >= TC_BM
    if (tid < TC_BM) kseg[tid] = my_seg;
    if (!__syncthreads_or(my_seg > 0)) {  // padding keys: no query reads them
        for (int e = tid; e < nk * (DH / 8); e += TC_NT) {
            const long long at = (e / (DH / 8)) * kvs + (e % (DH / 8)) * 8;
            *reinterpret_cast<uint4*>(dkb + at) = make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(dvb + at) = make_uint4(0, 0, 0, 0);
        }
        return;
    }
    tc::stage_rows<TC_BM, DH, TC_NT>(sk, kb, p.sks, nk, tid);
    tc::stage_rows<TC_BM, DH, TC_NT>(sv, vb, p.svs, nk, tid);
    tc::cp_async_commit();
    // queries of key j lie in [j, j + window] within j's segment. A tile
    // whose last key is padding holds only segments that end inside it.
    const int seg_last = kseg[nk - 1];
    if (seg_last == 0) {
        if (tid == 0) band_hi = k0 + nk;
    } else {
        for (int i = k0 + nk + tid; i < hi0; i += TC_NT)
            if (segc[i] != seg_last) atomicMin(&band_hi, i);
    }
    __syncthreads();
    const int qend = band_hi;
    const int nq = (qend - k0 + TQ - 1) / TQ;  // query tiles a head
    const int items = G * nq;

    auto load_item = [&](int item, int buf) {
        const int h = hk * G + item / nq, q0 = k0 + (item % nq) * TQ, qn = min(TQ, qend - q0);
        const bf16* qb = static_cast<const bf16*>(p.q) + c * p.sqc + q0 * p.sqs + (long long)h * DH;
        const bf16* gb = static_cast<const bf16*>(p.dout) + ((long long)c * S + q0) * rs +
                         (long long)h * DH;
        tc::stage_rows<TQ, DH, TC_NT>(sq + buf * TQ * LD, qb, p.sqs, qn, tid);
        tc::stage_rows<TQ, DH, TC_NT>(sdo + buf * TQ * LD, gb, rs, qn, tid);
        if (tid < TQ) {
            const bool in = tid < qn;
            const long long at = ((long long)c * H + h) * S + q0 + tid;
            qseg[buf][tid] = in ? segc[q0 + tid] : 0;
            slse[buf][tid] = in ? p.lse[at] * LOG2E : 0.f;
            sdl[buf][tid] = in ? p.delta[at] : 0.f;
        }
    };

    // this thread's key rows of every score tile: ra and ra + 8 of the block
    const int ra = warp * 16 + g, rb = ra + 8;
    const int ksa = kseg[ra], ksb = kseg[rb];
    const float sl2 = p.scale * LOG2E;
    const bf16* skw = sk + warp * 16 * LD;
    const bf16* svw = sv + warp * 16 * LD;

    float ak[ND][4], av[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

    load_item(0, 0);
    tc::cp_async_commit();
    for (int it = 0; it < items; ++it) {
        const int buf = it & 1;
        if (it + 1 < items) load_item(it + 1, buf ^ 1);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // this item (and k, v) have landed
        __syncthreads();
        const int q0 = k0 + (it % nq) * TQ;
        const bf16* sqb = sq + buf * TQ * LD;
        const bf16* sdob = sdo + buf * TQ * LD;
        const int* qs = qseg[buf];
        float s[NB][4], dp[NB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            uint32_t a[4], w[4];
            tc::ld_a(a, skw, LD, kk * 16, lane);
            tc::ld_a(w, svw, LD, kk * 16, lane);
#pragma unroll
            for (int np = 0; np < NB / 2; ++np) {
                uint32_t b[4], gq[4];
                tc::ld_b_nk(b, sqb, LD, np * 16, kk * 16, lane);
                tc::ld_b_nk(gq, sdob, LD, np * 16, kk * 16, lane);
                tc::mma(s[2 * np], a, b[0], b[1]);
                tc::mma(s[2 * np + 1], a, b[2], b[3]);
                tc::mma(dp[2 * np], w, gq[0], gq[1]);
                tc::mma(dp[2 * np + 1], w, gq[2], gq[3]);
            }
        }
        // Pᵀ and dSᵀ = Pᵀ ⊙ (dPᵀ − Δ) on the attended pairs, rounded to
        // bf16 as the A fragments of Pᵀ·dO and dSᵀ·Q (depth: the queries)
        uint32_t pa[TQ / 16][4], dsa[TQ / 16][4];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
            const int i = n * 8 + 2 * t4;  // query columns i, i + 1
            const int2 sg2 = *reinterpret_cast<const int2*>(qs + i);
            const float2 l2 = *reinterpret_cast<const float2*>(&slse[buf][i]);
            const float2 d2 = *reinterpret_cast<const float2*>(&sdl[buf][i]);
            float pr[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int query = q0 + i + (e & 1), key = k0 + (e < 2 ? ra : rb);
                const int sg = (e & 1) ? sg2.y : sg2.x, ksg = e < 2 ? ksa : ksb;
                const bool keep = sg > 0 && sg == ksg && key <= query && query - key <= p.window;
                const float x = keep ? fmaf(s[n][e], sl2, -((e & 1) ? l2.y : l2.x)) : -INFINITY;
                pr[e] = exp2f(x);
                ds[e] = pr[e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
            }
            pa[n >> 1][(n & 1) * 2] = tc::pack_bf16(pr[0], pr[1]);
            pa[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(pr[2], pr[3]);
            dsa[n >> 1][(n & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
            dsa[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
        }
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
#pragma unroll
            for (int np = 0; np < DH / 16; ++np) {
                uint32_t gq[4], b[4];
                tc::ld_b_kn(gq, sdob, LD, kk * 16, np * 16, lane);
                tc::ld_b_kn(b, sqb, LD, kk * 16, np * 16, lane);
                tc::mma(av[2 * np], pa[kk], gq[0], gq[1]);
                tc::mma(av[2 * np + 1], pa[kk], gq[2], gq[3]);
                tc::mma(ak[2 * np], dsa[kk], b[0], b[1]);
                tc::mma(ak[2 * np + 1], dsa[kk], b[2], b[3]);
            }
        __syncthreads();  // the readers of this stage are done before it is refilled
    }

    // dk = scale · ak and dv = av rounded once, through this warp's rows of
    // sk and sv, so that the stores are 16 bytes a lane
    bf16* stk = sk + warp * 16 * LD;
    bf16* stv = sv + warp * 16 * LD;
    const float scale = p.scale;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(stk + g * LD + col) =
            tc::pack_bf16(ak[n][0] * scale, ak[n][1] * scale);
        *reinterpret_cast<uint32_t*>(stk + (g + 8) * LD + col) =
            tc::pack_bf16(ak[n][2] * scale, ak[n][3] * scale);
        *reinterpret_cast<uint32_t*>(stv + g * LD + col) = tc::pack_bf16(av[n][0], av[n][1]);
        *reinterpret_cast<uint32_t*>(stv + (g + 8) * LD + col) = tc::pack_bf16(av[n][2], av[n][3]);
    }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * (DH / 8); e += 32) {
        const int r = e / (DH / 8), ch = e % (DH / 8), row = warp * 16 + r;
        if (row < nk) {
            const long long at = row * kvs + ch * 8;
            *reinterpret_cast<uint4*>(dkb + at) = *reinterpret_cast<const uint4*>(stk + r * LD + ch * 8);
            *reinterpret_cast<uint4*>(dvb + at) = *reinterpret_cast<const uint4*>(stv + r * LD + ch * 8);
        }
    }
}

template <int DH>
int launch_tc(const BwdArgs& p, int C, cudaStream_t stream) {
    constexpr int LD = DH + tc::PAD;
    const size_t smem_dq = sizeof(bf16) * (size_t)(2 * TC_BM + 4 * TC_BN) * LD;
    const size_t smem_dkv = sizeof(bf16) * (size_t)(2 * TC_BM + 4 * tc_dkv_tq<DH>()) * LD;
    cudaError_t err = cudaFuncSetAttribute(packed_attn_bwd_dq_tc_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_dq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(packed_attn_bwd_dkv_tc_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
    if (err != cudaSuccess) return (int)err;
    // the dq pass writes Δ, which the dk/dv pass reads: same stream, in order
    const int tiles = (p.S + TC_BM - 1) / TC_BM;
    packed_attn_bwd_dq_tc_kernel<DH><<<dim3(tiles, p.H, C), TC_NT, smem_dq, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    packed_attn_bwd_dkv_tc_kernel<DH><<<dim3(tiles, p.Hkv, C), TC_NT, smem_dkv, stream>>>(p);
    return (int)cudaGetLastError();
}

inline int dispatch_tc(int dh, const BwdArgs& p, int C, cudaStream_t st) {
    switch (dh) {
        case 16: return launch_tc<16>(p, C, st);
        case 32: return launch_tc<32>(p, C, st);
        case 64: return launch_tc<64>(p, C, st);
        case 128: return launch_tc<128>(p, C, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace packed

// C interface, loaded with ctypes. q is [C, S, H, dh], k and v [C, S, Hkv,
// dh], each with its heads contiguous (head stride dh, last stride 1), the
// chunk-row and token strides in elements; o, dout and dq contiguous [C, S,
// H, dh]; dk, dv contiguous [C, S, Hkv, dh]; lse and delta contiguous
// float32 [C, H, S] (delta is scratch, overwritten); seg a contiguous int32
// [C, S]. window >= 0 bounds i - j (pass S - 1 for none). dtype: 0 =
// float32 (the CUDA-core kernels), 1 = bfloat16 (the tensor-core kernels,
// which also need q, k, v, o and dout 16-byte aligned and their chunk-row and
// token strides multiples of 8); dh one of 16, 32, 64, 128. Launches the dq
// pass, then the dk/dv pass; returns the first cudaError_t (0 = cudaSuccess).
extern "C" int packed_attn_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, const int* seg, void* dq, void* dk, void* dv, float* delta,
    int C, int S, int H, int Hkv, int dh,
    long long sqc, long long sqs, long long skc, long long sks, long long svc, long long svs,
    int window, float scale, int dtype, void* stream) {
    packed::BwdArgs p{q, k, v, o, dout, lse, seg, dq, dk, dv, delta, S, H, Hkv, window,
                      sqc, sqs, skc, sks, svc, svs, scale};
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return packed::dispatch_tc(dh, p, C, st);
    if (dtype == 0) return packed::dispatch<float>(dh, p, C, st);
    return (int)cudaErrorInvalidValue;
}

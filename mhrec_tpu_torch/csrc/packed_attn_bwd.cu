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
// Products and sums are float32; dq, dk, dv come out in the input type.
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
// passes recompute the scores. Bound on the H100: bytes at the train shape
// (the band's 7·dh flops per pair against reading q, k, v, o, dO and lse and
// writing dq, dk, dv once); this first kernel runs its products as CUDA-core
// FMAs out of shared memory and is bound by them. Tensor cores are later
// work.
#include "packed_attn_common.cuh"

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

}  // namespace packed

// C interface, loaded with ctypes. q is [C, S, H, dh], k and v [C, S, Hkv,
// dh], each with its heads contiguous (head stride dh, last stride 1), the
// chunk-row and token strides in elements; o, dout and dq contiguous [C, S,
// H, dh]; dk, dv contiguous [C, S, Hkv, dh]; lse and delta contiguous
// float32 [C, H, S] (delta is scratch, overwritten); seg a contiguous int32
// [C, S]. window >= 0 bounds i - j (pass S - 1 for none). dtype: 0 =
// float32, 1 = bfloat16; dh one of 16, 32, 64, 128. Launches the dq pass,
// then the dk/dv pass; returns the first cudaError_t (0 = cudaSuccess).
extern "C" int packed_attn_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, const int* seg, void* dq, void* dk, void* dv, float* delta,
    int C, int S, int H, int Hkv, int dh,
    long long sqc, long long sqs, long long skc, long long sks, long long svc, long long svs,
    int window, float scale, int dtype, void* stream) {
    packed::BwdArgs p{q, k, v, o, dout, lse, seg, dq, dk, dv, delta, S, H, Hkv, window,
                      sqc, sqs, skc, sks, svc, svs, scale};
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return packed::dispatch<__nv_bfloat16>(dh, p, C, st);
    if (dtype == 0) return packed::dispatch<float>(dh, p, C, st);
    return (int)cudaErrorInvalidValue;
}

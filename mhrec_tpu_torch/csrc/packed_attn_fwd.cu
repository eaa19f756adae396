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
// Bound on the H100: operations. At the corpus shape (bf16, S = 2048, H = 32,
// Hkv = 4, dh = 64, window = 257) it reads q, k, v once and writes out once,
// against 4·dh flops per (query, key) pair of the band, about 64 flops per
// byte — below the card's bf16 balance, so a tensor-core kernel would be
// bound by bytes; this first kernel runs its products on CUDA cores and is
// bound by them (shared-memory reads feed two FMAs each). Design: one block
// per (query tile of TQ rows, head, chunk row); q is staged once, key and
// value tiles of TK rows stream through shared memory in float32, and an
// online softmax (running max and sum per row, in registers) folds each tile
// into TQ·dh accumulators, 16 a thread. Tensor cores and TMA are later work.
#include "packed_attn_common.cuh"

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

}  // namespace packed

// C interface, loaded with ctypes. q is [C, S, H, dh], k and v [C, S, Hkv, dh],
// each with its heads contiguous (head stride dh, last stride 1); the strides
// of the chunk-row and token dimensions are in elements. seg is a contiguous
// int32 [C, S]; out a contiguous [C, S, H, dh]; lse a contiguous float32
// [C, H, S], or null to skip it. window >= 0 bounds i - j (pass S - 1 for
// none). dtype: 0 = float32, 1 = bfloat16; dh one of 16, 32, 64,
// 128. Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int packed_attn_fwd(
    const void* q, const void* k, const void* v, const int* seg, void* out, float* lse,
    int C, int S, int H, int Hkv, int dh,
    long long sqc, long long sqs, long long skc, long long sks, long long svc, long long svs,
    int window, float scale, int dtype, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return packed::dispatch<__nv_bfloat16>(dh, q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs,
                                               skc, sks, svc, svs, window, scale, st);
    if (dtype == 0)
        return packed::dispatch<float>(dh, q, k, v, seg, out, lse, C, S, H, Hkv, sqc, sqs, skc, sks,
                                       svc, svs, window, scale, st);
    return (int)cudaErrorInvalidValue;
}

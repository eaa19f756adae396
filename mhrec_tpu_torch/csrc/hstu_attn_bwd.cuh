// Shared device code of the two HSTU backward kernels (hstu_attn_bwd.cu,
// hstu_stu_gated_bwd.cu): the backward of one head's pointwise attention
//     x = q kᵀ,  A = mask ⊙ silu(x) / n,  out = A v
// given the gradient g of out:
//     dv = Aᵀ g
//     ds = mask ⊙ (g vᵀ) ⊙ sig(x)(1 + x(1 − sig(x))) / n
//     dq = ds k,   dk = dsᵀ q
// with mask[i, j] = (j <= i) & nonpad[j].
//
// Numerics follow the JAX kernels (mhrec_tpu/ops/pallas/hstu_attention_tpu.py,
// _bwd_kernel_v2 and _bwd_gated_kernel): both products of the scores summed
// in f32, A rounded to the value type and ds to the query type before the
// three gradient products, which are summed in f32 and rounded to the
// input type on the way out.
//
// Design: two passes, each recomputing the scores, so that no two blocks
// write the same output row and no atomics are needed (the result does not
// depend on the block schedule). The dk/dv pass gives each block BT key
// rows of one head and walks the query tiles at or below the causal
// diagonal; the dq pass gives each block BT query rows and walks the key
// tiles up to its causal edge. Tiles live in shared memory as f32, rows
// padded by one float so the score loop reads them without bank conflicts;
// products are CUDA-core FMAs. Tensor cores and a single fused pass are
// later work.
#pragma once

#include "hstu_attn_common.cuh"

namespace hstu {

constexpr int BT = 32;                   // rows per block and per inner tile
constexpr int BMAXR = BT * MAX_D / NT;   // accumulators per thread per output

// Pointers and strides of one backward call. Inputs q, k, v, g; outputs
// gq, gk, gv (the gradients of q, k, v). Strides are in elements, per
// tensor (batch, head, row); the last dimension is contiguous.
struct BwdArgs {
    const void* q;
    const void* k;
    const void* v;
    const void* g;
    const unsigned char* nonpad;  // [B, L]
    void* gq;
    void* gk;
    void* gv;
    int H, L, dqk, dv;
    long long s[7][3];  // q, k, v, g, gq, gk, gv
    float inv_n;
};

// floats of shared memory a backward block needs
__host__ __device__ inline int bwd_smem_floats(int dqk, int dv) {
    return 2 * BT * (dqk + 1) + 2 * BT * (dv + 1) + 2 * BT * (BT + 1);
}

// Rows [r0, r0 + n) of one head (row stride ld) into a [BT][width + 1] f32
// tile; rows n..BT-1 are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long ld,
                                          int r0, int n, int width) {
    const int ldd = width + 1;
    for (int e = threadIdx.x; e < BT * width; e += NT) {
        const int i = e / width, c = e % width;
        dst[i * ldd + c] = i < n ? to_f<T>(src[(long long)(r0 + i) * ld + c]) : 0.f;
    }
}

__device__ __forceinline__ float dot_row(const float* a, const float* b, int n) {
    float d = 0.f;
    for (int c = 0; c < n; ++c) d = fmaf(a[c], b[c], d);
    return d;
}

// A and ds of one unmasked (query, key) pair, each rounded to T
template <typename T>
__device__ __forceinline__ void pair_grads(const float* q_i, const float* k_j, const float* g_i,
                                           const float* v_j, int dqk, int dv, float inv_n,
                                           float& a, float& ds) {
    const float x = dot_row(q_i, k_j, dqk);
    const float da = dot_row(g_i, v_j, dv);
    const float sig = 1.f / (1.f + expf(-x));
    a = to_f<T>(from_f<T>(x * sig * inv_n));
    ds = to_f<T>(from_f<T>(da * (sig * (1.f + x * (1.f - sig))) * inv_n));
}

template <typename T>
__device__ __forceinline__ const T* head_in(const void* base, const long long (&s)[3], int b, int h) {
    return static_cast<const T*>(base) + b * s[0] + h * s[1];
}

template <typename T>
__device__ __forceinline__ T* head_out(void* base, const long long (&s)[3], int b, int h) {
    return static_cast<T*>(base) + b * s[0] + h * s[1];
}

// dk and dv of key rows [k0, k0 + BT) of head (b, h).
template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dkdv_kernel(BwdArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
    const int tid = threadIdx.x, dqk = p.dqk, dv = p.dv, L = p.L;
    const int lq = dqk + 1, lv = dv + 1, ls = BT + 1;
    float* sk = smem;            // [BT][dqk + 1]
    float* sv = sk + BT * lq;    // [BT][dv + 1]
    float* sq = sv + BT * lv;    // [BT][dqk + 1]
    float* sg = sq + BT * lq;    // [BT][dv + 1]
    float* sa = sg + BT * lv;    // [BT][BT + 1]  A[i][j]
    float* sd = sa + BT * ls;    // [BT][BT + 1]  ds[i][j]
    const T* q = head_in<T>(p.q, p.s[0], b, h);
    const T* k = head_in<T>(p.k, p.s[1], b, h);
    const T* v = head_in<T>(p.v, p.s[2], b, h);
    const T* g = head_in<T>(p.g, p.s[3], b, h);
    const unsigned char* np = p.nonpad + (long long)b * L;

    const int nk = min(BT, L - k0);
    load_tile<T>(sk, k, p.s[1][2], k0, nk, dqk);
    load_tile<T>(sv, v, p.s[2][2], k0, nk, dv);
    float acc_k[BMAXR], acc_v[BMAXR];
#pragma unroll
    for (int r = 0; r < BMAXR; ++r) acc_k[r] = acc_v[r] = 0.f;

    for (int q0 = k0; q0 < L; q0 += BT) {  // query tiles at or below the diagonal
        const int nq = min(BT, L - q0);
        __syncthreads();  // the previous tile's readers are done
        load_tile<T>(sq, q, p.s[0][2], q0, nq, dqk);
        load_tile<T>(sg, g, p.s[3][2], q0, nq, dv);
        __syncthreads();
        for (int e = tid; e < BT * BT; e += NT) {
            const int i = e / BT, j = e % BT, row = q0 + i, col = k0 + j;
            float a = 0.f, ds = 0.f;
            if (i < nq && j < nk && col <= row && np[col])
                pair_grads<T>(sq + i * lq, sk + j * lq, sg + i * lv, sv + j * lv, dqk, dv,
                              p.inv_n, a, ds);
            sa[i * ls + j] = a;
            sd[i * ls + j] = ds;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < BMAXR; ++r) {
            const int e = tid + r * NT;
            if (e < BT * dv) {
                const int j = e / dv, c = e % dv;
                float s = acc_v[r];
                for (int i = 0; i < nq; ++i) s = fmaf(sa[i * ls + j], sg[i * lv + c], s);
                acc_v[r] = s;
            }
            if (e < BT * dqk) {
                const int j = e / dqk, c = e % dqk;
                float s = acc_k[r];
                for (int i = 0; i < nq; ++i) s = fmaf(sd[i * ls + j], sq[i * lq + c], s);
                acc_k[r] = s;
            }
        }
    }
    T* gk = head_out<T>(p.gk, p.s[5], b, h);
    T* gv = head_out<T>(p.gv, p.s[6], b, h);
#pragma unroll
    for (int r = 0; r < BMAXR; ++r) {
        const int e = tid + r * NT;
        if (e < BT * dv && e / dv < nk)
            gv[(long long)(k0 + e / dv) * p.s[6][2] + e % dv] = from_f<T>(acc_v[r]);
        if (e < BT * dqk && e / dqk < nk)
            gk[(long long)(k0 + e / dqk) * p.s[5][2] + e % dqk] = from_f<T>(acc_k[r]);
    }
}

// dq of query rows [q0, q0 + BT) of head (b, h).
template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(BwdArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
    const int tid = threadIdx.x, dqk = p.dqk, dv = p.dv, L = p.L;
    const int lq = dqk + 1, lv = dv + 1, ls = BT + 1;
    float* sk = smem;
    float* sv = sk + BT * lq;
    float* sq = sv + BT * lv;
    float* sg = sq + BT * lq;
    float* sd = sg + BT * lv + BT * ls;  // the dk/dv pass's ds slot
    const T* q = head_in<T>(p.q, p.s[0], b, h);
    const T* k = head_in<T>(p.k, p.s[1], b, h);
    const T* v = head_in<T>(p.v, p.s[2], b, h);
    const T* g = head_in<T>(p.g, p.s[3], b, h);
    const unsigned char* np = p.nonpad + (long long)b * L;

    const int nq = min(BT, L - q0);
    load_tile<T>(sq, q, p.s[0][2], q0, nq, dqk);
    load_tile<T>(sg, g, p.s[3][2], q0, nq, dv);
    float acc[BMAXR];
#pragma unroll
    for (int r = 0; r < BMAXR; ++r) acc[r] = 0.f;

    const int kend = min(L, q0 + BT);  // causal edge of this query tile
    for (int k0 = 0; k0 < kend; k0 += BT) {
        const int nk = min(BT, kend - k0);
        __syncthreads();
        load_tile<T>(sk, k, p.s[1][2], k0, nk, dqk);
        load_tile<T>(sv, v, p.s[2][2], k0, nk, dv);
        __syncthreads();
        for (int e = tid; e < BT * BT; e += NT) {
            const int i = e / BT, j = e % BT, row = q0 + i, col = k0 + j;
            float a = 0.f, ds = 0.f;
            if (i < nq && j < nk && col <= row && np[col])
                pair_grads<T>(sq + i * lq, sk + j * lq, sg + i * lv, sv + j * lv, dqk, dv,
                              p.inv_n, a, ds);
            sd[i * ls + j] = ds;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < BMAXR; ++r) {
            const int e = tid + r * NT;
            if (e < BT * dqk) {
                const int i = e / dqk, c = e % dqk;
                float s = acc[r];
                for (int j = 0; j < nk; ++j) s = fmaf(sd[i * ls + j], sk[j * lq + c], s);
                acc[r] = s;
            }
        }
    }
    T* gq = head_out<T>(p.gq, p.s[4], b, h);
#pragma unroll
    for (int r = 0; r < BMAXR; ++r) {
        const int e = tid + r * NT;
        if (e < BT * dqk && e / dqk < nq)
            gq[(long long)(q0 + e / dqk) * p.s[4][2] + e % dqk] = from_f<T>(acc[r]);
    }
}

// Both passes on one stream. Returns the first cudaError_t (0 = success).
template <typename T>
int launch_attn_bwd(const BwdArgs& p, int B, cudaStream_t stream) {
    const int smem = (int)sizeof(float) * bwd_smem_floats(p.dqk, p.dv);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.L + BT - 1) / BT, p.H, B);
    attn_bwd_dkdv_kernel<T><<<grid, NT, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dq_kernel<T><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace hstu

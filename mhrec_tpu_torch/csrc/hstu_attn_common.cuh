// Shared device code of the CUDA-core routes of the two HSTU forward kernels
// (hstu_stu_gated_fwd.cu, hstu_attn_fwd.cu: float32, and bfloat16 at widths
// their tensor-core routes do not take): one head's pointwise attention
//     A = mask ⊙ silu(q kᵀ) / n,   out = A v
// for a tile of TQ query rows, with mask[i, j] = (j <= i) & nonpad[j].
//
// Numerics follow the JAX kernels (mhrec_tpu/ops/pallas/hstu_attention_tpu.py,
// _fwd_gated_kernel and _fwd_kernel_v2): q·kᵀ summed in f32, silu and the
// 1/n scale in f32, masked entries zeroed, A rounded to the input type before
// the A·v product, which is summed in f32.
//
// Design: plain CUDA-core FMAs over shared-memory tiles. Per head, the block
// stages its TQ query rows, then walks key tiles of TK rows up to the causal
// edge of its query tile (tiles past it are never loaded). Each thread owns
// TQ·dv / NT accumulators in registers. Shared-memory rows of q and k are
// padded by one float so the score loop reads them without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hstu {

constexpr int TQ = 16;        // query rows per block
constexpr int TK = 64;        // key rows per shared-memory tile
constexpr int NT = 256;       // threads per block
constexpr int MAX_D = 128;    // largest per-head width the kernels take
constexpr int MAXR = TQ * MAX_D / NT;  // accumulators per thread

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// floats of shared memory one head's tiles need
__host__ __device__ inline int head_smem_floats(int dqk, int dv) {
    return TQ * (dqk + 1) + TK * (dqk + 1) + TK * dv + TQ * (TK + 1);
}

// One head over query rows [q0, q0 + TQ). qh/kh/vh point at row 0, column 0
// of this head; ld* are row strides in elements. nonpad points at this
// batch row's [L] key flags. On return acc[r] holds output element
// e = tid + r·NT of the [TQ, dv] tile (row e / dv, column e % dv).
template <typename T>
__device__ void head_attention(const T* __restrict__ qh, long long ldq,
                               const T* __restrict__ kh, long long ldk,
                               const T* __restrict__ vh, long long ldv,
                               const unsigned char* __restrict__ nonpad,
                               int L, int q0, int dqk, int dv, float inv_n,
                               float* smem, float (&acc)[MAXR]) {
    const int tid = threadIdx.x;
    const int ldsq = dqk + 1;
    float* sq = smem;                    // [TQ][dqk + 1]
    float* sk = sq + TQ * ldsq;          // [TK][dqk + 1]
    float* sv = sk + TK * ldsq;          // [TK][dv]
    float* ss = sv + TK * dv;            // [TQ][TK + 1]

#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

    __syncthreads();  // the previous head's readers are done with the tiles
    for (int e = tid; e < TQ * dqk; e += NT) {
        const int i = e / dqk, c = e % dqk, row = q0 + i;
        sq[i * ldsq + c] = row < L ? to_f<T>(qh[row * ldq + c]) : 0.f;
    }
    const int kend = min(L, q0 + TQ);  // causal edge of this query tile
    for (int k0 = 0; k0 < kend; k0 += TK) {
        const int nk = min(TK, kend - k0);
        __syncthreads();
        for (int e = tid; e < nk * dqk; e += NT) {
            const int j = e / dqk, c = e % dqk;
            sk[j * ldsq + c] = to_f<T>(kh[(long long)(k0 + j) * ldk + c]);
        }
        for (int e = tid; e < nk * dv; e += NT) {
            const int j = e / dv, c = e % dv;
            sv[j * dv + c] = to_f<T>(vh[(long long)(k0 + j) * ldv + c]);
        }
        __syncthreads();
        for (int e = tid; e < TQ * TK; e += NT) {
            const int i = e / TK, j = e % TK, row = q0 + i, col = k0 + j;
            float s = 0.f;
            if (j < nk && row < L && col <= row && nonpad[col]) {
                const float* a = sq + i * ldsq;
                const float* b = sk + j * ldsq;
                float d = 0.f;
                for (int c = 0; c < dqk; ++c) d = fmaf(a[c], b[c], d);
                const float sig = 1.f / (1.f + expf(-d));
                s = to_f<T>(from_f<T>(d * sig * inv_n));
            }
            ss[i * (TK + 1) + j] = s;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
            const int e = tid + r * NT;
            if (e < TQ * dv) {
                const int i = e / dv, c = e % dv;
                const float* srow = ss + i * (TK + 1);
                float a = acc[r];
                for (int j = 0; j < nk; ++j) a = fmaf(srow[j], sv[j * dv + c], a);
                acc[r] = a;
            }
        }
    }
}

}  // namespace hstu

// hstu_stu_gated_fwd — forward of the fused STU block on Hopper (sm_90a):
//     out = u ⊙ LayerNorm_F(concat_h(mask ⊙ silu(q_h k_hᵀ) / n · v_h))
// with LayerNorm over the full F = H·dv row in f32 (eps, affine γ/β), the
// gate in f32 and the result in the input type.
//
// Replaces the TPU kernel _fwd_gated_kernel / _fwd_gated
// (mhrec_tpu/ops/pallas/hstu_attention_tpu.py, via
// hstu_attention_gated_pallas). Its short-L row packing and L-padding to
// 128 are TPU tiling devices and are left out: this kernel computes the same
// function on the unpadded window.
//
// Bound on the H100: memory. At the serving shape (bf16, B=1024, L=50,
// F=1024) it must read q, k, v, u and write out, 5·B·L·F·2 bytes, against
// about 4·B·L²·F flops, far below the card's flop-to-byte balance. The
// design keeps the [TQ, F] attention rows in shared memory so the only
// device-memory traffic is those five tensors (q/k/v/u read straight from
// the uvqk projection through their row strides, no copies), and fuses the
// LayerNorm and gate into the same block. One block per (query tile of TQ
// rows, batch row); heads are walked in a loop. Making it fast (wgmma, TMA,
// K/V reuse across query tiles) is later work.
#include "hstu_attn_common.cuh"

namespace hstu {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <typename T>
__global__ void __launch_bounds__(NT)
stu_gated_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ u,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const unsigned char* __restrict__ nonpad, T* __restrict__ out,
                     int L, int H, int dqk, int dv,
                     long long sqb, long long sql, long long skb, long long skl,
                     long long svb, long long svl, long long sub, long long sul,
                     float inv_n, float eps) {
    extern __shared__ float smem[];
    const int b = blockIdx.y;
    const int q0 = blockIdx.x * TQ;
    const int F = H * dv;
    const int tid = threadIdx.x;
    float* rows = smem;                 // [TQ][F] concatenated head outputs
    float* tiles = rows + TQ * F;
    const unsigned char* np = nonpad + (long long)b * L;

    float acc[MAXR];
    for (int h = 0; h < H; ++h) {
        head_attention<T>(q + b * sqb + h * dqk, sql, k + b * skb + h * dqk, skl,
                          v + b * svb + h * dv, svl, np, L, q0, dqk, dv, inv_n,
                          tiles, acc);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
            const int e = tid + r * NT;
            if (e < TQ * dv) rows[(e / dv) * F + h * dv + e % dv] = acc[r];
        }
    }
    __syncthreads();

    // LayerNorm (two-pass mean / variance in f32) and the u gate, one warp
    // per query row
    const int warp = tid / 32, lane = tid % 32;
    for (int i = warp; i < TQ; i += NT / 32) {
        const int row = q0 + i;
        if (row >= L) break;
        const float* x = rows + i * F;
        float s = 0.f;
        for (int c = lane; c < F; c += 32) s += x[c];
        const float mu = warp_sum(s) / F;
        float s2 = 0.f;
        for (int c = lane; c < F; c += 32) {
            const float d = x[c] - mu;
            s2 = fmaf(d, d, s2);
        }
        const float var = warp_sum(s2) / F;
        const float rstd = 1.f / sqrtf(var + eps);
        const T* urow = u + b * sub + row * sul;
        T* orow = out + ((long long)b * L + row) * F;
        for (int c = lane; c < F; c += 32) {
            const float y = (x[c] - mu) * rstd * gamma[c] + beta[c];
            orow[c] = from_f<T>(to_f<T>(urow[c]) * y);
        }
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* u,
           const float* gamma, const float* beta, const unsigned char* nonpad,
           void* out, int B, int L, int H, int dqk, int dv,
           long long sqb, long long sql, long long skb, long long skl,
           long long svb, long long svl, long long sub, long long sul,
           float inv_n, float eps, cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((size_t)TQ * H * dv + head_smem_floats(dqk, dv));
    cudaError_t err = cudaFuncSetAttribute(
        stu_gated_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + TQ - 1) / TQ, B);
    stu_gated_fwd_kernel<T><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(u), gamma, beta, nonpad, static_cast<T*>(out),
        L, H, dqk, dv, sqb, sql, skb, skl, svb, svl, sub, sul, inv_n, eps);
    return (int)cudaGetLastError();
}

}  // namespace hstu

// C interface, loaded with ctypes. Strides are in elements (the last
// dimension of every tensor is contiguous). dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int hstu_stu_gated_fwd(
    const void* q, const void* k, const void* v, const void* u,
    const float* gamma, const float* beta, const unsigned char* nonpad, void* out,
    int B, int L, int H, int dqk, int dv,
    long long sqb, long long sql, long long skb, long long skl,
    long long svb, long long svl, long long sub, long long sul,
    float inv_n, float eps, int dtype, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return hstu::launch<__nv_bfloat16>(q, k, v, u, gamma, beta, nonpad, out, B, L, H,
                                           dqk, dv, sqb, sql, skb, skl, svb, svl, sub,
                                           sul, inv_n, eps, s);
    if (dtype == 0)
        return hstu::launch<float>(q, k, v, u, gamma, beta, nonpad, out, B, L, H, dqk, dv,
                                   sqb, sql, skb, skl, svb, svl, sub, sul, inv_n, eps, s);
    return (int)cudaErrorInvalidValue;
}

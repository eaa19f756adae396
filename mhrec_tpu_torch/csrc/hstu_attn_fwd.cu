// hstu_attn_fwd — forward of the pointwise HSTU attention on Hopper (sm_90a):
//     out[b, h] = (mask ⊙ silu(q[b, h] k[b, h]ᵀ) / n) · v[b, h]
// over [B, H, L, d] inputs, mask = causal & non-pad key, output in the
// input type.
//
// Replaces the TPU kernel _fwd_kernel_v2 / _fwd_v2
// (mhrec_tpu/ops/pallas/hstu_attention_tpu.py, via hstu_attention_pallas_v2)
// and, through a layout wrapper, _fwd_kernel / _fwd (hstu_attention_pallas,
// [B·H, L, d]). The TPU kernels' L-padding to 128 and head chunking are TPU
// tiling devices and are left out.
//
// Bound on the H100: memory. At the serving shape (bf16, B=1024, H=16,
// L=50, d=64) it must read q, k, v and write out, 4·B·L·H·d·2 bytes, against
// about 4·B·H·L²·d flops, below the card's flop-to-byte balance. The [TQ, L]
// score tile never leaves shared memory, and q/k/v are read through their
// strides, so a [B, L, H, d] tensor viewed as [B, H, L, d] needs no copy.
// One block per (query tile, head, batch row). Making it fast is later work.
#include "hstu_attn_common.cuh"

namespace hstu {

template <typename T>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const unsigned char* __restrict__ nonpad, T* __restrict__ out,
                int H, int L, int dqk, int dv,
                long long sqb, long long sqh, long long sql,
                long long skb, long long skh, long long skl,
                long long svb, long long svh, long long svl, float inv_n) {
    extern __shared__ float smem[];
    const int b = blockIdx.z, h = blockIdx.y;
    const int q0 = blockIdx.x * TQ;
    float acc[MAXR];
    head_attention<T>(q + b * sqb + h * sqh, sql, k + b * skb + h * skh, skl,
                      v + b * svb + h * svh, svl, nonpad + (long long)b * L, L, q0,
                      dqk, dv, inv_n, smem, acc);
    T* o = out + ((long long)b * H + h) * L * dv;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
        const int e = threadIdx.x + r * NT;
        const int row = q0 + e / dv;
        if (e < TQ * dv && row < L) o[(long long)row * dv + e % dv] = from_f<T>(acc[r]);
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const unsigned char* nonpad,
           void* out, int B, int H, int L, int dqk, int dv,
           long long sqb, long long sqh, long long sql,
           long long skb, long long skh, long long skl,
           long long svb, long long svh, long long svl, float inv_n,
           cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)head_smem_floats(dqk, dv);
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + TQ - 1) / TQ, H, B);
    attn_fwd_kernel<T><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        nonpad, static_cast<T*>(out), H, L, dqk, dv, sqb, sqh, sql, skb, skh, skl,
        svb, svh, svl, inv_n);
    return (int)cudaGetLastError();
}

}  // namespace hstu

// C interface, loaded with ctypes. Strides are in elements (the last
// dimension is contiguous); out is a contiguous [B, H, L, dv] tensor.
// nonpad is [B, L]. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int hstu_attn_fwd(
    const void* q, const void* k, const void* v, const unsigned char* nonpad, void* out,
    int B, int H, int L, int dqk, int dv,
    long long sqb, long long sqh, long long sql,
    long long skb, long long skh, long long skl,
    long long svb, long long svh, long long svl,
    float inv_n, int dtype, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return hstu::launch<__nv_bfloat16>(q, k, v, nonpad, out, B, H, L, dqk, dv, sqb, sqh,
                                           sql, skb, skh, skl, svb, svh, svl, inv_n, s);
    if (dtype == 0)
        return hstu::launch<float>(q, k, v, nonpad, out, B, H, L, dqk, dv, sqb, sqh, sql,
                                   skb, skh, skl, svb, svh, svl, inv_n, s);
    return (int)cudaErrorInvalidValue;
}

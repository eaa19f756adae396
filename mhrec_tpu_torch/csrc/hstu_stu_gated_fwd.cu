// hstu_stu_gated_fwd — forward of the fused STU block on Hopper (sm_90a):
//     out = u ⊙ LayerNorm_F(concat_h(mask ⊙ silu(q_h k_hᵀ) / n · v_h))
// with LayerNorm over the full F = H·dv row in f32 (eps, affine γ/β), the
// gate in f32 and the result in the input type.
//
// Replaces the TPU kernel _fwd_gated_kernel / _fwd_gated
// (mhrec_tpu/ops/pallas/hstu_attention_tpu.py, via
// hstu_attention_gated_pallas). Its short-L row packing and L-padding to
// 128 are TPU tiling devices and are left out: this kernel computes the same
// function on the unpadded window. Numerics as the JAX kernel: q·kᵀ summed
// in f32, silu and 1/n in f32, masked entries zeroed, the scores rounded to
// v's type, A·v summed in f32, the heads concatenated in f32, then the
// LayerNorm's two-pass mean and variance and the gate in f32.
//
// Bound on the H100: memory. At the serving shape (bf16, B=1024, L=50,
// F=1024) it must read q, k, v, u and write out, 5·B·L·F·2 bytes, against
// about 4·B·L²·F flops, far below the card's flop-to-byte balance. Both
// routes keep a block's [16, F] attention rows in float32 shared memory, so
// the only device-memory traffic is those five tensors (q/k/v/u read
// straight from the uvqk projection through their row strides), and fuse
// the LayerNorm and gate into the same block. One block per (query tile of
// 16 rows, batch row).
//
// Two routes, chosen by the wrapper:
// * bfloat16 with head widths that are multiples of 8
//   (stu_gated_fwd_tc_kernel): the attention rows of hstu_stu_tc.cuh, which
//   the backward's recompute shares — 4 warps streaming (head, key tile)
//   items through one or two cp.async stages sized so that two blocks share
//   an SM, S = Q·Kᵀ and O += A·V as mma.sync m16n8k16 with bf16 operands and
//   float32 accumulators, A rounded to bf16 once, exactly where the JAX
//   kernel rounds it to v's type, straight from the score accumulators into
//   the A fragments of A·V. The LayerNorm and gate take each warp's four
//   rows together, reading γ and β once a warp and u, γ, β and the row
//   buffer with 16-byte loads, and store out 16 bytes a lane.
// * float32, and bfloat16 at other head widths (stu_gated_fwd_kernel, with
//   head_attention of hstu_attn_common.cuh): CUDA-core FMAs out of float32
//   shared-memory tiles, heads walked in a loop; float32 keeps every product
//   in full float32 (the tensor cores would take it as TF32). Float32 over
//   windows of at most 64 rows takes the cluster kernel of hstu_stu_f32.cu
//   instead; this one keeps longer windows and other widths.
#include "hstu_attn_common.cuh"
#include "hstu_stu_tc.cuh"

namespace hstu {

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

// ---- the bfloat16 route: tensor-core kernel ---------------------------------

// One block: query rows [q0, q0 + 16) of batch row b (the attention rows of
// hstu_stu_tc.cuh, then the LayerNorm and gate). u [B, L, H·dv] at strides
// sub, sul; γ, β [H·dv]; out [B, L, H·dv] contiguous.
template <int DP>
__global__ void __launch_bounds__(TC_NT)
stu_gated_fwd_tc_kernel(GatedArgs p, const bf16* __restrict__ u, const float* __restrict__ gamma,
                        const float* __restrict__ beta, bf16* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int L = p.L, F = p.H * p.dv, FP = F + 8;
    const float* rows = reinterpret_cast<const float*>(smem_raw);  // [TC_BM][FP]
    const int b = blockIdx.y, q0 = blockIdx.x * TC_BM;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int qn = min(L, q0 + TC_BM) - q0;
    stu_attention_rows_tc<DP>(p, smem_raw, b, q0);

    // LayerNorm (two-pass mean / variance in f32) and the u gate. Warp w
    // takes rows w, w + 4, w + 8, w + 12: first their statistics from the row
    // buffer, then 8 columns a lane at a time across those rows, so that γ
    // and β are read once a warp and a step's loads are in flight together
    constexpr int RW = TC_BM / TC_WARPS;  // rows a warp
    float mu[RW], rstd[RW];
    row_stats(rows, F, p.eps, warp, lane, mu, rstd);
    for (int c = lane * 8; c < F; c += 256) {
        const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
        const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(beta + c);
        const float4 b1 = *reinterpret_cast<const float4*>(beta + c + 4);
        const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        uint4 uv[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int i = warp + r * TC_WARPS;
            if (i < qn)
                uv[r] = *reinterpret_cast<const uint4*>(u + b * p.sub + (q0 + i) * p.sul + c);
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int i = warp + r * TC_WARPS;
            if (i >= qn) continue;
            const float* x = rows + i * FP + c;
            const float4 x0 = *reinterpret_cast<const float4*>(x);
            const float4 x1 = *reinterpret_cast<const float4*>(x + 4);
            const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
            const uint32_t uw[4] = {uv[r].x, uv[r].y, uv[r].z, uv[r].w};
            uint32_t ow[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float u0 = bf16_lo(uw[e]), u1 = bf16_hi(uw[e]);
                const float y0 = (xs[2 * e] - mu[r]) * rstd[r] * gs[2 * e] + bs[2 * e];
                const float y1 = (xs[2 * e + 1] - mu[r]) * rstd[r] * gs[2 * e + 1] + bs[2 * e + 1];
                ow[e] = tc::pack_bf16(u0 * y0, u1 * y1);
            }
            *reinterpret_cast<uint4*>(out + ((long long)b * L + q0 + i) * F + c) =
                make_uint4(ow[0], ow[1], ow[2], ow[3]);
        }
    }
}

template <int DP>
int launch_tc(GatedArgs a, const void* u, const float* gamma, const float* beta, void* out,
              int B, cudaStream_t stream) {
    const int F = a.H * a.dv;
    a.ns = tc_stages(DP, F, a.L);
    const size_t smem = tc_smem_bytes(DP, F, a.L, a.ns);
    if (smem > (size_t)TC_SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        stu_gated_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.L + TC_BM - 1) / TC_BM, B);
    stu_gated_fwd_tc_kernel<DP><<<grid, TC_NT, smem, stream>>>(
        a, static_cast<const bf16*>(u), gamma, beta, static_cast<bf16*>(out));
    return (int)cudaGetLastError();
}

}  // namespace hstu

// C interface, loaded with ctypes. Strides are in elements (the last
// dimension of every tensor is contiguous). dtype: 0 = float32, 1 =
// bfloat16 on the CUDA cores, 2 = bfloat16 on the tensor cores (needs dqk
// and dv multiples of 8 up to 128, q/k/v/u 16-byte aligned with batch and
// row strides multiples of 8, γ and β 16-byte aligned, and the shared
// memory of tc_smem_bytes). Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" int hstu_stu_gated_fwd(
    const void* q, const void* k, const void* v, const void* u,
    const float* gamma, const float* beta, const unsigned char* nonpad, void* out,
    int B, int L, int H, int dqk, int dv,
    long long sqb, long long sql, long long skb, long long skl,
    long long svb, long long svl, long long sub, long long sul,
    float inv_n, float eps, int dtype, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 2) {
        using hstu::bf16;
        const hstu::GatedArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), nonpad, L, H, dqk, dv,
                                sqb, sql, skb, skl, svb, svl, sub, sul, inv_n, eps, 1};
        const int d = dqk > dv ? dqk : dv;
        if (d <= 16) return hstu::launch_tc<16>(a, u, gamma, beta, out, B, s);
        if (d <= 32) return hstu::launch_tc<32>(a, u, gamma, beta, out, B, s);
        if (d <= 64) return hstu::launch_tc<64>(a, u, gamma, beta, out, B, s);
        if (d <= 128) return hstu::launch_tc<128>(a, u, gamma, beta, out, B, s);
        return (int)cudaErrorInvalidValue;
    }
    if (dtype == 1)
        return hstu::launch<__nv_bfloat16>(q, k, v, u, gamma, beta, nonpad, out, B, L, H,
                                           dqk, dv, sqb, sql, skb, skl, svb, svl, sub,
                                           sul, inv_n, eps, s);
    if (dtype == 0)
        return hstu::launch<float>(q, k, v, u, gamma, beta, nonpad, out, B, L, H, dqk, dv,
                                   sqb, sql, skb, skl, svb, svl, sub, sul, inv_n, eps, s);
    return (int)cudaErrorInvalidValue;
}

// hstu_stu_gated_bwd — backward of the fused STU block on Hopper (sm_90a):
// gradients of out = u ⊙ LayerNorm_F(concat_h(mask ⊙ silu(q_h k_hᵀ)/n · v_h))
// with respect to q, k, v, u and the LayerNorm's γ and β, given the output
// gradient g.
//
// Replaces the TPU kernel _bwd_gated_kernel / _bwd_gated
// (mhrec_tpu/ops/pallas/hstu_attention_tpu.py, the custom VJP of
// hstu_attention_gated_pallas). The TPU kernel runs one program per batch
// row over the whole window; here the work is split in two steps on one
// stream:
//   (a) one block per (query tile of TQ rows, batch row) recomputes the
//       forward's attention rows for every head (the same head_attention as
//       hstu_stu_gated_fwd.cu), keeps the [TQ, F] f32 rows in shared memory
//       and runs the LayerNorm and gate backward there:
//           dy = u·g,  du = (x̂γ + β)·g,  dx̂ = dy·γ,
//           dattn = (dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)) / σ,
//       writing du and dattn (in the input type, as the TPU kernel rounds
//       ga before its products) and this block's f32 partial sums of
//       dγ = Σ dy·x̂ and dβ = Σ dy, which the wrapper sums with torch.sum
//       (the TPU kernel's per-batch partials are summed outside it too);
//   (b) the pointwise attention backward of hstu_attn_bwd.cuh over the flat
//       [B, L, H·d] layout with g = dattn, giving dq, dk, dv.
//
// Bound on the H100: memory at the size4 shape (q, k, v, u, g read, dq, dk,
// dv, du written, plus the dattn round trip). Step (a) keeps the scores and
// the LayerNorm rows out of device memory as the forward does; q, k, v, u
// are read through their row strides straight from the uvqk split.
#include "hstu_attn_bwd.cuh"

namespace hstu {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <typename T>
__global__ void __launch_bounds__(NT)
stu_gated_bwd_ln_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ u,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        const unsigned char* __restrict__ nonpad, const T* __restrict__ g,
                        T* __restrict__ du, T* __restrict__ dattn,
                        float* __restrict__ dgam_part, float* __restrict__ dbet_part,
                        int L, int H, int dqk, int dv,
                        long long sqb, long long sql, long long skb, long long skl,
                        long long svb, long long svl, long long sub, long long sul,
                        float inv_n, float eps) {
    extern __shared__ float smem[];
    const int b = blockIdx.y, qt = blockIdx.x;
    const int q0 = qt * TQ;
    const int F = H * dv;
    const int tid = threadIdx.x;
    float* rows = smem;                 // [TQ][F] concatenated head outputs
    float* stats = rows + TQ * F;       // [TQ][2] mean, 1/std
    float* tiles = stats + 2 * TQ;
    const unsigned char* np = nonpad + (long long)b * L;

    float acc[MAXR];
    for (int h = 0; h < H; ++h) {
        head_attention<T>(q + b * sqb + h * dqk, sql, k + b * skb + h * dqk, skl,
                          v + b * svb + h * dv, svl, np, L, q0, dqk, dv, inv_n, tiles, acc);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
            const int e = tid + r * NT;
            if (e < TQ * dv) rows[(e / dv) * F + h * dv + e % dv] = acc[r];
        }
    }
    __syncthreads();

    // LayerNorm and gate backward, one warp per query row
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
        if (lane == 0) {
            stats[2 * i] = mu;
            stats[2 * i + 1] = rstd;
        }
        const T* urow = u + b * sub + row * sul;
        const long long off = ((long long)b * L + row) * F;
        float m1 = 0.f, m2 = 0.f;
        for (int c = lane; c < F; c += 32) {
            const float xh = (x[c] - mu) * rstd;
            const float gc = to_f<T>(g[off + c]);
            du[off + c] = from_f<T>((xh * gamma[c] + beta[c]) * gc);
            const float dxh = to_f<T>(urow[c]) * gc * gamma[c];
            m1 += dxh;
            m2 += dxh * xh;
        }
        m1 = warp_sum(m1) / F;
        m2 = warp_sum(m2) / F;
        for (int c = lane; c < F; c += 32) {
            const float xh = (x[c] - mu) * rstd;
            const float dxh = to_f<T>(urow[c]) * to_f<T>(g[off + c]) * gamma[c];
            dattn[off + c] = from_f<T>((dxh - m1 - xh * m2) * rstd);
        }
    }
    __syncthreads();

    // this block's partial sums of dγ and dβ over its rows
    const int nrows = min(TQ, L - q0);
    const long long part = ((long long)b * gridDim.x + qt) * F;
    for (int c = tid; c < F; c += NT) {
        float sg = 0.f, sb = 0.f;
        for (int i = 0; i < nrows; ++i) {
            const int row = q0 + i;
            const float xh = (rows[i * F + c] - stats[2 * i]) * stats[2 * i + 1];
            const float dy = to_f<T>(u[b * sub + row * sul + c]) *
                             to_f<T>(g[((long long)b * L + row) * F + c]);
            sg += dy * xh;
            sb += dy;
        }
        dgam_part[part + c] = sg;
        dbet_part[part + c] = sb;
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* u,
           const float* gamma, const float* beta, const unsigned char* nonpad,
           const void* g, void* dq, void* dk, void* dv, void* du, void* dattn,
           float* dgam_part, float* dbet_part, int B, int L, int H, int dqk, int dv_w,
           const long long* st, float inv_n, float eps, cudaStream_t stream) {
    const int F = H * dv_w, Fq = H * dqk;
    const size_t smem = sizeof(float) * ((size_t)TQ * F + 2 * TQ + head_smem_floats(dqk, dv_w));
    cudaError_t err = cudaFuncSetAttribute(
        stu_gated_bwd_ln_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + TQ - 1) / TQ, B);
    stu_gated_bwd_ln_kernel<T><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(u), gamma, beta, nonpad, static_cast<const T*>(g),
        static_cast<T*>(du), static_cast<T*>(dattn), dgam_part, dbet_part,
        L, H, dqk, dv_w, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], inv_n, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    // (b) attention backward over the flat layout: head h of a [B, L, H·d]
    // tensor starts at column h·d
    BwdArgs p;
    p.q = q; p.k = k; p.v = v; p.g = dattn; p.nonpad = nonpad;
    p.gq = dq; p.gk = dk; p.gv = dv;
    p.H = H; p.L = L; p.dqk = dqk; p.dv = dv_w; p.inv_n = inv_n;
    const long long in[4][3] = {{st[0], dqk, st[1]}, {st[2], dqk, st[3]},
                                {st[4], dv_w, st[5]}, {(long long)L * F, dv_w, F}};
    const long long out[3][3] = {{(long long)L * Fq, dqk, Fq}, {(long long)L * Fq, dqk, Fq},
                                 {(long long)L * F, dv_w, F}};
    for (int i = 0; i < 3; ++i) {
        for (int t = 0; t < 4; ++t) p.s[t][i] = in[t][i];
        for (int t = 0; t < 3; ++t) p.s[4 + t][i] = out[t][i];
    }
    return launch_attn_bwd<T>(p, B, stream);
}

}  // namespace hstu

// C interface, loaded with ctypes. strides: (batch, row) element strides of
// q, k, v, u (8 values); their last dimension is contiguous. g, the outputs
// dq, dk [B, L, H·dqk], dv, du [B, L, H·dv] and the scratch dattn
// [B, L, H·dv] are contiguous; dgam_part, dbet_part are f32
// [B·ceil(L/16), H·dv]. dtype: 0 = float32, 1 = bfloat16. Returns the first
// cudaError_t of the launches (0 = cudaSuccess).
extern "C" int hstu_stu_gated_bwd(
    const void* q, const void* k, const void* v, const void* u,
    const float* gamma, const float* beta, const unsigned char* nonpad, const void* g,
    void* dq, void* dk, void* dv, void* du, void* dattn, float* dgam_part, float* dbet_part,
    int B, int L, int H, int dqk, int dv_width, const long long* strides,
    float inv_n, float eps, int dtype, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return hstu::launch<__nv_bfloat16>(q, k, v, u, gamma, beta, nonpad, g, dq, dk, dv, du,
                                           dattn, dgam_part, dbet_part, B, L, H, dqk, dv_width,
                                           strides, inv_n, eps, s);
    if (dtype == 0)
        return hstu::launch<float>(q, k, v, u, gamma, beta, nonpad, g, dq, dk, dv, du, dattn,
                                   dgam_part, dbet_part, B, L, H, dqk, dv_width, strides,
                                   inv_n, eps, s);
    return (int)cudaErrorInvalidValue;
}

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
//   (a) one block per (query tile of 16 rows, batch row) recomputes the
//       forward's attention rows for every head, keeps the [16, F] f32 rows
//       in shared memory and runs the LayerNorm and gate backward there:
//           dy = u·g,  du = (x̂γ + β)·g,  dx̂ = dy·γ,
//           dattn = (dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)) / σ,
//       writing du and dattn (in the input type, as the TPU kernel rounds
//       ga before its products) and this block's f32 partial sums of
//       dγ = Σ dy·x̂ and dβ = Σ dy, which the wrapper sums with torch.sum
//       (the TPU kernel's per-batch partials are summed outside it too);
//   (b) the pointwise attention backward of hstu_attn_bwd.cuh over the flat
//       [B, L, H·d] layout with g = dattn, giving dq, dk, dv.
// dattn goes through device memory between the steps (2 × 6.55 MB at the
// train shape, about 4 µs at 3.35 TB/s): step (b) needs every query row of
// a head, step (a) every head of a query row, so one block holding both
// would hold the whole [L, F] window.
//
// Bound on the H100: memory at the size4 shape (q, k, v, u, g read, dq, dk,
// dv, du written, plus the dattn round trip). Step (a) keeps the scores and
// the LayerNorm rows out of device memory as the forward does; q, k, v, u
// are read through their row strides straight from the uvqk split.
//
// Two routes, chosen by the wrapper:
// * bfloat16 with head widths that are multiples of 8 up to 128
//   (stu_gated_bwd_tc_kernel, then the tensor-core attention backward of
//   hstu_attn_bwd.cuh): step (a) recomputes the rows with the forward's own
//   tensor-core body (hstu_stu_tc.cuh, stages sized so that two blocks share
//   an SM where the row buffer lets them: F = 1024 does, F = 2048 does not),
//   then takes the row statistics a warp at a time (four rows a warp, γ read
//   once a warp) and the gradients a thread per 8 columns over the block's
//   rows, with 16-byte loads of u, g, γ, β and 16-byte stores of du and dattn,
//   so that the dγ / dβ partials need no reduction across threads.
// * float32, and bfloat16 at other head widths (stu_gated_bwd_ln_kernel with
//   head_attention of hstu_attn_common.cuh, then the CUDA-core attention
//   backward): FMAs out of float32 shared memory, so float32 stays full
//   float32.
#include "hstu_attn_bwd.cuh"
#include "hstu_stu_tc.cuh"

namespace hstu {

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

// Step (b)'s arguments: the attention backward over the flat layout, where
// head h of a [B, L, H·d] tensor starts at column h·d. st: the (batch, row)
// strides of q, k, v (and u); dattn, dq, dk, dv contiguous.
inline BwdArgs flat_bwd_args(const void* q, const void* k, const void* v, const void* dattn,
                             const unsigned char* nonpad, void* dq, void* dk, void* dv, int L,
                             int H, int dqk, int dv_w, const long long* st, float inv_n) {
    BwdArgs p;
    p.q = q; p.k = k; p.v = v; p.g = dattn; p.nonpad = nonpad;
    p.gq = dq; p.gk = dk; p.gv = dv;
    p.H = H; p.L = L; p.dqk = dqk; p.dv = dv_w; p.inv_n = inv_n;
    const long long F = (long long)H * dv_w, Fq = (long long)H * dqk;
    const long long s[7][3] = {{st[0], dqk, st[1]}, {st[2], dqk, st[3]}, {st[4], dv_w, st[5]},
                               {L * F, dv_w, F}, {L * Fq, dqk, Fq}, {L * Fq, dqk, Fq},
                               {L * F, dv_w, F}};
    for (int t = 0; t < 7; ++t)
        for (int i = 0; i < 3; ++i) p.s[t][i] = s[t][i];
    return p;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* u,
           const float* gamma, const float* beta, const unsigned char* nonpad,
           const void* g, void* dq, void* dk, void* dv, void* du, void* dattn,
           float* dgam_part, float* dbet_part, int B, int L, int H, int dqk, int dv_w,
           const long long* st, float inv_n, float eps, cudaStream_t stream) {
    const int F = H * dv_w;
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
    // (b)
    return launch_attn_bwd<T>(
        flat_bwd_args(q, k, v, dattn, nonpad, dq, dk, dv, L, H, dqk, dv_w, st, inv_n), B, stream);
}

// ---- the bfloat16 route: tensor-core kernels ---------------------------------

// bytes of shared memory the step (a) kernel holds besides tc_smem_bytes:
// the rows' statistics
constexpr size_t TC_BWD_STATS = sizeof(float) * 4 * TC_BM;

// Step (a), one block: query rows [q0, q0 + 16) of batch row b. u [B, L,
// H·dv] at strides sub, sul; γ, β [H·dv]; g, du, dattn [B, L, H·dv]
// contiguous; dγ, dβ partials [B·gridDim.x, H·dv].
template <int DP>
__global__ void __launch_bounds__(TC_NT)
stu_gated_bwd_tc_kernel(GatedArgs p, const bf16* __restrict__ u, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const bf16* __restrict__ g,
                        bf16* __restrict__ du, bf16* __restrict__ dattn,
                        float* __restrict__ dgam_part, float* __restrict__ dbet_part) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int L = p.L, F = p.H * p.dv, FP = F + 8;
    const float* rows = reinterpret_cast<const float*>(smem_raw);  // [TC_BM][FP]
    float* stats = reinterpret_cast<float*>(smem_raw + tc_smem_bytes(DP, F, L, p.ns));  // [TC_BM][4]
    const int b = blockIdx.y, qt = blockIdx.x, q0 = qt * TC_BM;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int qn = min(L, q0 + TC_BM) - q0;
    stu_attention_rows_tc<DP>(p, smem_raw, b, q0);

    // each row's mean, 1/σ, m1 = mean(dx̂) and m2 = mean(dx̂·x̂) with
    // dx̂ = u·g·γ. Warp w takes rows w, w + 4, w + 8, w + 12 together, 8
    // columns a lane, so that γ is read once a warp
    constexpr int RW = TC_BM / TC_WARPS;  // rows a warp
    float mu[RW], rstd[RW], m1[RW], m2[RW];
    row_stats(rows, F, p.eps, warp, lane, mu, rstd);
#pragma unroll
    for (int r = 0; r < RW; ++r) m1[r] = m2[r] = 0.f;
    for (int c = lane * 8; c < F; c += 256) {
        const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
        const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
        const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        uint4 uv[RW], gv[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int i = warp + r * TC_WARPS;
            if (i < qn) {
                uv[r] = *reinterpret_cast<const uint4*>(u + b * p.sub + (q0 + i) * p.sul + c);
                gv[r] = *reinterpret_cast<const uint4*>(g + ((long long)b * L + q0 + i) * F + c);
            }
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
            const uint32_t gw[4] = {gv[r].x, gv[r].y, gv[r].z, gv[r].w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float ue = e & 1 ? bf16_hi(uw[e >> 1]) : bf16_lo(uw[e >> 1]);
                const float ge = e & 1 ? bf16_hi(gw[e >> 1]) : bf16_lo(gw[e >> 1]);
                const float dxh = ue * ge * gs[e];
                m1[r] += dxh;
                m2[r] += dxh * ((xs[e] - mu[r]) * rstd[r]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const float s1 = warp_sum(m1[r]) / F, s2 = warp_sum(m2[r]) / F;
        if (lane == 0)
            *reinterpret_cast<float4*>(stats + 4 * (warp + r * TC_WARPS)) =
                make_float4(mu[r], rstd[r], s1, s2);
    }
    __syncthreads();

    // the gradients, a thread per 8 columns over the block's rows; its sums
    // over those rows are the block's dγ, dβ partials of its columns
    const long long part = ((long long)b * gridDim.x + qt) * F;
    for (int c = tid * 8; c < F; c += TC_NT * 8) {
        const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
        const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(beta + c);
        const float4 b1 = *reinterpret_cast<const float4*>(beta + c + 4);
        const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float dgs[8], dbs[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) dgs[e] = dbs[e] = 0.f;
#pragma unroll 4
        for (int i = 0; i < qn; ++i) {
            const long long off = ((long long)b * L + q0 + i) * F + c;
            const uint4 uv = *reinterpret_cast<const uint4*>(u + b * p.sub + (q0 + i) * p.sul + c);
            const uint4 gv = *reinterpret_cast<const uint4*>(g + off);
            const float4 st = *reinterpret_cast<const float4*>(stats + 4 * i);  // mu, 1/σ, m1, m2
            const float* x = rows + i * FP + c;
            const float4 x0 = *reinterpret_cast<const float4*>(x);
            const float4 x1 = *reinterpret_cast<const float4*>(x + 4);
            const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
            const uint32_t uw[4] = {uv.x, uv.y, uv.z, uv.w};
            const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
            float dus[8], das[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float ue = e & 1 ? bf16_hi(uw[e >> 1]) : bf16_lo(uw[e >> 1]);
                const float ge = e & 1 ? bf16_hi(gw[e >> 1]) : bf16_lo(gw[e >> 1]);
                const float xh = (xs[e] - st.x) * st.y;
                const float dy = ue * ge;
                dus[e] = (xh * gs[e] + bs[e]) * ge;
                das[e] = (dy * gs[e] - st.z - xh * st.w) * st.y;
                dgs[e] += dy * xh;
                dbs[e] += dy;
            }
            *reinterpret_cast<uint4*>(du + off) =
                make_uint4(tc::pack_bf16(dus[0], dus[1]), tc::pack_bf16(dus[2], dus[3]),
                           tc::pack_bf16(dus[4], dus[5]), tc::pack_bf16(dus[6], dus[7]));
            *reinterpret_cast<uint4*>(dattn + off) =
                make_uint4(tc::pack_bf16(das[0], das[1]), tc::pack_bf16(das[2], das[3]),
                           tc::pack_bf16(das[4], das[5]), tc::pack_bf16(das[6], das[7]));
        }
        *reinterpret_cast<float4*>(dgam_part + part + c) = make_float4(dgs[0], dgs[1], dgs[2], dgs[3]);
        *reinterpret_cast<float4*>(dgam_part + part + c + 4) = make_float4(dgs[4], dgs[5], dgs[6], dgs[7]);
        *reinterpret_cast<float4*>(dbet_part + part + c) = make_float4(dbs[0], dbs[1], dbs[2], dbs[3]);
        *reinterpret_cast<float4*>(dbet_part + part + c + 4) = make_float4(dbs[4], dbs[5], dbs[6], dbs[7]);
    }
}

template <int DP>
int launch_tc(GatedArgs a, const void* u, const float* gamma, const float* beta, const void* g,
              void* dq, void* dk, void* dv, void* du, void* dattn, float* dgam_part,
              float* dbet_part, int B, cudaStream_t stream) {
    const int F = a.H * a.dv, L = a.L;
    a.ns = tc_stages(DP, F, L, TC_BWD_STATS);
    const size_t smem = tc_smem_bytes(DP, F, L, a.ns) + TC_BWD_STATS;
    if (smem > (size_t)TC_SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        stu_gated_bwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    stu_gated_bwd_tc_kernel<DP><<<dim3((L + TC_BM - 1) / TC_BM, B), TC_NT, smem, stream>>>(
        a, static_cast<const bf16*>(u), gamma, beta, static_cast<const bf16*>(g),
        static_cast<bf16*>(du), static_cast<bf16*>(dattn), dgam_part, dbet_part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // (b)
    const long long st[8] = {a.sqb, a.sql, a.skb, a.skl, a.svb, a.svl, a.sub, a.sul};
    return launch_attn_bwd_tc<DP>(flat_bwd_args(a.q, a.k, a.v, dattn, a.nonpad, dq, dk, dv, L,
                                                a.H, a.dqk, a.dv, st, a.inv_n),
                                  B, stream);
}


}  // namespace hstu

// C interface, loaded with ctypes. strides: (batch, row) element strides of
// q, k, v, u (8 values); their last dimension is contiguous. g, the outputs
// dq, dk [B, L, H·dqk], dv, du [B, L, H·dv] and the scratch dattn
// [B, L, H·dv] are contiguous; dgam_part, dbet_part are f32
// [B·ceil(L/16), H·dv]. dtype: 0 = float32, 1 = bfloat16 on the CUDA cores,
// 2 = bfloat16 on the tensor cores (needs dqk and dv multiples of 8 up to
// 128, q/k/v/u/g 16-byte aligned with batch and row strides multiples of 8,
// γ and β 16-byte aligned, and the shared memory of tc_smem_bytes plus the
// rows' statistics). Returns the first cudaError_t of the launches
// (0 = cudaSuccess).
extern "C" int hstu_stu_gated_bwd(
    const void* q, const void* k, const void* v, const void* u,
    const float* gamma, const float* beta, const unsigned char* nonpad, const void* g,
    void* dq, void* dk, void* dv, void* du, void* dattn, float* dgam_part, float* dbet_part,
    int B, int L, int H, int dqk, int dv_width, const long long* strides,
    float inv_n, float eps, int dtype, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 2) {
        using hstu::bf16;
        const long long* st = strides;
        const hstu::GatedArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), nonpad, L, H, dqk, dv_width,
                                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                                inv_n, eps, 1};
        const int d = dqk > dv_width ? dqk : dv_width;
        if (d <= 16)
            return hstu::launch_tc<16>(a, u, gamma, beta, g, dq, dk, dv, du, dattn, dgam_part,
                                       dbet_part, B, s);
        if (d <= 32)
            return hstu::launch_tc<32>(a, u, gamma, beta, g, dq, dk, dv, du, dattn, dgam_part,
                                       dbet_part, B, s);
        if (d <= 64)
            return hstu::launch_tc<64>(a, u, gamma, beta, g, dq, dk, dv, du, dattn, dgam_part,
                                       dbet_part, B, s);
        if (d <= 128)
            return hstu::launch_tc<128>(a, u, gamma, beta, g, dq, dk, dv, du, dattn, dgam_part,
                                        dbet_part, B, s);
        return (int)cudaErrorInvalidValue;
    }
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

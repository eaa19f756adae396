// hstu_stu_f32 — the fused STU block in float32 on Hopper (sm_90a), forward
// and backward, over windows of at most 64 rows (every model config: window
// 50; ComiRec's and REMI's trunk runs in float32):
//     out = u ⊙ LayerNorm_F(concat_h(mask ⊙ silu(q_h k_hᵀ) / n · v_h))
// and its gradients with respect to q, k, v, u, γ and β given the output
// gradient g. The float32 route of #1 hstu_stu_gated_fwd and #4
// hstu_stu_gated_bwd ("cluster" form, ops/hstu_attention_cuda.py's
// stu_gated_f32_form); longer windows and head widths that are not
// multiples of 4 keep the query-tile kernels of hstu_stu_gated_fwd.cu and
// hstu_stu_gated_bwd.cu.
//
// Replaces the TPU kernels _fwd_gated_kernel and _bwd_gated_kernel
// (mhrec_tpu/ops/pallas/hstu_attention_tpu.py:378, :412; _fwd_gated :497,
// _bwd_gated :537) in float32, with their numerics: q·kᵀ summed in f32,
// silu and 1/n in f32, masked entries zeroed, A·v in f32, the heads
// concatenated, the LayerNorm's two-pass mean and variance and the gate in
// f32; backward dy = u·g, du = (x̂γ + β)·g, dx̂ = dy·γ,
// dattn = (dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂))/σ, then each head's attention
// backward, dγ and dβ as per-batch-row partials that the wrapper sums.
//
// Bound on the H100: memory. ComiRec's train batch (B = 64) must move
// 19.6 µs of bytes forward (q, k, v, u in, out) against about 0.4 GFLOP of
// causal products, 6 µs at 67 TFLOP/s of float32 FMAs; backward 35 µs of
// bytes against 1.1 GFLOP, 16 µs. The query-tile kernels read each head's
// keys once per 16-row query tile, computed one dot product a thread, and
// passed dattn through device memory between the backward's two steps.
// Here the TPU kernel's one program a batch row becomes one thread-block
// cluster a batch row (hstu_stu_cluster.cuh): a block per ceil(H / 8)
// heads, the LayerNorm's row sums exchanged through distributed shared
// memory in rank order, the attention rows and dattn kept on chip, the
// products on register tiles.
#include "hstu_stu_cluster.cuh"

namespace hstu {

// Block (rank, b) of batch row b's cluster: heads [rank·hb, rank·hb + nh),
// block columns [c0, c0 + nh·dv). Shared memory: the exchanged partial sums,
// where fwd_own_scores a score tile for each pair of product groups, and
// each head's q, k, v tiles [L8][LD] (L8 = round8(L)). The block takes its
// heads two at a time, a pair of groups a head (a balanced half of the row
// blocks each):
// S = q·kᵀ in registers, A into the q tile (q is read no more) or the pair's
// score tile, u fetched into the k tile, O = A·v into the q tile.
// out [B, L, H·dv] contiguous.
namespace stu32 {

template <bool N7>
__global__ void __launch_bounds__(NT, 2)
stu_gated_fwd_cluster_kernel(Args p, float* __restrict__ out) {
    constexpr unsigned R0 = Halves<N7>::lower[0], R1 = Halves<N7>::lower[1];
    extern __shared__ __align__(16) float smem[];
    const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int L = p.L, L8 = round8(L), n8 = L8 / 8, dqk = p.dqk, dv = p.dv;
    const int hb = heads_per_block(p.H), h0 = rank * hb, nh = min(hb, p.H - h0);
    const int LD = tile_ld(dqk, dv), T = L8 * LD, F = p.H * dv, c0 = h0 * dv;
    const bool own = fwd_own_scores(L, dqk, dv);
    float* red = smem;                // [2][MAX_L] this block's partial row sums
    float* P = smem + STAT_FLOATS;    // [min(hb, NP)][MAX_L][PLD] where `own`
    float* slots = P + (own ? (hb < NP ? hb : NP) * P_FLOATS : 0);  // per head: q, k, v [L8][LD]
    const unsigned char* np = p.nonpad + (long long)b * L;

    // every head's q and k in flight at once, then every head's v
    for (int hl = 0; hl < nh; ++hl) {
        float* sq = slots + hl * 3 * T;
        stage(sq, LD, p.q + b * p.sqb + (h0 + hl) * dqk, p.sql, L, L8, dqk, tid, NT);
        stage(sq + T, LD, p.k + b * p.skb + (h0 + hl) * dqk, p.skl, L, L8, dqk, tid, NT);
    }
    tc::cp_async_commit();
    for (int hl = 0; hl < nh; ++hl)
        stage(slots + (hl * 3 + 2) * T, LD, p.v + b * p.svb + (h0 + hl) * dv, p.svl, L, L8, dv,
              tid, NT);
    tc::cp_async_commit();
    prefetch_rows(p.u + b * p.sub + c0, p.sul, L, nh * dv);  // u, fetched after S, into L2

    const int pr = tid / (2 * GT), half = (tid / GT) & 1, gt = tid % GT;
    const unsigned kbits = key_bits(np, L, gt);
    for (int h1 = 0; h1 < nh; h1 += NP) {
        const int hl = h1 + pr;
        const bool on = hl < nh;
        float* sq = slots + hl * 3 * T;
        const float* sv = sq + 2 * T;
        float* A = own ? P + pr * P_FLOATS : sq;
        const int lda = own ? PLD : LD;
        tc::cp_async_wait<1>();  // q and k have landed
        __syncthreads();
        float s[4][8];
        if (on)
            by_half<R0, R1>(half, [&](auto r) {
                score_rows<decltype(r)::value>(sq, LD, sq + T, LD, dqk, n8, gt, s);
            });
        __syncthreads();  // the round's q and k are read no more
        if (on)
            by_half<R0, R1>(half, [&](auto r) {
                put_rows<decltype(r)::value>(s, A, lda, n8, gt, [&](float x, int i, int j, int r2) {
                    float ds;
                    return masked_silu(x, i < L && j <= i && (kbits >> r2 & 1u), p.inv_n, ds);
                });
            });
        for (int h2 = h1; h2 < nh && h2 < h1 + NP; ++h2)  // u into the round's k tiles
            stage(slots + (h2 * 3 + 1) * T, LD, p.u + b * p.sub + (h0 + h2) * dv, p.sul, L, L,
                  dv, tid, NT);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // v has landed
        __syncthreads();
        for (int slab = 0; slab * 64 < dv; ++slab) {
            float4 o[4][2];
            if (on)
                by_half<R0, R1>(half, [&](auto r) {
                    mix_rows<decltype(r)::value>(A, lda, sv, LD, dv, L, n8, gt, slab, o);
                });
            if (!own) __syncthreads();  // A is read no more: O takes its place
            if (on)
                by_half<R0, R1>(half, [&](auto r) {
                    store_rows<decltype(r)::value>(o, sq, LD, L, dv, gt, slab);
                });
        }
    }
    tc::cp_async_wait<0>();
    __syncthreads();

    // LayerNorm over the cluster's F columns: 4 threads a row, a float4 each
    // of a head's columns in turn
    const int i = tid >> 2, part = tid & 3;
    const bool row = i < L;
    float sum = 0.f;
    if (row)
        for (int hl = 0; hl < nh; ++hl)
            for (int c = 4 * part; c < dv; c += 16) {
                const float4 x = ld4(slots + hl * 3 * T + i * LD + c);
                sum += (x.x + x.y) + (x.z + x.w);
            }
    sum = row_total(sum);
    if (row && part == 0) red[i] = sum;
    cluster_sync();
    const float mu = row ? cluster_total(red, i, C) / F : 0.f;
    sum = 0.f;
    if (row)
        for (int hl = 0; hl < nh; ++hl)
            for (int c = 4 * part; c < dv; c += 16) {
                const float4 x = ld4(slots + hl * 3 * T + i * LD + c);
                const float d0 = x.x - mu, d1 = x.y - mu, d2 = x.z - mu, d3 = x.w - mu;
                sum = fmaf(d0, d0, fmaf(d1, d1, fmaf(d2, d2, fmaf(d3, d3, sum))));
            }
    sum = row_total(sum);
    if (row && part == 0) red[MAX_L + i] = sum;
    cluster_sync();
    const float rstd = row ? 1.f / sqrtf(cluster_total(red + MAX_L, i, C) / F + p.eps) : 0.f;
    cluster_arrive();  // no more reads of other blocks' shared memory

    // the gate, on this block's columns (u in the k tiles)
    if (row) {
        float* orow = out + ((long long)b * L + i) * F + c0;
        for (int hl = 0; hl < nh; ++hl)
            for (int c = 4 * part; c < dv; c += 16) {
                const float* xp = slots + hl * 3 * T + i * LD + c;
                const float4 x = ld4(xp), uu = ld4(xp + T);
                const int col = c0 + hl * dv + c;
                const float4 ga = __ldg(reinterpret_cast<const float4*>(p.gamma + col));
                const float4 be = __ldg(reinterpret_cast<const float4*>(p.beta + col));
                st4(orow + hl * dv + c, make_float4(uu.x * ((x.x - mu) * rstd * ga.x + be.x),
                                                    uu.y * ((x.y - mu) * rstd * ga.y + be.y),
                                                    uu.z * ((x.z - mu) * rstd * ga.z + be.z),
                                                    uu.w * ((x.w - mu) * rstd * ga.w + be.w)));
            }
    }
    cluster_wait();  // no block leaves while another may read its partial sums
}

inline int launch_cluster(const Args& a, void* out, int B, cudaStream_t stream) {
    if (!fits(a.L, a.H, a.dqk, a.dv, false) || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = fwd_smem_bytes(a.L, a.H, a.dqk, a.dv);
    float* o = static_cast<float*>(out);
    if (round8(a.L) == 56)
        return launch_clusters(stu_gated_fwd_cluster_kernel<true>, cluster_size(a.H), B, smem,
                               stream, a, o);
    return launch_clusters(stu_gated_fwd_cluster_kernel<false>, cluster_size(a.H), B, smem, stream,
                           a, o);
}

}  // namespace stu32

// Block (rank, b) of batch row b's cluster: heads [rank·hb, rank·hb + nh),
// block columns [c0, c0 + nh·dv) of the F = H·dv. Shared memory: the
// exchanged partial sums and row statistics, two score tiles P1, P2, one
// head's q, k, v tiles [L8][LD] (L8 = round8(L)), and the block's rows X
// [L8][hb·dv + 4]: its heads' attention outputs x, then dattn. Each product
// runs on all 256 threads (4 × 4 register tiles, hstu_stu_cluster.cuh's
// score16 / mix16). Three phases:
//   (a) each head's q, k, v staged in turn (the next head's q and k while
//       this head's x = A·v runs): S, A → P1, x = A·v → X;
//   (b) 4 threads a row: the LayerNorm's mean and 1/σ, then dy = u·g,
//       du = (x̂γ + β)·g, dx̂ = dy·γ and the row means m1 = mean(dx̂),
//       m2 = mean(dx̂·x̂), each row sum exchanged over the cluster; a thread
//       a column: dγ = Σ dy·x̂ and dβ = Σ dy over the block's rows; then
//       dattn = (dx̂ − m1 − x̂·m2)/σ replaces x in X (u and g are read again
//       for these passes, from L2);
//   (c) each head again, in reverse order (the last head of (a) is still
//       staged, its A still in P1 and its S in P2): S and dA = dattn·vᵀ
//       from the same register tiles, A → P1 and ds = mask ⊙ dA ⊙
//       silu′(S)/n → P2; dv = Aᵀ·dattn, dq = ds·k and dk = dsᵀ·q (the score
//       tiles read across for the transposes), each straight to device
//       memory.
// g, du, dv [B, L, H·dv], dq, dk [B, L, H·dqk] contiguous; dγ, dβ partials
// [B, H·dv] (batch row b's, which the wrapper sums).
namespace stu32 {

__global__ void __launch_bounds__(NT, 2)
stu_gated_bwd_cluster_kernel(Args p, const float* __restrict__ g, float* __restrict__ dq,
                             float* __restrict__ dk, float* __restrict__ dvo,
                             float* __restrict__ du, float* __restrict__ dgam_part,
                             float* __restrict__ dbet_part) {
    extern __shared__ __align__(16) float smem[];
    const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int L = p.L, L8 = round8(L), nb = (L + 15) / 16, dqk = p.dqk, dv = p.dv;
    const int hb = heads_per_block(p.H), h0 = rank * hb, nh = min(hb, p.H - h0);
    const int LD = tile_ld(dqk, dv), T = L8 * LD, XLD = hb * dv + 4;
    const int F = p.H * dv, Fq = p.H * dqk, c0 = h0 * dv, Fb = nh * dv;
    float* red = smem;                // [4][MAX_L] this block's partial row sums
    float* stat = smem + 4 * MAX_L;   // [2][MAX_L] mean, 1/σ
    float* P1 = smem + STAT_FLOATS;   // [MAX_L][PLD]
    float* P2 = P1 + P_FLOATS;        // [MAX_L][PLD]
    float* sq = P2 + P_FLOATS;        // [L8][LD] q, k, v of one head
    float* sk = sq + T;
    float* sv = sk + T;
    float* X = sv + T;                // [L8][XLD]
    const float* ub = p.u + b * p.sub + c0;
    const float* gb = g + (long long)b * L * F + c0;
    const unsigned char* np = p.nonpad + (long long)b * L;
    const int ti = tid >> 4, tj = tid & 15;
    bool kp[4];  // this thread's key columns tj + 16·r' are in the window, not padding
#pragma unroll
    for (int r = 0; r < 4; ++r) kp[r] = tj + 16 * r < L && np[tj + 16 * r];

    auto stage_qk = [&](int h) {
        stage(sq, LD, p.q + b * p.sqb + h * dqk, p.sql, L, L8, dqk, tid, NT);
        stage(sk, LD, p.k + b * p.skb + h * dqk, p.skl, L, L8, dqk, tid, NT);
    };
    auto stage_v = [&](int h) { stage(sv, LD, p.v + b * p.svb + h * dv, p.svl, L, L8, dv, tid, NT); };

    // (a) the forward's attention rows of this block's heads; u and g, first
    // read in (b), asked into L2 meanwhile
    stage_qk(h0);
    stage_v(h0);
    tc::cp_async_commit();
    prefetch_rows(ub, p.sul, L, Fb);
    prefetch_rows(gb, F, L, Fb);
    for (int hl = 0; hl < nh; ++hl) {
        tc::cp_async_wait<0>();
        __syncthreads();
        {
            float s[4][4];
            score16(sq, LD, sk, LD, dqk, nb, L8 - 1, s);
            const bool last = hl == nh - 1;  // (c) starts with this head: keep its S in P2
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int r2 = 0; r2 <= r; ++r2) {
                    if (r >= nb) continue;
                    const int i = ti + 16 * r, j = tj + 16 * r2;
                    float dsilu;
                    P1[i * PLD + j] = masked_silu(s[r][r2], i < L && j <= i && kp[r2], p.inv_n, dsilu);
                    if (last) P2[i * PLD + j] = s[r][r2];
                }
        }
        __syncthreads();  // A whole; q and k are read no more
        if (hl + 1 < nh) {
            stage_qk(h0 + hl + 1);
            tc::cp_async_commit();
        }
        for (int c = 0; c < dv; c += 64) {  // 64 columns at a time
            float4 o[4][1];
            mix16<true, false, 1>(P1, sv + c, LD, dv - c, L, nb, o);
            store16<1>(o, X + hl * dv + c, XLD, L, dv - c);
        }
        __syncthreads();  // P1 and v are free again
        if (hl + 1 < nh) {
            stage_v(h0 + hl + 1);
            tc::cp_async_commit();
        }
    }

    // (b) the LayerNorm and gate backward, 4 threads a row
    const int i = tid >> 2, quad = tid & 3;
    const bool row = i < L;
    float sum = 0.f;
    if (row)
        for (int c = 4 * quad; c < Fb; c += 16) {
            const float4 x = ld4(X + i * XLD + c);
            sum += (x.x + x.y) + (x.z + x.w);
        }
    sum = row_total(sum);
    if (row && quad == 0) red[i] = sum;
    cluster_sync();
    const float mu = row ? cluster_total(red, i, C) / F : 0.f;
    sum = 0.f;
    if (row)
        for (int c = 4 * quad; c < Fb; c += 16) {
            const float4 x = ld4(X + i * XLD + c);
            const float d0 = x.x - mu, d1 = x.y - mu, d2 = x.z - mu, d3 = x.w - mu;
            sum = fmaf(d0, d0, fmaf(d1, d1, fmaf(d2, d2, fmaf(d3, d3, sum))));
        }
    sum = row_total(sum);
    if (row && quad == 0) red[MAX_L + i] = sum;
    cluster_sync();
    const float rstd = row ? 1.f / sqrtf(cluster_total(red + MAX_L, i, C) / F + p.eps) : 0.f;
    if (row && quad == 0) {
        stat[i] = mu;
        stat[MAX_L + i] = rstd;
    }
    // du and the row sums of dx̂ and dx̂·x̂; u and g four float4 at a time,
    // all in flight before the first is used
    float m1 = 0.f, m2 = 0.f;
    if (row)
        for (int c1 = 4 * quad; c1 < Fb; c1 += 64) {
            float4 uu[4], gg[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = c1 + 16 * e;
                uu[e] = c < Fb ? ld4(ub + i * p.sul + c) : make_float4(0.f, 0.f, 0.f, 0.f);
                gg[e] = c < Fb ? ld4(gb + (long long)i * F + c) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = c1 + 16 * e;
                if (c >= Fb) break;
                const float4 x = ld4(X + i * XLD + c);
                const float4 ga = __ldg(reinterpret_cast<const float4*>(p.gamma + c0 + c));
                const float4 be = __ldg(reinterpret_cast<const float4*>(p.beta + c0 + c));
                const float xs[4] = {x.x, x.y, x.z, x.w}, us[4] = {uu[e].x, uu[e].y, uu[e].z, uu[e].w};
                const float gs[4] = {gg[e].x, gg[e].y, gg[e].z, gg[e].w};
                const float gam[4] = {ga.x, ga.y, ga.z, ga.w}, bet[4] = {be.x, be.y, be.z, be.w};
                float dus[4];
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    const float xh = (xs[t] - mu) * rstd, dxh = us[t] * gs[t] * gam[t];
                    dus[t] = (xh * gam[t] + bet[t]) * gs[t];
                    m1 += dxh;
                    m2 += dxh * xh;
                }
                st4(du + ((long long)b * L + i) * F + c0 + c, make_float4(dus[0], dus[1], dus[2], dus[3]));
            }
        }
    m1 = row_total(m1);
    m2 = row_total(m2);
    if (row && quad == 0) {
        red[2 * MAX_L + i] = m1;
        red[3 * MAX_L + i] = m2;
    }
    __syncthreads();
    // dγ, dβ of the block's columns over its rows, a thread a column
    for (int c = tid; c < Fb; c += NT) {
        float sg = 0.f, sb = 0.f;
#pragma unroll 8
        for (int r = 0; r < L; ++r) {
            const float xh = (X[r * XLD + c] - stat[r]) * stat[MAX_L + r];
            const float dy = __ldg(ub + r * p.sul + c) * __ldg(gb + (long long)r * F + c);
            sg = fmaf(dy, xh, sg);
            sb += dy;
        }
        dgam_part[(long long)b * F + c0 + c] = sg;
        dbet_part[(long long)b * F + c0 + c] = sb;
    }
    cluster_sync();
    m1 = row ? cluster_total(red + 2 * MAX_L, i, C) / F : 0.f;
    m2 = row ? cluster_total(red + 3 * MAX_L, i, C) / F : 0.f;
    cluster_arrive();  // no more reads of other blocks' shared memory
    // dattn = (dx̂ − m1 − x̂·m2)/σ in place of x; rows [L, L8) zero
    if (!row && i < L8)
        for (int c = 4 * quad; c < Fb; c += 16) st4(X + i * XLD + c, make_float4(0.f, 0.f, 0.f, 0.f));
    if (row)
#pragma unroll 4
        for (int c = 4 * quad; c < Fb; c += 16) {
            const float4 x = ld4(X + i * XLD + c);
            const float4 uu = __ldg(reinterpret_cast<const float4*>(ub + i * p.sul + c));
            const float4 gg = __ldg(reinterpret_cast<const float4*>(gb + (long long)i * F + c));
            const float4 ga = __ldg(reinterpret_cast<const float4*>(p.gamma + c0 + c));
            st4(X + i * XLD + c,
                make_float4((uu.x * gg.x * ga.x - m1 - (x.x - mu) * rstd * m2) * rstd,
                            (uu.y * gg.y * ga.y - m1 - (x.y - mu) * rstd * m2) * rstd,
                            (uu.z * gg.z * ga.z - m1 - (x.z - mu) * rstd * m2) * rstd,
                            (uu.w * gg.w * ga.w - m1 - (x.w - mu) * rstd * m2) * rstd));
        }
    __syncthreads();  // dattn whole

    // (c) the attention backward of each head, the last staged one first
    for (int hl = nh - 1; hl >= 0; --hl) {
        const int h = h0 + hl;
        if (hl != nh - 1) {
            stage_qk(h);
            stage_v(h);
            tc::cp_async_commit();
            tc::cp_async_wait<0>();
            __syncthreads();
        }
        const float* G = X + hl * dv;  // this head's dattn [L8][XLD]
        const bool first = hl == nh - 1;  // its A is still in P1, its S in P2
        float s[4][4], ds[4][4];
        if (!first) score16(sq, LD, sk, LD, dqk, nb, L8 - 1, s);
        score16(G, XLD, sv, LD, dv, nb, L8 - 1, ds);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int r2 = 0; r2 <= r; ++r2) {
                if (r >= nb) continue;
                const int i = ti + 16 * r, j = tj + 16 * r2;
                const bool keep = i < L && j <= i && kp[r2];
                float dsilu;
                const float a = masked_silu(first ? P2[i * PLD + j] : s[r][r2], keep, p.inv_n, dsilu);
                if (!first) P1[i * PLD + j] = a;
                P2[i * PLD + j] = keep ? ds[r][r2] * dsilu : 0.f;
            }
        __syncthreads();  // A in P1, ds in P2
        float4 o[4][1];
        for (int c = 0; c < dv; c += 64) {  // dv = Aᵀ·dattn, 64 columns at a time
            mix16<false, true, 1>(P1, G + c, XLD, dv - c, L, nb, o);
            store16<1>(o, dvo + (long long)b * L * F + h * dv + c, F, L, dv - c);
        }
        for (int c = 0; c < dqk; c += 64) {
            mix16<true, false, 1>(P2, sk + c, LD, dqk - c, L, nb, o);  // dq = ds·k
            store16<1>(o, dq + (long long)b * L * Fq + h * dqk + c, Fq, L, dqk - c);
            mix16<false, true, 1>(P2, sq + c, LD, dqk - c, L, nb, o);  // dk = dsᵀ·q
            store16<1>(o, dk + (long long)b * L * Fq + h * dqk + c, Fq, L, dqk - c);
        }
        __syncthreads();  // P1, P2 and the staged head are free again
    }
    cluster_wait();  // no block leaves while another may read its partial sums
}

inline int launch_cluster(const Args& a, const void* g, void* dq, void* dk, void* dv, void* du,
                          float* dgam_part, float* dbet_part, int B, cudaStream_t stream) {
    if (!fits(a.L, a.H, a.dqk, a.dv, true) || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = bwd_smem_bytes(a.L, a.H, a.dqk, a.dv);
    const float* gf = static_cast<const float*>(g);
    float* o[4] = {static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                   static_cast<float*>(du)};
    return launch_clusters(stu_gated_bwd_cluster_kernel, cluster_size(a.H), B, smem, stream, a,
                           gf, o[0], o[1], o[2], o[3], dgam_part, dbet_part);
}

}  // namespace stu32

}  // namespace hstu

// C interface, loaded with ctypes. Strides are in elements (the last
// dimension of every tensor is contiguous). Both need L ≤ 64, dqk and dv
// multiples of 4 up to 128, q/k/v/u (and g) 16-byte aligned with batch and
// row strides multiples of 4, γ and β 16-byte aligned, and the shared memory
// of stu32::fwd_smem_bytes / bwd_smem_bytes. Each returns the cudaError_t of
// its launch (0 = cudaSuccess), or −1 when no cluster of that shape fits on
// the card.

// out [B, L, H·dv] contiguous
extern "C" int hstu_stu_f32_fwd(const float* q, const float* k, const float* v, const float* u,
                                const float* gamma, const float* beta,
                                const unsigned char* nonpad, float* out, int B, int L, int H,
                                int dqk, int dv, long long sqb, long long sql, long long skb,
                                long long skl, long long svb, long long svl, long long sub,
                                long long sul, float inv_n, float eps, void* stream) {
    const hstu::stu32::Args a{q, k, v, u, gamma, beta, nonpad, L, H, dqk, dv,
                              sqb, sql, skb, skl, svb, svl, sub, sul, inv_n, eps};
    return hstu::stu32::launch_cluster(a, out, B, static_cast<cudaStream_t>(stream));
}

// strides: (batch, row) strides of q, k, v, u (8 values); g, dq, dk
// [B, L, H·dqk], dv, du [B, L, H·dv] contiguous; dgam_part, dbet_part
// [B, H·dv]
extern "C" int hstu_stu_f32_bwd(const float* q, const float* k, const float* v, const float* u,
                                const float* gamma, const float* beta,
                                const unsigned char* nonpad, const float* g, float* dq, float* dk,
                                float* dv, float* du, float* dgam_part, float* dbet_part, int B,
                                int L, int H, int dqk, int dv_width, const long long* st,
                                float inv_n, float eps, void* stream) {
    const hstu::stu32::Args a{q, k, v, u, gamma, beta, nonpad, L, H, dqk, dv_width,
                              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], inv_n, eps};
    return hstu::stu32::launch_cluster(a, g, dq, dk, dv, du, dgam_part, dbet_part, B,
                                       static_cast<cudaStream_t>(stream));
}

// Shared device code of the fused STU block's bfloat16 tensor-core kernels,
// forward (hstu_stu_gated_fwd.cu) and backward (hstu_stu_gated_bwd.cu, whose
// first step recomputes the forward's attention rows): every head's
//     A = mask ⊙ silu(q kᵀ) / n,   out_h = A v
// for one block of 16 query rows, concatenated into a float32 row buffer
// [16, F + 8] in shared memory, with mask[i, j] = (j <= i) & nonpad[j].
//
// Numerics follow the JAX kernels (mhrec_tpu/ops/pallas/hstu_attention_tpu.py,
// _fwd_gated_kernel and the recompute of _bwd_gated_kernel): q·kᵀ summed in
// f32, silu and the 1/n scale in f32, masked entries zeroed, A rounded to
// bf16 (v's type) before the A·v product, which is summed in f32.
//
// Design: 4 warps, warp w taking heads w, w + 4, ... Each warp streams its
// own (head, key tile) items — the head's 16 query rows and a tile of 32 of
// its keys and values, bf16, rows padded by 16 bytes, the widths zero-filled
// up to DP — through a ring of one or two stages filled by 16-byte cp.async.
// The block is latency-bound (few warps, short dependent steps), so the
// stages are sized to let two blocks share an SM (at F = 1024 the row buffer
// alone takes 66 KB): two stages where that still holds, else one
// (tc_stages). S = Q·Kᵀ and O += A·V run as mma.sync m16n8k16 with bf16
// operands from ldmatrix and float32 accumulators; the mask, silu and 1/n
// stay float32 in registers, and A is rounded to bf16 once, straight from
// the score accumulators into the A fragments of A·V. Key blocks of 16 past
// the causal edge are neither copied, nor scored, nor multiplied.
#pragma once

#include "tc_bf16.cuh"

namespace hstu {

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;
constexpr int TC_NT = 32 * TC_WARPS;  // threads a block
constexpr int TC_BM = 16;             // query rows a block: one m16 tile
constexpr int TC_TK = 32;             // key rows of a streamed tile
constexpr int TC_SMEM_MAX = 232448;   // bytes of shared memory a block may use
constexpr int TC_SMEM_PAIR = 115712;  // the most that lets two blocks share an SM

// bytes of dynamic shared memory: the float32 row buffer [16][F + 8], the
// warps' stages (q [16], k and v [TC_TK] rows of DP + 8 bf16 each), and the
// window's nonpad flags
__host__ __device__ inline size_t tc_smem_bytes(int dp, int F, int L, int ns) {
    return sizeof(float) * (size_t)TC_BM * (F + 8) +
           sizeof(bf16) * (size_t)TC_WARPS * ns * (TC_BM + 2 * TC_TK) * (dp + tc::PAD) +
           (size_t)((L + 15) & ~15);
}

// stages a warp: two where two blocks still share an SM, else one where
// that lets them, else two where one block holds them, else one. `extra`:
// the bytes of shared memory the kernel holds besides tc_smem_bytes
inline int tc_stages(int dp, int F, int L, size_t extra = 0) {
    if (tc_smem_bytes(dp, F, L, 2) + extra <= (size_t)TC_SMEM_PAIR) return 2;
    if (tc_smem_bytes(dp, F, L, 1) + extra <= (size_t)TC_SMEM_PAIR) return 1;
    return tc_smem_bytes(dp, F, L, 2) + extra <= (size_t)TC_SMEM_MAX ? 2 : 1;
}

// the attention's inputs and shape; the epilogues' other tensors are their
// kernels' __restrict__ arguments, so their loads need not wait for stores
struct GatedArgs {
    const bf16 *q, *k, *v;        // [B, L, H·dqk] (q, k), [B, L, H·dv] (v)
    const unsigned char* nonpad;  // [B, L]
    int L, H, dqk, dv;
    long long sqb, sql, skb, skl, svb, svl, sub, sul;  // batch / row strides (sub, sul: u)
    float inv_n, eps;
    int ns;                       // stages a warp: 1 or 2
};

// The row buffer `rows` [TC_BM][F + 8] of query rows [q0, q0 + 16) of batch
// row b, from the dynamic shared memory laid out as rows | stages | key
// flags (tc_smem_bytes). DP is the head width the tiles are laid out for (a
// power of two >= dqk, dv; the columns past them are zero). Rows past the
// window hold zeros. Ends with __syncthreads: the buffer is complete.
template <int DP>
__device__ __forceinline__ void stu_attention_rows_tc(const GatedArgs& p, unsigned char* smem_raw,
                                                      int b, int q0) {
    constexpr int LD = DP + tc::PAD;
    constexpr int TK = TC_TK;
    constexpr int KS = DP / 16;    // depth steps of S
    constexpr int NB = TK / 8;     // 8-key column blocks of a score tile
    constexpr int ND = DP / 8;     // 8-column blocks of a head's output
    constexpr int STAGE = (TC_BM + 2 * TK) * LD;  // bf16 of one stage: q, k, v
    const int L = p.L, H = p.H, F = H * p.dv, FP = F + 8;
    float* rows = reinterpret_cast<float*>(smem_raw);            // [TC_BM][FP]
    bf16* stages = reinterpret_cast<bf16*>(rows + TC_BM * FP);   // [TC_WARPS][ns][STAGE]
    unsigned char* knp = reinterpret_cast<unsigned char*>(stages + TC_WARPS * p.ns * STAGE);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int kend = min(L, q0 + TC_BM);  // causal edge of the query tile
    const int qn = kend - q0;

    bf16* ws = stages + warp * p.ns * STAGE;  // this warp's stages
    const int nkt = (kend + TK - 1) / TK;     // key tiles a head
    const int items = (H - warp + TC_WARPS - 1) / TC_WARPS * nkt;
    const int cq = p.dqk / 8, cv = p.dv / 8;  // 16-byte chunks of a q/k row, of a v row

    // item it = (the warp's head it / nkt, key tile it % nkt) into stage buf:
    // q rows past L, k/v rows past the tile's keys (up to the next 16) and
    // columns past dqk / dv are zero-filled; 16-key blocks wholly past the
    // causal edge are not touched
    auto load_item = [&](int it, int buf) {
        const int h = warp + (it / nkt) * TC_WARPS, k0 = (it % nkt) * TK;
        const int nk = min(TK, kend - k0), nk16 = (nk + 15) & ~15;
        bf16* sq = ws + buf * STAGE;
        bf16* sk = sq + TC_BM * LD;
        bf16* sv = sk + TK * LD;
        const bf16* qh = p.q + b * p.sqb + q0 * p.sql + h * p.dqk;
        const bf16* kh = p.k + b * p.skb + k0 * p.skl + h * p.dqk;
        const bf16* vh = p.v + b * p.svb + k0 * p.svl + h * p.dv;
        for (int e = lane; e < TC_BM * ND; e += 32) {
            const int r = e / ND, ch = e % ND;
            const bool in = r < qn && ch < cq;
            tc::cp_async16(sq + r * LD + ch * 8, in ? qh + r * p.sql + ch * 8 : qh, in);
        }
        for (int e = lane; e < nk16 * ND; e += 32) {
            const int r = e / ND, ch = e % ND;
            const bool ink = r < nk && ch < cq, inv = r < nk && ch < cv;
            tc::cp_async16(sk + r * LD + ch * 8, ink ? kh + r * p.skl + ch * 8 : kh, ink);
            tc::cp_async16(sv + r * LD + ch * 8, inv ? vh + r * p.svl + ch * 8 : vh, inv);
        }
    };

    const int rowa = q0 + g, rowb = rowa + 8;  // this thread's rows of every tile
    const float inv_n = p.inv_n;
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    if (items > 0) {
        load_item(0, 0);
        tc::cp_async_commit();
    }
    // the keys' flags, read while the first item is in flight
    for (int j = tid; j < kend; j += TC_NT) knp[j] = p.nonpad[(long long)b * L + j];
    __syncthreads();
    for (int it = 0; it < items; ++it) {
        const int buf = p.ns == 2 ? (it & 1) : 0;
        if (p.ns == 2) {
            if (it + 1 < items) load_item(it + 1, buf ^ 1);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();  // this item has landed
        } else {
            tc::cp_async_wait<0>();
        }
        __syncwarp();
        const int h = warp + (it / nkt) * TC_WARPS, kt = it % nkt, k0 = kt * TK;
        const int nkb = (min(TK, kend - k0) + 15) >> 4;  // 16-key blocks holding keys
        const bf16* sq = ws + buf * STAGE;
        const bf16* sk = sq + TC_BM * LD;
        const bf16* sv = sk + TK * LD;
        float s[NB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            uint32_t a[4];
            tc::ld_a(a, sq, LD, kk * 16, lane);
#pragma unroll
            for (int np = 0; np < NB / 2; ++np) {
                if (np < nkb) {
                    uint32_t bb[4];
                    tc::ld_b_nk(bb, sk, LD, np * 16, kk * 16, lane);
                    tc::mma(s[2 * np], a, bb[0], bb[1]);
                    tc::mma(s[2 * np + 1], a, bb[2], bb[3]);
                }
            }
        }
        // A = mask ⊙ silu(s) / n, rounded to bf16 as the A fragments of A·V
        // (depth: the tile's keys)
        uint32_t af[TK / 16][4];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
            if (n < 2 * nkb) {
                float x[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = k0 + n * 8 + 2 * t4 + (e & 1), row = e < 2 ? rowa : rowb;
                    const float d = s[n][e];
                    const bool keep = col <= row && col < kend && knp[col];
                    x[e] = keep ? d * __frcp_rn(1.f + __expf(-d)) * inv_n : 0.f;
                }
                af[n >> 1][(n & 1) * 2] = tc::pack_bf16(x[0], x[1]);
                af[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(x[2], x[3]);
            }
        }
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
            if (kk < nkb) {
#pragma unroll
                for (int np = 0; np < DP / 16; ++np) {
                    uint32_t bb[4];
                    tc::ld_b_kn(bb, sv, LD, kk * 16, np * 16, lane);
                    tc::mma(acc[2 * np], af[kk], bb[0], bb[1]);
                    tc::mma(acc[2 * np + 1], af[kk], bb[2], bb[3]);
                }
            }
        }
        __syncwarp();  // the readers of this stage are done before it is refilled
        if (kt == nkt - 1) {  // the head is done: its columns of the row buffer
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                if (n < cv) {
                    const int col = h * p.dv + n * 8 + 2 * t4;
                    *reinterpret_cast<float2*>(rows + g * FP + col) =
                        make_float2(acc[n][0], acc[n][1]);
                    *reinterpret_cast<float2*>(rows + (g + 8) * FP + col) =
                        make_float2(acc[n][2], acc[n][3]);
                }
                acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
            }
        }
        if (p.ns == 1 && it + 1 < items) {
            load_item(it + 1, 0);
            tc::cp_async_commit();
        }
    }
    __syncthreads();
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// the bf16 pair of a 32-bit word as floats (a bf16 is the high half of its
// float32)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// mean and 1/σ of the LayerNorm (two-pass, f32) of rows warp + r·TC_WARPS of
// the row buffer, r < TC_BM / TC_WARPS, for every lane of the warp
__device__ __forceinline__ void row_stats(const float* rows, int F, float eps, int warp, int lane,
                                          float (&mu)[TC_BM / TC_WARPS],
                                          float (&rstd)[TC_BM / TC_WARPS]) {
    const int FP = F + 8;
#pragma unroll
    for (int r = 0; r < TC_BM / TC_WARPS; ++r) {
        const float* x = rows + (warp + r * TC_WARPS) * FP;
        float s = 0.f;
        for (int c = lane * 4; c < F; c += 128) {
            const float4 xv = *reinterpret_cast<const float4*>(x + c);
            s += (xv.x + xv.y) + (xv.z + xv.w);
        }
        mu[r] = warp_sum(s) / F;
        float s2 = 0.f;
        for (int c = lane * 4; c < F; c += 128) {
            const float4 xv = *reinterpret_cast<const float4*>(x + c);
            const float d0 = xv.x - mu[r], d1 = xv.y - mu[r], d2 = xv.z - mu[r], d3 = xv.w - mu[r];
            s2 = fmaf(d0, d0, fmaf(d1, d1, fmaf(d2, d2, fmaf(d3, d3, s2))));
        }
        rstd[r] = 1.f / sqrtf(warp_sum(s2) / F + eps);
    }
}

}  // namespace hstu

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
//   (stu_gated_fwd_tc_kernel): 4 warps, warp w taking heads w, w + 4, ...
//   Each warp streams its own (head, key tile) items — the head's 16 query
//   rows and a tile of 32 of its keys and values, bf16, rows padded by 16
//   bytes, the widths zero-filled up to DP — through a ring of one or two
//   stages filled by 16-byte cp.async. The block is latency-bound (few
//   warps, short dependent steps), so the stages are sized to let two blocks
//   share an SM (at F = 1024 the row buffer alone takes 66 KB): two stages
//   where that still holds, else one (tc_stages). S = Q·Kᵀ and O += A·V run
//   as mma.sync m16n8k16 with bf16 operands from ldmatrix and float32
//   accumulators; the mask, silu and 1/n stay float32 in registers, and A is
//   rounded to bf16 once, exactly where the JAX kernel rounds it to v's
//   type, straight from the score accumulators into the A fragments of A·V.
//   Key blocks of 16 past the causal edge are neither copied, nor scored,
//   nor multiplied. The LayerNorm and gate take each warp's four rows
//   together, reading γ and β once a warp and u, γ, β and the row buffer
//   with 16-byte loads, and store out 16 bytes a lane.
// * float32, and bfloat16 at other head widths (stu_gated_fwd_kernel, with
//   head_attention of hstu_attn_common.cuh): CUDA-core FMAs out of float32
//   shared-memory tiles, heads walked in a loop; float32 keeps every product
//   in full float32 (the tensor cores would take it as TF32).
#include "hstu_attn_common.cuh"
#include "tc_bf16.cuh"

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

// ---- the bfloat16 route: tensor-core kernel ---------------------------------

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
// that lets them, else two where one block holds them, else one
inline int tc_stages(int dp, int F, int L) {
    if (tc_smem_bytes(dp, F, L, 2) <= (size_t)TC_SMEM_PAIR) return 2;
    if (tc_smem_bytes(dp, F, L, 1) <= (size_t)TC_SMEM_PAIR) return 1;
    return tc_smem_bytes(dp, F, L, 2) <= (size_t)TC_SMEM_MAX ? 2 : 1;
}

// the attention's inputs and shape; the epilogue's u, γ, β and out are the
// kernel's __restrict__ arguments, so its loads need not wait for its stores
struct GatedArgs {
    const bf16 *q, *k, *v;        // [B, L, H·dqk] (q, k), [B, L, H·dv] (v)
    const unsigned char* nonpad;  // [B, L]
    int L, H, dqk, dv;
    long long sqb, sql, skb, skl, svb, svl, sub, sul;  // batch / row strides (sub, sul: u)
    float inv_n, eps;
    int ns;                       // stages a warp: 1 or 2
};

// One block: query rows [q0, q0 + 16) of batch row b. DP is the head width
// the tiles are laid out for (a power of two >= dqk, dv; the columns past
// them are zero). u [B, L, H·dv] at strides sub, sul; γ, β [H·dv]; out
// [B, L, H·dv] contiguous.
template <int DP>
__global__ void __launch_bounds__(TC_NT)
stu_gated_fwd_tc_kernel(GatedArgs p, const bf16* __restrict__ u, const float* __restrict__ gamma,
                        const float* __restrict__ beta, bf16* __restrict__ out) {
    constexpr int LD = DP + tc::PAD;
    constexpr int TK = TC_TK;
    constexpr int KS = DP / 16;    // depth steps of S
    constexpr int NB = TK / 8;     // 8-key column blocks of a score tile
    constexpr int ND = DP / 8;     // 8-column blocks of a head's output, 16-byte chunks of a row
    constexpr int STAGE = (TC_BM + 2 * TK) * LD;  // bf16 of one stage: q, k, v
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int L = p.L, H = p.H, F = H * p.dv, FP = F + 8;
    float* rows = reinterpret_cast<float*>(smem_raw);            // [TC_BM][FP]
    bf16* stages = reinterpret_cast<bf16*>(rows + TC_BM * FP);   // [TC_WARPS][ns][STAGE]
    unsigned char* knp = reinterpret_cast<unsigned char*>(stages + TC_WARPS * p.ns * STAGE);

    const int b = blockIdx.y, q0 = blockIdx.x * TC_BM;
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

    // LayerNorm (two-pass mean / variance in f32) and the u gate. Warp w
    // takes rows w, w + 4, w + 8, w + 12: first their statistics from the row
    // buffer, then 8 columns a lane at a time across those rows, so that γ
    // and β are read once a warp and a step's loads are in flight together
    constexpr int RW = TC_BM / TC_WARPS;  // rows a warp
    float mu[RW], rstd[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
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
        rstd[r] = 1.f / sqrtf(warp_sum(s2) / F + p.eps);
    }
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
                // a bf16 is the high half of its float32
                const float u0 = __uint_as_float(uw[e] << 16);
                const float u1 = __uint_as_float(uw[e] & 0xffff0000u);
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

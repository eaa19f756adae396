// Shared device code of the pointwise HSTU attention's bfloat16 tensor-core
// kernels, forward (hstu_attn_fwd.cu) and backward (hstu_attn_bwd.cuh): a
// block of 4 warps, each owning 16 rows of the block's 64-row tile, products
// as mma.sync m16n8k16 with bf16 operands from ldmatrix and float32
// accumulators (tc_bf16.cuh), tiles bf16 in shared memory with rows padded
// by 16 bytes.
//
// Both directions compute a warp's score tiles with score_tile (the
// backward twice, for x = q·kᵀ and dA = g·vᵀ), read the keys' nonpad flags
// as 64 bits a tile (key_bits) and compute every entry of
// A = mask ⊙ silu(x)/n with masked_silu, so that the backward recomputes A
// with the forward's own code. The forward turns A straight from the
// accumulators into the A fragments of O += A·V (silu_frags), with the
// numerics of _fwd_kernel_v2 (mhrec_tpu/ops/pallas/hstu_attention_tpu.py):
// s summed in f32, silu and 1/n in f32, masked entries exactly 0, A rounded
// once to nearest even; the backward adds ds (silu_grad_frags in
// hstu_attn_bwd.cuh). The causal test is one compare an entry, so that the
// elementwise work between the two products stays small beside them.
#pragma once

#include "tc_bf16.cuh"

namespace hstu {

using bf16 = __nv_bfloat16;

constexpr int TB_WARPS = 4;
constexpr int TB_NT = 32 * TB_WARPS;  // threads a block
constexpr int TB_M = 16 * TB_WARPS;   // rows of a block's own tile, 16 a warp
constexpr int TB_WINDOW = TB_M;       // the longest window one block holds whole

// acc += f · T over the depth blocks [blo, bhi): f the A fragments of a
// [16, 16·KB] bf16 tile, T a tile of 16·KB rows stored [depth][DP]
template <int DP, int KB>
__device__ __forceinline__ void mma_frags(float (&acc)[DP / 8][4], const uint32_t (&f)[KB][4],
                                          const bf16* tile, int blo, int bhi, int lane) {
    constexpr int LD = DP + tc::PAD;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
        if (kk >= blo && kk < bhi) {
#pragma unroll
            for (int np = 0; np < DP / 16; ++np) {
                uint32_t b[4];
                tc::ld_b_kn(b, tile, LD, kk * 16, np * 16, lane);
                tc::mma(acc[2 * np], f[kk], b[0], b[1]);
                tc::mma(acc[2 * np + 1], f[kk], b[2], b[3]);
            }
        }
    }
}

template <int DP>
__device__ __forceinline__ void zero_acc(float (&acc)[DP / 8][4]) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// A warp's [16, DP] accumulator rounded to bf16 once and written to rows
// [0, nrows) and 16-byte chunks [0, cw) of out (row stride ld), through the
// warp's own [16][DP + PAD] staging rows st, so that the stores are 16 bytes
// a lane
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4], bf16* st, bf16* out,
                                           long long ld, int nrows, int cw, int lane) {
    constexpr int LD = DP + tc::PAD;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(st + g * LD + col) = tc::pack_bf16(acc[n][0], acc[n][1]);
        *reinterpret_cast<uint32_t*>(st + (g + 8) * LD + col) = tc::pack_bf16(acc[n][2], acc[n][3]);
    }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * (DP / 8); e += 32) {
        const int r = e / (DP / 8), ch = e % (DP / 8);
        if (r < nrows && ch < cw)
            *reinterpret_cast<uint4*>(out + r * ld + ch * 8) =
                *reinterpret_cast<const uint4*>(st + r * LD + ch * 8);
    }
    __syncwarp();  // the staging rows are free again
}

// row r of head (b, h) of a [B, H, L, d] tensor at strides s (batch, head, row)
template <typename P>
__device__ __forceinline__ P* row_ptr(P* base, const long long (&s)[3], int b, int h, int r) {
    return base + b * s[0] + h * s[1] + r * s[2];
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

// A warp's score tile s = R · Cᵀ: R the warp's 16 rows (pitch DP + PAD), C a
// tile of 8·NB rows; only the 16-column blocks [blo, bhi) are computed (the
// others stay 0)
template <int DP, int NB>
__device__ __forceinline__ void score_tile(float (&s)[NB][4], const bf16* r, const bf16* c,
                                           int blo, int bhi, int lane) {
    constexpr int LD = DP + tc::PAD;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        tc::ld_a(a, r, LD, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
            if (np >= blo && np < bhi) {
                uint32_t b[4];
                tc::ld_b_nk(b, c, LD, np * 16, kk * 16, lane);
                tc::mma(s[2 * np], a, b[0], b[1]);
                tc::mma(s[2 * np + 1], a, b[2], b[3]);
            }
        }
    }
}

// The nonpad flags of the 64 keys k0 .. k0 + 63 of a tile (np points at
// key k0; keys from n on count as padding) as the bits of two words, set by
// warps 0 and 1 of the block (the other warps do nothing)
__device__ __forceinline__ void key_bits(unsigned (&w)[2], const unsigned char* np, int n,
                                         int warp, int lane) {
    if (warp < 2) {
        const int j = 32 * warp + lane;
        const unsigned m = __ballot_sync(0xffffffffu, j < n && np[j]);
        if (lane == 0) w[warp] = m;
    }
}

// The 64 flags key_bits set, bit j for key k0 + j
__device__ __forceinline__ unsigned long long key_word(const unsigned (&kw)[2]) {
    return kw[0] | (unsigned long long)kw[1] << 32;
}

// One entry of A = mask ⊙ silu(x)/n, 0 where keep is false: x/n over
// den = 1 + exp(−x), with the fast f32 exponential and division (__expf,
// __fdividef: a few f32 ulps, far below A's bf16 rounding; a correctly
// rounded reciprocal costs several instructions an entry). den is left for
// silu′ = (1 + x(1 − 1/den))/den.
__device__ __forceinline__ float masked_silu(float x, bool keep, float inv_n, float& den) {
    den = 1.f + __expf(-x);
    return keep ? __fdividef(x * inv_n, den) : 0.f;
}

// A = mask ⊙ silu(s)/n of a warp's score tile, rounded to bf16 as the A
// fragments af of the next product (depth: the tile's columns), over the
// 16-column blocks [blo, bhi). Entry (r, c) is query row0 + r and key
// col0 + c; bit c of kw is that key's nonpad flag (kw as key_bits sets it).
// Rows past the window get values that are never stored.
template <int NB>
__device__ __forceinline__ void silu_frags(const float (&s)[NB][4], int row0, int col0,
                                           const unsigned (&kw)[2], float inv_n, int blo, int bhi,
                                           int lane, uint32_t (&af)[NB / 2][4]) {
    static_assert(NB <= 8, "a tile of at most 64 keys");
    const int g = lane >> 2, t4 = lane & 3;
    // entry (g + 8·i, n·8 + 2·t4 + j) of the tile is causal when n·8 + j <= edge + 8·i,
    // and bit n·8 + j of kb is its key's flag
    const int edge = row0 + g - col0 - 2 * t4;
    const unsigned long long kb = key_word(kw) >> (2 * t4);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
        if (n >= 2 * blo && n < 2 * bhi) {
            float a[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = n * 8 + (e & 1);
                float den;
                a[e] = masked_silu(s[n][e], c <= edge + (e & 2) * 4 && ((kb >> c) & 1), inv_n,
                                   den);
            }
            af[n >> 1][(n & 1) * 2] = tc::pack_bf16(a[0], a[1]);
            af[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(a[2], a[3]);
        }
    }
}

}  // namespace hstu

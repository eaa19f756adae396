// Shared device code of the two HSTU backward kernels (hstu_attn_bwd.cu,
// hstu_stu_gated_bwd.cu): the backward of one head's pointwise attention
//     x = q kᵀ,  A = mask ⊙ silu(x) / n,  out = A v
// given the gradient g of out:
//     dv = Aᵀ g
//     ds = mask ⊙ (g vᵀ) ⊙ sig(x)(1 + x(1 − sig(x))) / n
//     dq = ds k,   dk = dsᵀ q
// with mask[i, j] = (j <= i) & nonpad[j].
//
// Numerics follow the JAX kernels (mhrec_tpu/ops/pallas/hstu_attention_tpu.py,
// _bwd_kernel_v2 and _bwd_gated_kernel): both products of the scores summed
// in f32, A rounded to the value type and ds to the query type before the
// three gradient products, which are summed in f32 and rounded to the
// input type on the way out.
//
// No two blocks write the same output row and no atomics are used, so the
// result does not depend on the block schedule and a repeat gives the same
// bits. Two routes, chosen by the callers:
// * float32, and bfloat16 at other head widths (attn_bwd_dkdv_kernel,
//   attn_bwd_dq_kernel): two passes, each recomputing the scores. The dk/dv
//   pass gives each block BT key rows of one head and walks the query tiles
//   at or below the causal diagonal; the dq pass gives each block BT query
//   rows and walks the key tiles up to its causal edge. Tiles live in shared
//   memory as f32, rows padded by one float so the score loop reads them
//   without bank conflicts; products are CUDA-core FMAs, which keep float32
//   in full float32 (the tensor cores would take it as TF32).
// * bfloat16 with head widths that are multiples of 8 up to 128 (the
//   tensor-core kernels at the end of this file): every product is an
//   mma.sync m16n8k16 with bf16 operands from ldmatrix and float32
//   accumulators, tiles are bf16 in shared memory (rows padded by 16 bytes,
//   widths zero-filled up to DP) copied with 16-byte cp.async, and 4 warps
//   each own 16 rows of the block's tile. A warp computes a [16, 8·NB] tile
//   of x and of dA (= g·vᵀ) in one orientation, applies the mask, silu and
//   silu′ and 1/n in f32 registers, and rounds A and ds to bf16 straight
//   from the accumulators into the A fragments of the next products (two
//   m16n8 C tiles are one A fragment), so A and ds never pass through
//   shared memory. With query rows as the warp's rows the fragments give
//   dQ = ds·K; with key rows (x and dA computed transposed, Sᵀ = K·Qᵀ and
//   dAᵀ = V·Gᵀ) they give dV = Aᵀ·G and dK = dsᵀ·Q. 16-row blocks past the
//   causal edge are neither scored nor multiplied.
//   - Windows of at most 64 rows (every HSTU config: window 50) take one
//     block per (batch row, head) holding the whole window
//     (attn_bwd_tc_window_kernel): Q, K, V and G are read once, and each
//     warp runs both orientations on its 16 rows, so the scores are computed
//     twice (once a side) instead of passing A and ds through shared memory
//     and a block barrier.
//   - Longer windows take a dq pass over 64-row query tiles that walks the
//     key tiles up to its causal edge, and a dk/dv pass over 64-row key
//     tiles that walks the query tiles from its diagonal on (32-row tiles at
//     DP = 128, to keep dK, dV and the scores in registers), each streaming
//     its tiles through a ring of two cp.async stages (attn_bwd_dq_tc_kernel,
//     attn_bwd_dkv_tc_kernel).
//   The block shape and the helpers the forward shares (score_tile,
//   key_bits, masked_silu, mma_frags, store_rows) are in hstu_attn_tc.cuh,
//   so A is recomputed here with the forward's own code.
#pragma once

#include "hstu_attn_common.cuh"
#include "hstu_attn_tc.cuh"

namespace hstu {

constexpr int BT = 32;                   // rows per block and per inner tile
constexpr int BMAXR = BT * MAX_D / NT;   // accumulators per thread per output

// Pointers and strides of one backward call. Inputs q, k, v, g; outputs
// gq, gk, gv (the gradients of q, k, v). Strides are in elements, per
// tensor (batch, head, row); the last dimension is contiguous.
struct BwdArgs {
    const void* q;
    const void* k;
    const void* v;
    const void* g;
    const unsigned char* nonpad;  // [B, L]
    void* gq;
    void* gk;
    void* gv;
    int H, L, dqk, dv;
    long long s[7][3];  // q, k, v, g, gq, gk, gv
    float inv_n;
};

// floats of shared memory a backward block needs
__host__ __device__ inline int bwd_smem_floats(int dqk, int dv) {
    return 2 * BT * (dqk + 1) + 2 * BT * (dv + 1) + 2 * BT * (BT + 1);
}

// Rows [r0, r0 + n) of one head (row stride ld) into a [BT][width + 1] f32
// tile; rows n..BT-1 are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long ld,
                                          int r0, int n, int width) {
    const int ldd = width + 1;
    for (int e = threadIdx.x; e < BT * width; e += NT) {
        const int i = e / width, c = e % width;
        dst[i * ldd + c] = i < n ? to_f<T>(src[(long long)(r0 + i) * ld + c]) : 0.f;
    }
}

__device__ __forceinline__ float dot_row(const float* a, const float* b, int n) {
    float d = 0.f;
    for (int c = 0; c < n; ++c) d = fmaf(a[c], b[c], d);
    return d;
}

// A and ds of one unmasked (query, key) pair, each rounded to T
template <typename T>
__device__ __forceinline__ void pair_grads(const float* q_i, const float* k_j, const float* g_i,
                                           const float* v_j, int dqk, int dv, float inv_n,
                                           float& a, float& ds) {
    const float x = dot_row(q_i, k_j, dqk);
    const float da = dot_row(g_i, v_j, dv);
    const float sig = 1.f / (1.f + expf(-x));
    a = to_f<T>(from_f<T>(x * sig * inv_n));
    ds = to_f<T>(from_f<T>(da * (sig * (1.f + x * (1.f - sig))) * inv_n));
}

template <typename T>
__device__ __forceinline__ const T* head_in(const void* base, const long long (&s)[3], int b, int h) {
    return static_cast<const T*>(base) + b * s[0] + h * s[1];
}

template <typename T>
__device__ __forceinline__ T* head_out(void* base, const long long (&s)[3], int b, int h) {
    return static_cast<T*>(base) + b * s[0] + h * s[1];
}

// dk and dv of key rows [k0, k0 + BT) of head (b, h).
template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dkdv_kernel(BwdArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
    const int tid = threadIdx.x, dqk = p.dqk, dv = p.dv, L = p.L;
    const int lq = dqk + 1, lv = dv + 1, ls = BT + 1;
    float* sk = smem;            // [BT][dqk + 1]
    float* sv = sk + BT * lq;    // [BT][dv + 1]
    float* sq = sv + BT * lv;    // [BT][dqk + 1]
    float* sg = sq + BT * lq;    // [BT][dv + 1]
    float* sa = sg + BT * lv;    // [BT][BT + 1]  A[i][j]
    float* sd = sa + BT * ls;    // [BT][BT + 1]  ds[i][j]
    const T* q = head_in<T>(p.q, p.s[0], b, h);
    const T* k = head_in<T>(p.k, p.s[1], b, h);
    const T* v = head_in<T>(p.v, p.s[2], b, h);
    const T* g = head_in<T>(p.g, p.s[3], b, h);
    const unsigned char* np = p.nonpad + (long long)b * L;

    const int nk = min(BT, L - k0);
    load_tile<T>(sk, k, p.s[1][2], k0, nk, dqk);
    load_tile<T>(sv, v, p.s[2][2], k0, nk, dv);
    float acc_k[BMAXR], acc_v[BMAXR];
#pragma unroll
    for (int r = 0; r < BMAXR; ++r) acc_k[r] = acc_v[r] = 0.f;

    for (int q0 = k0; q0 < L; q0 += BT) {  // query tiles at or below the diagonal
        const int nq = min(BT, L - q0);
        __syncthreads();  // the previous tile's readers are done
        load_tile<T>(sq, q, p.s[0][2], q0, nq, dqk);
        load_tile<T>(sg, g, p.s[3][2], q0, nq, dv);
        __syncthreads();
        for (int e = tid; e < BT * BT; e += NT) {
            const int i = e / BT, j = e % BT, row = q0 + i, col = k0 + j;
            float a = 0.f, ds = 0.f;
            if (i < nq && j < nk && col <= row && np[col])
                pair_grads<T>(sq + i * lq, sk + j * lq, sg + i * lv, sv + j * lv, dqk, dv,
                              p.inv_n, a, ds);
            sa[i * ls + j] = a;
            sd[i * ls + j] = ds;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < BMAXR; ++r) {
            const int e = tid + r * NT;
            if (e < BT * dv) {
                const int j = e / dv, c = e % dv;
                float s = acc_v[r];
                for (int i = 0; i < nq; ++i) s = fmaf(sa[i * ls + j], sg[i * lv + c], s);
                acc_v[r] = s;
            }
            if (e < BT * dqk) {
                const int j = e / dqk, c = e % dqk;
                float s = acc_k[r];
                for (int i = 0; i < nq; ++i) s = fmaf(sd[i * ls + j], sq[i * lq + c], s);
                acc_k[r] = s;
            }
        }
    }
    T* gk = head_out<T>(p.gk, p.s[5], b, h);
    T* gv = head_out<T>(p.gv, p.s[6], b, h);
#pragma unroll
    for (int r = 0; r < BMAXR; ++r) {
        const int e = tid + r * NT;
        if (e < BT * dv && e / dv < nk)
            gv[(long long)(k0 + e / dv) * p.s[6][2] + e % dv] = from_f<T>(acc_v[r]);
        if (e < BT * dqk && e / dqk < nk)
            gk[(long long)(k0 + e / dqk) * p.s[5][2] + e % dqk] = from_f<T>(acc_k[r]);
    }
}

// dq of query rows [q0, q0 + BT) of head (b, h).
template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(BwdArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
    const int tid = threadIdx.x, dqk = p.dqk, dv = p.dv, L = p.L;
    const int lq = dqk + 1, lv = dv + 1, ls = BT + 1;
    float* sk = smem;
    float* sv = sk + BT * lq;
    float* sq = sv + BT * lv;
    float* sg = sq + BT * lq;
    float* sd = sg + BT * lv + BT * ls;  // the dk/dv pass's ds slot
    const T* q = head_in<T>(p.q, p.s[0], b, h);
    const T* k = head_in<T>(p.k, p.s[1], b, h);
    const T* v = head_in<T>(p.v, p.s[2], b, h);
    const T* g = head_in<T>(p.g, p.s[3], b, h);
    const unsigned char* np = p.nonpad + (long long)b * L;

    const int nq = min(BT, L - q0);
    load_tile<T>(sq, q, p.s[0][2], q0, nq, dqk);
    load_tile<T>(sg, g, p.s[3][2], q0, nq, dv);
    float acc[BMAXR];
#pragma unroll
    for (int r = 0; r < BMAXR; ++r) acc[r] = 0.f;

    const int kend = min(L, q0 + BT);  // causal edge of this query tile
    for (int k0 = 0; k0 < kend; k0 += BT) {
        const int nk = min(BT, kend - k0);
        __syncthreads();
        load_tile<T>(sk, k, p.s[1][2], k0, nk, dqk);
        load_tile<T>(sv, v, p.s[2][2], k0, nk, dv);
        __syncthreads();
        for (int e = tid; e < BT * BT; e += NT) {
            const int i = e / BT, j = e % BT, row = q0 + i, col = k0 + j;
            float a = 0.f, ds = 0.f;
            if (i < nq && j < nk && col <= row && np[col])
                pair_grads<T>(sq + i * lq, sk + j * lq, sg + i * lv, sv + j * lv, dqk, dv,
                              p.inv_n, a, ds);
            sd[i * ls + j] = ds;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < BMAXR; ++r) {
            const int e = tid + r * NT;
            if (e < BT * dqk) {
                const int i = e / dqk, c = e % dqk;
                float s = acc[r];
                for (int j = 0; j < nk; ++j) s = fmaf(sd[i * ls + j], sk[j * lq + c], s);
                acc[r] = s;
            }
        }
    }
    T* gq = head_out<T>(p.gq, p.s[4], b, h);
#pragma unroll
    for (int r = 0; r < BMAXR; ++r) {
        const int e = tid + r * NT;
        if (e < BT * dqk && e / dqk < nq)
            gq[(long long)(q0 + e / dqk) * p.s[4][2] + e % dqk] = from_f<T>(acc[r]);
    }
}

// Both passes on one stream. Returns the first cudaError_t (0 = success).
template <typename T>
int launch_attn_bwd(const BwdArgs& p, int B, cudaStream_t stream) {
    const int smem = (int)sizeof(float) * bwd_smem_floats(p.dqk, p.dv);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.L + BT - 1) / BT, p.H, B);
    attn_bwd_dkdv_kernel<T><<<grid, NT, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dq_kernel<T><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// ---- the bfloat16 route: tensor-core kernels --------------------------------

// query rows of a streamed tile of the dk/dv pass
template <int DP>
__host__ __device__ constexpr int tb_dkv_tq() { return DP == 128 ? 32 : 64; }

// bytes of dynamic shared memory of each tensor-core kernel
template <int DP>
__host__ __device__ constexpr size_t tb_smem_window() {  // q, k, v, g, the warps' staging
    return sizeof(bf16) * (size_t)(4 * TB_M + TB_M) * (DP + tc::PAD);
}
template <int DP>
__host__ __device__ constexpr size_t tb_smem_dq() {  // q, g; two stages of k, v
    return sizeof(bf16) * (size_t)(2 * TB_M + 4 * TB_M) * (DP + tc::PAD);
}
template <int DP>
__host__ __device__ constexpr size_t tb_smem_dkv() {  // k, v; two stages of q, g
    return sizeof(bf16) * (size_t)(2 * TB_M + 4 * tb_dkv_tq<DP>()) * (DP + tc::PAD);
}

// A = mask ⊙ silu(x)/n and ds = mask ⊙ dA ⊙ silu′(x)/n of a warp's score
// tiles (x = s, dA = d), rounded to bf16 as the A fragments af, dsf of the
// next products (depth: the tiles' columns), over the 16-column blocks
// [blo, bhi). Entry (r, c) is row row0 + r and column col0 + c; with
// ROWS_ARE_QUERIES the rows are queries and the columns keys, else the
// other way round. Bit key − k0 of kw is the key's nonpad flag (kw as
// key_bits sets it for the keys k0 .. k0 + 63); A is the forward's
// masked_silu.
template <int NB, bool ROWS_ARE_QUERIES>
__device__ __forceinline__ void silu_grad_frags(const float (&s)[NB][4], const float (&d)[NB][4],
                                                int row0, int col0, const unsigned (&kw)[2],
                                                int k0, int L, float inv_n, int blo, int bhi,
                                                int lane, uint32_t (&af)[NB / 2][4],
                                                uint32_t (&dsf)[NB / 2][4]) {
    const int g = lane >> 2, t4 = lane & 3;
    const unsigned long long kb = key_word(kw);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
        if (n >= 2 * blo && n < 2 * bhi) {
            float a[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = row0 + g + (e & 2) * 4, col = col0 + n * 8 + 2 * t4 + (e & 1);
                const int query = ROWS_ARE_QUERIES ? row : col, key = ROWS_ARE_QUERIES ? col : row;
                const bool keep = key <= query && query < L && ((kb >> (key - k0)) & 1);
                const float x = s[n][e];
                float den;
                a[e] = masked_silu(x, keep, inv_n, den);
                const float sig = __fdividef(1.f, den);
                ds[e] = keep ? d[n][e] * (sig * (1.f + x * (1.f - sig))) * inv_n : 0.f;
            }
            af[n >> 1][(n & 1) * 2] = tc::pack_bf16(a[0], a[1]);
            af[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(a[2], a[3]);
            dsf[n >> 1][(n & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
            dsf[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
        }
    }
}

// The whole window (L <= TB_WINDOW) of head (blockIdx.y, batch row blockIdx.z).
template <int DP>
__global__ void __launch_bounds__(TB_NT) attn_bwd_tc_window_kernel(BwdArgs p) {
    constexpr int LD = DP + tc::PAD, NB = TB_M / 8, KB = TB_M / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [TB_M][LD]
    bf16* sk = sq + TB_M * LD;                     // [TB_M][LD]
    bf16* sv = sk + TB_M * LD;                     // [TB_M][LD]
    bf16* sg = sv + TB_M * LD;                     // [TB_M][LD]
    bf16* sst = sg + TB_M * LD;                    // [TB_WARPS][16][LD] staging
    __shared__ unsigned kw[2];
    const int h = blockIdx.y, b = blockIdx.z, L = p.L;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cq = p.dqk / 8, cv = p.dv / 8;
    tc::stage_rows<TB_M, DP, TB_NT>(sq, row_ptr(static_cast<const bf16*>(p.q), p.s[0], b, h, 0),
                                    p.s[0][2], L, tid, cq);
    tc::stage_rows<TB_M, DP, TB_NT>(sk, row_ptr(static_cast<const bf16*>(p.k), p.s[1], b, h, 0),
                                    p.s[1][2], L, tid, cq);
    tc::stage_rows<TB_M, DP, TB_NT>(sv, row_ptr(static_cast<const bf16*>(p.v), p.s[2], b, h, 0),
                                    p.s[2][2], L, tid, cv);
    tc::stage_rows<TB_M, DP, TB_NT>(sg, row_ptr(static_cast<const bf16*>(p.g), p.s[3], b, h, 0),
                                    p.s[3][2], L, tid, cv);
    tc::cp_async_commit();
    key_bits(kw, p.nonpad + (long long)b * L, L, warp, lane);
    tc::cp_async_wait<0>();
    __syncthreads();  // every tile is read-only from here on

    const int r0 = 16 * warp;  // the warp's rows: queries for dq, keys for dk and dv
    if (r0 >= L) return;
    const int nr = min(16, L - r0), nb = (L + 15) / 16;
    bf16* st = sst + r0 * LD;
    float s[NB][4], d[NB][4], acc[DP / 8][4];
    uint32_t af[KB][4], dsf[KB][4];

    // dq of query rows r0..: keys of the 16-blocks 0..warp
    score_tile<DP, NB>(s, sq + r0 * LD, sk, 0, warp + 1, lane);
    score_tile<DP, NB>(d, sg + r0 * LD, sv, 0, warp + 1, lane);
    silu_grad_frags<NB, true>(s, d, r0, 0, kw, 0, L, p.inv_n, 0, warp + 1, lane, af, dsf);
    zero_acc<DP>(acc);
    mma_frags<DP, KB>(acc, dsf, sk, 0, warp + 1, lane);
    store_rows<DP>(acc, st, row_ptr(static_cast<bf16*>(p.gq), p.s[4], b, h, r0), p.s[4][2], nr,
                   cq, lane);

    // dv and dk of key rows r0..: queries of the 16-blocks warp..nb-1
    score_tile<DP, NB>(s, sk + r0 * LD, sq, warp, nb, lane);
    score_tile<DP, NB>(d, sv + r0 * LD, sg, warp, nb, lane);
    silu_grad_frags<NB, false>(s, d, r0, 0, kw, 0, L, p.inv_n, warp, nb, lane, af, dsf);
    zero_acc<DP>(acc);
    mma_frags<DP, KB>(acc, af, sg, warp, nb, lane);
    store_rows<DP>(acc, st, row_ptr(static_cast<bf16*>(p.gv), p.s[6], b, h, r0), p.s[6][2], nr,
                   cv, lane);
    zero_acc<DP>(acc);
    mma_frags<DP, KB>(acc, dsf, sq, warp, nb, lane);
    store_rows<DP>(acc, st, row_ptr(static_cast<bf16*>(p.gk), p.s[5], b, h, r0), p.s[5][2], nr,
                   cq, lane);
}

// dq of query rows [q0, q0 + TB_M) of head (blockIdx.y, batch row
// blockIdx.z), q0 = blockIdx.x · TB_M. Key and value tiles of TB_M rows
// stream through a ring of two stages.
template <int DP>
__global__ void __launch_bounds__(TB_NT) attn_bwd_dq_tc_kernel(BwdArgs p) {
    constexpr int LD = DP + tc::PAD, NB = TB_M / 8, KB = TB_M / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [TB_M][LD]
    bf16* sg = sq + TB_M * LD;                     // [TB_M][LD]
    bf16* sk = sg + TB_M * LD;                     // [2][TB_M][LD]
    bf16* sv = sk + 2 * TB_M * LD;                 // [2][TB_M][LD]
    __shared__ unsigned kw[2][2];
    const int q0 = blockIdx.x * TB_M, h = blockIdx.y, b = blockIdx.z, L = p.L;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cq = p.dqk / 8, cv = p.dv / 8;
    const int qn = min(TB_M, L - q0), kend = q0 + qn;  // kend: the tile's causal edge
    const bf16* kh = row_ptr(static_cast<const bf16*>(p.k), p.s[1], b, h, 0);
    const bf16* vh = row_ptr(static_cast<const bf16*>(p.v), p.s[2], b, h, 0);
    const unsigned char* np = p.nonpad + (long long)b * L;
    tc::stage_rows<TB_M, DP, TB_NT>(sq, row_ptr(static_cast<const bf16*>(p.q), p.s[0], b, h, q0),
                                    p.s[0][2], qn, tid, cq);
    tc::stage_rows<TB_M, DP, TB_NT>(sg, row_ptr(static_cast<const bf16*>(p.g), p.s[3], b, h, q0),
                                    p.s[3][2], qn, tid, cv);
    tc::cp_async_commit();

    auto load_kv = [&](int tile, int buf) {
        const int k0 = tile * TB_M, nk = min(TB_M, kend - k0);
        tc::stage_rows<TB_M, DP, TB_NT>(sk + buf * TB_M * LD, kh + k0 * p.s[1][2], p.s[1][2], nk,
                                        tid, cq);
        tc::stage_rows<TB_M, DP, TB_NT>(sv + buf * TB_M * LD, vh + k0 * p.s[2][2], p.s[2][2], nk,
                                        tid, cv);
        key_bits(kw[buf], np + k0, nk, warp, lane);
    };
    const int ntiles = (kend + TB_M - 1) / TB_M;
    load_kv(0, 0);
    tc::cp_async_commit();

    const int r0 = q0 + 16 * warp;             // the warp's first query row
    const int last = min(r0 + 15, L - 1);      // its last (no rows when r0 >= L)
    float acc[DP / 8][4];
    zero_acc<DP>(acc);
    for (int tile = 0; tile < ntiles; ++tile) {
        const int buf = tile & 1;
        if (tile + 1 < ntiles) load_kv(tile + 1, buf ^ 1);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // this tile (and q, g) have landed
        __syncthreads();
        const int k0 = tile * TB_M;
        const int hi = r0 < L && last >= k0 ? min(KB, (last - k0) / 16 + 1) : 0;
        if (hi > 0) {
            const bf16* skb = sk + buf * TB_M * LD;
            float s[NB][4], d[NB][4];
            uint32_t af[KB][4], dsf[KB][4];
            score_tile<DP, NB>(s, sq + 16 * warp * LD, skb, 0, hi, lane);
            score_tile<DP, NB>(d, sg + 16 * warp * LD, sv + buf * TB_M * LD, 0, hi, lane);
            silu_grad_frags<NB, true>(s, d, r0, k0, kw[buf], k0, L, p.inv_n, 0, hi, lane, af,
                                      dsf);
            mma_frags<DP, KB>(acc, dsf, skb, 0, hi, lane);
        }
        __syncthreads();  // the readers of this stage are done before it is refilled
    }
    if (r0 < L)  // the warp's rows of sq, read by it alone, stage the stores
        store_rows<DP>(acc, sq + 16 * warp * LD,
                       row_ptr(static_cast<bf16*>(p.gq), p.s[4], b, h, r0), p.s[4][2],
                       min(16, L - r0), cq, lane);
}

// dk and dv of key rows [k0, k0 + TB_M) of head (blockIdx.y, batch row
// blockIdx.z), k0 = blockIdx.x · TB_M. Query and gradient tiles of TQ rows
// from the diagonal on stream through a ring of two stages.
template <int DP>
__global__ void __launch_bounds__(TB_NT) attn_bwd_dkv_tc_kernel(BwdArgs p) {
    constexpr int LD = DP + tc::PAD, TQ = tb_dkv_tq<DP>(), NB = TQ / 8, KB = TQ / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [TB_M][LD]
    bf16* sv = sk + TB_M * LD;                     // [TB_M][LD]
    bf16* sq = sv + TB_M * LD;                     // [2][TQ][LD]
    bf16* sg = sq + 2 * TQ * LD;                   // [2][TQ][LD]
    __shared__ unsigned kw[2];
    const int k0 = blockIdx.x * TB_M, h = blockIdx.y, b = blockIdx.z, L = p.L;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cq = p.dqk / 8, cv = p.dv / 8;
    const int nk = min(TB_M, L - k0);
    const bf16* qh = row_ptr(static_cast<const bf16*>(p.q), p.s[0], b, h, 0);
    const bf16* gh = row_ptr(static_cast<const bf16*>(p.g), p.s[3], b, h, 0);
    tc::stage_rows<TB_M, DP, TB_NT>(sk, row_ptr(static_cast<const bf16*>(p.k), p.s[1], b, h, k0),
                                    p.s[1][2], nk, tid, cq);
    tc::stage_rows<TB_M, DP, TB_NT>(sv, row_ptr(static_cast<const bf16*>(p.v), p.s[2], b, h, k0),
                                    p.s[2][2], nk, tid, cv);
    tc::cp_async_commit();
    key_bits(kw, p.nonpad + (long long)b * L + k0, nk, warp, lane);

    auto load_qg = [&](int tile, int buf) {
        const int q0 = k0 + tile * TQ, nq = min(TQ, L - q0);
        tc::stage_rows<TQ, DP, TB_NT>(sq + buf * TQ * LD, qh + q0 * p.s[0][2], p.s[0][2], nq, tid,
                                      cq);
        tc::stage_rows<TQ, DP, TB_NT>(sg + buf * TQ * LD, gh + q0 * p.s[3][2], p.s[3][2], nq, tid,
                                      cv);
    };
    const int ntiles = (L - k0 + TQ - 1) / TQ;
    load_qg(0, 0);
    tc::cp_async_commit();

    const int r0 = k0 + 16 * warp;  // the warp's first key row
    float ak[DP / 8][4], av[DP / 8][4];
    zero_acc<DP>(ak);
    zero_acc<DP>(av);
    for (int tile = 0; tile < ntiles; ++tile) {
        const int buf = tile & 1;
        if (tile + 1 < ntiles) load_qg(tile + 1, buf ^ 1);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // this tile (and k, v) have landed
        __syncthreads();
        const int q0 = k0 + tile * TQ;
        // query blocks holding a query at or past the warp's first key
        const int lo = max(0, (r0 - q0) / 16), hi = min(KB, (L - q0 + 15) / 16);
        if (r0 < L && lo < hi) {
            const bf16* sqb = sq + buf * TQ * LD;
            const bf16* sgb = sg + buf * TQ * LD;
            float s[NB][4], d[NB][4];
            uint32_t af[KB][4], dsf[KB][4];
            score_tile<DP, NB>(s, sk + 16 * warp * LD, sqb, lo, hi, lane);
            score_tile<DP, NB>(d, sv + 16 * warp * LD, sgb, lo, hi, lane);
            silu_grad_frags<NB, false>(s, d, r0, q0, kw, k0, L, p.inv_n, lo, hi, lane, af, dsf);
            mma_frags<DP, KB>(av, af, sgb, lo, hi, lane);
            mma_frags<DP, KB>(ak, dsf, sqb, lo, hi, lane);
        }
        __syncthreads();  // the readers of this stage are done before it is refilled
    }
    if (r0 < L) {  // the warp's rows of sk and sv, read by it alone, stage the stores
        const int nr = min(16, L - r0);
        store_rows<DP>(av, sv + 16 * warp * LD,
                       row_ptr(static_cast<bf16*>(p.gv), p.s[6], b, h, r0), p.s[6][2], nr, cv,
                       lane);
        store_rows<DP>(ak, sk + 16 * warp * LD,
                       row_ptr(static_cast<bf16*>(p.gk), p.s[5], b, h, r0), p.s[5][2], nr, cq,
                       lane);
    }
}

template <int DP>
int launch_attn_bwd_tc(const BwdArgs& p, int B, cudaStream_t stream) {
    int err;
    if (p.L <= TB_WINDOW) {
        if ((err = set_smem(attn_bwd_tc_window_kernel<DP>, tb_smem_window<DP>()))) return err;
        attn_bwd_tc_window_kernel<DP>
            <<<dim3(1, p.H, B), TB_NT, tb_smem_window<DP>(), stream>>>(p);
        return (int)cudaGetLastError();
    }
    // the two passes write different outputs and read only the inputs
    const dim3 grid((p.L + TB_M - 1) / TB_M, p.H, B);
    if ((err = set_smem(attn_bwd_dq_tc_kernel<DP>, tb_smem_dq<DP>()))) return err;
    if ((err = set_smem(attn_bwd_dkv_tc_kernel<DP>, tb_smem_dkv<DP>()))) return err;
    attn_bwd_dkv_tc_kernel<DP><<<grid, TB_NT, tb_smem_dkv<DP>(), stream>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    attn_bwd_dq_tc_kernel<DP><<<grid, TB_NT, tb_smem_dq<DP>(), stream>>>(p);
    return (int)cudaGetLastError();
}

// The tensor-core route on bf16 inputs: dqk and dv multiples of 8 up to 128;
// every tensor 16-byte aligned with strides above the last that are
// multiples of 8. Returns the first cudaError_t (0 = success).
inline int launch_attn_bwd_bf16_tc(const BwdArgs& p, int B, cudaStream_t stream) {
    const int d = p.dqk > p.dv ? p.dqk : p.dv;
    if (d <= 16) return launch_attn_bwd_tc<16>(p, B, stream);
    if (d <= 32) return launch_attn_bwd_tc<32>(p, B, stream);
    if (d <= 64) return launch_attn_bwd_tc<64>(p, B, stream);
    if (d <= 128) return launch_attn_bwd_tc<128>(p, B, stream);
    return (int)cudaErrorInvalidValue;
}


}  // namespace hstu

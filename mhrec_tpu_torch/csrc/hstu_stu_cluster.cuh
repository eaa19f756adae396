// Device code of the fused STU block's float32 cluster kernels
// (hstu_stu_f32.cu): windows of at most 64 rows, one thread-block cluster
// per batch row, one block per group of heads.
//
// The LayerNorm of the STU block runs over all H·dv columns of a row, so a
// block that owns a few heads cannot finish a row alone. A cluster of
// C = ceil(H / hb) blocks (hb = ceil(H / 8) heads each, C ≤ 8: portable)
// covers one batch row: each block stages its heads' windows of q, k and v
// in shared memory (16-byte cp.async straight through the uvqk split's
// strides; the forward holds all its heads and reads each byte once, the
// backward holds one head at a time and reads every head but the last
// again, from L2, for its attention backward), computes its heads'
// attention rows there, and the
// LayerNorm's per-row sums cross the cluster through distributed shared
// memory: each block writes its partial sums into its own shared memory,
// the cluster barrier follows, and every block adds all ranks' partials in
// rank order (so every block gets the same bits, and a repeat too; no
// atomics). The two-pass numerics of the JAX kernels are kept: the mean in
// one exchange, Σ(x − μ)² in a second; the backward adds a third for
// mean(dx̂) and mean(dx̂·x̂). The row passes give each row 4 threads (a warp
// a row left the SM waiting on one shuffle chain at a time).
//
// Products are full-float32 CUDA-core FMAs (the tensor cores would take
// float32 as TF32) from register tiles over shared memory. What bounds them
// on this card is the operand traffic out of shared memory: a wavefront
// delivers 128 bytes (32 floats) to the threads, against 128 FMA lanes a
// clock an SM, so a thread's a × b tile, which loads a + b floats a step of
// depth for a·b FMAs, sets the pace. Only the blocks on or below the causal
// diagonal are computed.
// * The forward works on two heads at once, a pair of 64-thread groups a
//   head; each group owns a balanced half of the 8-row blocks with 4 × 8
//   tiles (thread (ti, tj) of an 8 × 8 grid: rows ti + 8·rb, columns
//   tj + 8·r'), reading S's operands as float4 along the depth and A one
//   float4 of keys a row, v as float4 across its columns.
// * The backward, one head at a time, runs each product on all 256 threads
//   with 4 × 4 tiles (thread (ti, tj) of a 16 × 16 grid: rows ti + 16·r,
//   columns tj + 16·r'), S and dA on the same tiles so that ds is formed in
//   registers; the transposes (Aᵀ, dsᵀ) are read across the score tiles in
//   place. Putting those products on pairs of groups as well spilled
//   registers at the 128 a thread that two blocks an SM allow.
// Tile pitches keep the rows a quarter-warp reads in one float4 load in
// distinct bank groups.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tc_bf16.cuh"

namespace hstu {
namespace stu32 {

namespace cg = cooperative_groups;

constexpr int NT = 256;              // threads a block
constexpr int GT = 64;               // threads a product group
constexpr int NP = NT / (2 * GT);    // pairs of product groups a block
constexpr int MAX_L = 64;            // the longest window the cluster kernels take
constexpr int MAX_D = 128;           // the widest head
constexpr int MAX_CLUSTER = 8;       // portable cluster size
constexpr int PLD = MAX_L + 4;       // row pitch of a score tile
constexpr int P_FLOATS = MAX_L * PLD;
constexpr int STAT_FLOATS = 8 * MAX_L;  // four exchanged partial sums, four row statistics
constexpr int SMEM_MAX = 232448;     // bytes of shared memory a block may use on sm_90

__host__ __device__ inline int heads_per_block(int H) {
    return (H + MAX_CLUSTER - 1) / MAX_CLUSTER;
}
__host__ __device__ inline int cluster_size(int H) {
    const int hb = heads_per_block(H);
    return (H + hb - 1) / hb;
}
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
// row pitch of a q/k/v tile: a multiple of 4 floats whose quarter is odd, so
// that 8 rows read at one column as float4 hit 8 distinct bank groups
__host__ __device__ inline int tile_ld(int dqk, int dv) {
    const int dp = round4(dqk > dv ? dqk : dv);
    return dp + (dp % 8 == 0 ? 4 : 8);
}
// forward: the score tile of a head goes into its q tile, which its output
// rows then replace, when that is wide enough and the output is one 64-column
// slab; else into a score tile of its own (one for each pair of groups)
__host__ __device__ inline bool fwd_own_scores(int L, int dqk, int dv) {
    return tile_ld(dqk, dv) < round8(L) || dv > 64;
}
__host__ __device__ inline size_t fwd_smem_bytes(int L, int H, int dqk, int dv) {
    const int hb = heads_per_block(H);
    const size_t own = fwd_own_scores(L, dqk, dv) ? (size_t)(hb < NP ? hb : NP) * P_FLOATS : 0;
    return sizeof(float) *
           ((size_t)STAT_FLOATS + own + (size_t)hb * 3 * round8(L) * tile_ld(dqk, dv));
}
__host__ __device__ inline size_t bwd_smem_bytes(int L, int H, int dqk, int dv) {
    const size_t L8 = round8(L);
    return sizeof(float) * ((size_t)STAT_FLOATS + 2 * P_FLOATS + 3 * L8 * tile_ld(dqk, dv) +
                            L8 * ((size_t)heads_per_block(H) * dv + 4));
}
// the shapes the cluster kernels take (the wrapper's stu_gated_f32_form)
__host__ __device__ inline bool fits(int L, int H, int dqk, int dv, bool bwd) {
    if (L < 1 || L > MAX_L || H < 1 || dqk < 4 || dv < 4 || dqk > MAX_D || dv > MAX_D ||
        dqk % 4 || dv % 4)
        return false;
    return (bwd ? bwd_smem_bytes(L, H, dqk, dv) : fwd_smem_bytes(L, H, dqk, dv)) <= SMEM_MAX;
}

// Pointers and strides of one call (strides in floats; the last dimension
// of every tensor is contiguous).
struct Args {
    const float* q;
    const float* k;
    const float* v;
    const float* u;
    const float* gamma;
    const float* beta;
    const unsigned char* nonpad;  // [B, L]
    int L, H, dqk, dv;
    long long sqb, sql, skb, skl, svb, svl, sub, sul;
    float inv_n, eps;
};

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
    cluster_arrive();
    cluster_wait();
}

// Σ over the cluster's C ranks, in rank order, of entry i of the partial
// sums at `part` in each rank's shared memory
__device__ __forceinline__ float cluster_total(float* part, int i, int C) {
    cg::cluster_group cluster = cg::this_cluster();
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(part, r)[i];
    return s;
}

// the sum over the 4 threads of a row (lanes 4·i .. 4·i + 3), on each
__device__ __forceinline__ float row_total(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [0, L) of one head (w floats wide, w % 4 == 0, row stride ld floats)
// into a tile of pitch LD by 16-byte cp.async; rows [L, Lz) are zero-filled.
// Threads t = 0 .. nt − 1 take part; the caller commits the group.
__device__ __forceinline__ void stage(float* tile, int LD, const float* src, long long ld, int L,
                                      int Lz, int w, int t, int nt) {
    const int w4 = w / 4;
    for (int e = t; e < Lz * w4; e += nt) {
        const int i = e / w4, c = (e - i * w4) * 4;
        const bool in = i < L;
        tc::cp_async16(tile + i * LD + c, in ? src + i * ld + c : src, in);
    }
}

// Rows [0, L) of a block's columns (w floats from src, row stride ld) asked
// into L2 ahead of their first read, one 128-byte line a thread at a time
__device__ __forceinline__ void prefetch_rows(const float* src, long long ld, int L, int w) {
    const int lines = (w + 31) / 32;  // 32 floats a line
    for (int e = threadIdx.x; e < L * lines; e += NT) {
        const int i = e / lines;
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + i * ld + 32 * (e - i * lines)));
    }
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ void axpy4(float a, float4 y, float4& acc) {
    acc.x = fmaf(a, y.x, acc.x);
    acc.y = fmaf(a, y.y, acc.y);
    acc.z = fmaf(a, y.z, acc.z);
    acc.w = fmaf(a, y.w, acc.w);
}

// A forward product over the rows of a 64-row tile runs on a pair of
// groups of 64 threads, each owning a set of at most 4 of its 8-row blocks,
// coded as nibbles (0xF: none) in a template constant. Thread gt of a group
// is (ti, tj) = (gt / 8, gt % 8) and owns rows ti + 8·rb of each block rb of
// its set. The two halves balance the causal work, rb + 1 column blocks for
// block rb: {0, 3, 4, 7} and {1, 2, 5, 6} split 8 blocks (and 6, 4) evenly;
// a window of 7 blocks (49–56 rows: every model config) takes {0, 5, 6} and
// {1, 2, 3, 4}.
template <bool N7>
struct Halves {
    static constexpr unsigned lower[2] = {N7 ? 0xF650u : 0x7430u, N7 ? 0x4321u : 0x6521u};
};
__host__ __device__ constexpr int block_of(unsigned rows, int q) { return (rows >> (4 * q)) & 15; }

// acc[q][r'] = Σ_{c < w} X[ti + 8·rb_q][c] · Y[tj + 8·r'][c] over the blocks
// r' ≤ rb_q < n8 (rb_q = block_of(ROWS, q)). X and Y hold at least 8·n8
// rows (rows past the window finite).
template <unsigned ROWS>
__device__ __forceinline__ void score_rows(const float* X, int ldx, const float* Y, int ldy, int w,
                                           int n8, int gt, float (&acc)[4][8]) {
    const float* xr = X + (gt >> 3) * ldx;
    const float* yr = Y + (gt & 7) * ldy;
    int top = -1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (block_of(ROWS, q) < n8) top = max(top, block_of(ROWS, q));
#pragma unroll
        for (int r2 = 0; r2 < 8; ++r2) acc[q][r2] = 0.f;
    }
    for (int c = 0; c < w; c += 4) {
        float4 xa[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int rb = block_of(ROWS, q);
            xa[q] = rb < n8 ? ld4(xr + 8 * rb * ldx + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r2 = 0; r2 < 8; ++r2) {
            if (r2 > top) break;
            const float4 ya = ld4(yr + 8 * r2 * ldy + c);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int rb = block_of(ROWS, q);
                if (r2 <= rb && rb < n8) acc[q][r2] = dot4(xa[q], ya, acc[q][r2]);
            }
        }
    }
}

// The computed entries of a set's score rows to dst (pitch ld): entry (i, j)
// of column block r' gets f(acc, i, j, r').
template <unsigned ROWS, typename Fn>
__device__ __forceinline__ void put_rows(const float (&acc)[4][8], float* dst, int ld, int n8,
                                         int gt, Fn f) {
    const int ti = gt >> 3, tj = gt & 7;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int rb = block_of(ROWS, q);
        if (rb >= n8) continue;
#pragma unroll
        for (int r2 = 0; r2 < 8; ++r2)
            if (r2 <= rb) {
                const int i = ti + 8 * rb, j = tj + 8 * r2;
                dst[i * ld + j] = f(acc[q][r2], i, j, r2);
            }
    }
}

// acc[q][s] = Σ_k X[ti + 8·rb_q][k] · Y[k][64·slab + 4·(tj + 8·s) .. + 3]
// over keys k < round4(L), blocks rb_q < n8 of the set; X is zero past
// k = i (the causal mask), so the keys of 8-key block kb reach the row
// blocks ≥ kb. X is zero (or finite) wherever it is read; so are Y's rows
// past L. Columns at or past w are left zero.
template <unsigned ROWS>
__device__ __forceinline__ void mix_rows(const float* X, int ldx, const float* Y, int ldy, int w,
                                         int L, int n8, int gt, int slab, float4 (&acc)[4][2]) {
    const int ti = gt >> 3, tj = gt & 7;
    const int c0 = 64 * slab + 4 * tj, c1 = c0 + 32;
    const bool in0 = c0 < w, in1 = c1 < w;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    int hi = -1;  // the set's highest block
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (block_of(ROWS, q) < n8) hi = max(hi, block_of(ROWS, q));
        acc[q][0] = acc[q][1] = z;
    }
    // the keys that reach any of the set's rows
    const int kend = min(round4(L), 8 * hi + 8);
    for (int k0 = 0; k0 < kend; k0 += 4) {
        const int kb = k0 >> 3;
        float x[4][4];  // X[row of block q][k0 + j], zero where block q takes no key here
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int rb = block_of(ROWS, q);
            const float4 xv = rb < n8 && rb >= kb ? ld4(X + (ti + 8 * rb) * ldx + k0) : z;
            x[q][0] = xv.x; x[q][1] = xv.y; x[q][2] = xv.z; x[q][3] = xv.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float4 y0 = in0 ? ld4(Y + (k0 + j) * ldy + c0) : z;
            const float4 y1 = in1 ? ld4(Y + (k0 + j) * ldy + c1) : z;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int rb = block_of(ROWS, q);
                if (rb >= n8 || rb < kb) continue;
                axpy4(x[q][j], y0, acc[q][0]);
                axpy4(x[q][j], y1, acc[q][1]);
            }
        }
    }
}

// rows ti + 8·rb_q < n and float4 columns c = 64·slab + 4·(tj + 8·s) < w of
// a set's mixing product to dst[i·ld + c]
template <unsigned ROWS>
__device__ __forceinline__ void store_rows(const float4 (&acc)[4][2], float* dst, long long ld,
                                           int n, int w, int gt, int slab) {
    const int ti = gt >> 3, tj = gt & 7;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int rb = block_of(ROWS, q);
        const int i = ti + 8 * rb;
        if (rb > 7 || i >= n) continue;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int c = 64 * slab + 4 * (tj + 8 * s);
            if (c < w) st4(dst + i * ld + c, acc[q][s]);
        }
    }
}

// fn(Rows<R0>{}) on the first half's groups, fn(Rows<R1>{}) on the second's:
// a helper called through it sees its row set as a template constant
template <unsigned R>
struct Rows {
    static constexpr unsigned value = R;
};
template <unsigned R0, unsigned R1, typename Fn>
__device__ __forceinline__ void by_half(int half, Fn&& fn) {
    if (half) fn(Rows<R1>{});
    else fn(Rows<R0>{});
}

// The backward's products, one at a time on all 256 threads: thread
// (ti, tj) = (tid / 16, tid % 16) owns rows ti + 16·r and columns tj + 16·r'
// (r, r' < 4) of a 64 × 64 score tile, only the 16-row blocks r' ≤ r < nb
// (nb = ceil(L / 16)); the mixing products give it rows ti + 16·r and the
// float4 columns tc + 16·s (tc = tid % 16).

// acc[r][r'] = Σ_{c < w} X[ti + 16·r][c] · Y[tj + 16·r'][c]; rows past
// rmax read row rmax (finite: the caller masks those entries)
__device__ __forceinline__ void score16(const float* X, int ldx, const float* Y, int ldy, int w,
                                        int nb, int rmax, float (&acc)[4][4]) {
    const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
    const float* xr[4];
    const float* yr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        xr[r] = X + min(ti + 16 * r, rmax) * ldx;
        yr[r] = Y + min(tj + 16 * r, rmax) * ldy;
#pragma unroll
        for (int r2 = 0; r2 < 4; ++r2) acc[r][r2] = 0.f;
    }
    for (int c = 0; c < w; c += 4) {
        float4 xa[4], ya[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            xa[r] = r < nb ? ld4(xr[r] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
            ya[r] = r < nb ? ld4(yr[r] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int r2 = 0; r2 <= r; ++r2)
                if (r < nb) acc[r][r2] = dot4(xa[r], ya[r2], acc[r][r2]);
    }
}

// acc[r][s] = Σ_k X(ti + 16·r, k) · Y[k][4·(tc + 16·s) .. + 3] over keys
// k < round4(L) in the 16-key blocks kb ≤ r (LOWER) or kb ≥ r, rows r < nb;
// X a score tile (pitch PLD) read as X(i, k) = X[i·PLD + k] or, TRANS,
// X[k·PLD + i]; Y rows of pitch ldy, w columns (float4 columns at or past w
// left zero). X and Y are zero (or finite) wherever read.
template <bool LOWER, bool TRANS, int NCOL>
__device__ __forceinline__ void mix16(const float* X, const float* Y, int ldy, int w, int L, int nb,
                                      float4 (&acc)[4][NCOL]) {
    const int ti = threadIdx.x >> 4, tc = threadIdx.x & 15;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < NCOL; ++s) acc[r][s] = z;
    const int kend = round4(L);
    for (int kb = 0; kb < nb; ++kb) {
        for (int k0 = 16 * kb; k0 < min(16 * kb + 16, kend); k0 += 4) {
            float4 y[4][NCOL];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int s = 0; s < NCOL; ++s) {
                    const int col = 4 * (tc + 16 * s);
                    y[j][s] = col < w ? ld4(Y + (k0 + j) * ldy + col) : z;
                }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                if (r >= nb || (LOWER ? kb > r : kb < r)) continue;
                const int i = ti + 16 * r;
                float4 x;
                if (TRANS)
                    x = make_float4(X[k0 * PLD + i], X[(k0 + 1) * PLD + i], X[(k0 + 2) * PLD + i],
                                    X[(k0 + 3) * PLD + i]);
                else
                    x = ld4(X + i * PLD + k0);
#pragma unroll
                for (int s = 0; s < NCOL; ++s) {
                    axpy4(x.x, y[0][s], acc[r][s]);
                    axpy4(x.y, y[1][s], acc[r][s]);
                    axpy4(x.z, y[2][s], acc[r][s]);
                    axpy4(x.w, y[3][s], acc[r][s]);
                }
            }
        }
    }
}

// rows ti + 16·r < n and float4 columns 4·(tc + 16·s) < w of a mixing
// product to dst (row pitch ld floats)
template <int NCOL>
__device__ __forceinline__ void store16(const float4 (&acc)[4][NCOL], float* dst, long long ld,
                                        int n, int w) {
    const int ti = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i >= n) continue;
#pragma unroll
        for (int s = 0; s < NCOL; ++s) {
            const int c = 4 * (tc + 16 * s);
            if (c < w) st4(dst + i * ld + c, acc[r][s]);
        }
    }
}

// bit r' of the result: key tj + 8·r' is in the window and not padding
__device__ __forceinline__ unsigned key_bits(const unsigned char* np, int L, int gt) {
    unsigned bits = 0;
#pragma unroll
    for (int r2 = 0; r2 < 8; ++r2) {
        const int j = (gt & 7) + 8 * r2;
        if (j < L && np[j]) bits |= 1u << r2;
    }
    return bits;
}

// A = mask ⊙ silu(s)/n of one score entry and silu′(s)/n (mask: the key j
// at or before the query i < L and not padding)
__device__ __forceinline__ float masked_silu(float s, bool keep, float inv_n, float& dsilu) {
    if (!keep) {
        dsilu = 0.f;
        return 0.f;
    }
    const float sig = 1.f / (1.f + expf(-s));
    dsilu = sig * (1.f + s * (1.f - sig)) * inv_n;
    return s * sig * inv_n;
}

// Launch one cluster per batch row: grid (C, B), cluster (C, 1, 1), NT
// threads, `smem` bytes of dynamic shared memory (the kernel's limit set on
// every launch: another shape may have set it lower). The cluster's
// co-residency is checked once per (kernel, smem, C): returns −1 when
// cudaOccupancyMaxActiveClusters finds that no such cluster fits on the
// card, else the cudaError_t of the launch.
template <typename... Params, typename... Actual>
int launch_clusters(void (*kernel)(Params...), int C, int B, size_t smem, cudaStream_t stream,
                    Actual&&... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, B, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;

    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    struct Checked {
        const void* fn;
        size_t smem;
        int C;
    };
    static Checked checked[64];
    static int n_checked = 0;
    bool known = false;
    for (int i = 0; i < n_checked && !known; ++i)
        known = checked[i].fn == (const void*)kernel && checked[i].smem == smem && checked[i].C == C;
    if (!known) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (clusters == 0) return -1;
        if (n_checked < 64) checked[n_checked++] = {(const void*)kernel, smem, C};
    }
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Actual&&>(args)...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace stu32
}  // namespace hstu

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
// about 2·B·H·L²·d causal flops, far below the card's flop-to-byte balance.
// Every route reads q, k, v through their strides, so a [B, L, H, d] tensor
// viewed as [B, H, L, d] needs no copy, and keeps the scores out of device
// memory. Two routes, chosen by the caller:
// * bfloat16 with head widths that are multiples of 8 up to 128 (dtype code
//   2): the tensor cores. Tiles of 64 rows, bf16, widths zero-filled up to DP
//   (the smallest of 16, 32, 64, 128 that holds dqk and dv), are copied to
//   shared memory with 16-byte cp.async. Each of the block's 4 warps owns 16
//   query rows: it computes S = Q·Kᵀ (mma.sync m16n8k16, f32 accumulators)
//   over the 16-key blocks up to its causal edge only, applies the mask (the
//   tile's key flags as 64 bits), silu and 1/n in f32 registers (fast
//   exponential and division), rounds A to bf16 straight into the A
//   fragments of O += A·V, and writes O through its own rows of the q tile
//   as 16-byte stores (hstu_attn_tc.cuh). Windows of at most 64 rows (every
//   HSTU config: window 50) take one block a (batch row, head), which stages
//   the whole window once and needs no barrier after that; longer windows
//   take one block a (64-row query tile, head, batch row), streaming the
//   key/value tiles up to the tile's causal edge through a ring of two
//   stages, with O in registers across tiles (no softmax, so nothing is
//   rescaled). The last, heaviest query tiles are launched first.
// * float32, and bfloat16 at other widths (dtype codes 0 and 1): plain
//   CUDA-core FMAs over shared-memory tiles (head_attention in
//   hstu_attn_common.cuh, shared bit for bit with the fused STU block's
//   float32 route), one block per (16-row query tile, head, batch row); float32
//   stays in full float32 (the tensor cores would take it as TF32).
// No atomics and no state between blocks: a repeat gives the same bits.
#include "hstu_attn_common.cuh"
#include "hstu_attn_tc.cuh"

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

// ---- the bfloat16 route: tensor-core kernels --------------------------------

// Pointers and strides of one forward call on the tensor cores. Strides are
// in elements, per tensor (batch, head, row); the last dimension is
// contiguous.
struct FwdArgs {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const unsigned char* nonpad;  // [B, L]
    bf16* out;
    int H, L, dqk, dv;
    long long s[4][3];  // q, k, v, out
    float inv_n;
};

// bytes of dynamic shared memory: q, k, v of the window; q and two stages
// of k, v for a query tile
template <int DP>
__host__ __device__ constexpr size_t fwd_smem_window() {
    return sizeof(bf16) * (size_t)3 * TB_M * (DP + tc::PAD);
}
template <int DP>
__host__ __device__ constexpr size_t fwd_smem_tiled() {
    return sizeof(bf16) * (size_t)5 * TB_M * (DP + tc::PAD);
}

// The whole window (L <= TB_WINDOW) of head (blockIdx.y, batch row blockIdx.z).
template <int DP>
__global__ void __launch_bounds__(TB_NT) attn_fwd_tc_window_kernel(FwdArgs p) {
    constexpr int LD = DP + tc::PAD, NB = TB_M / 8, KB = TB_M / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [TB_M][LD]
    bf16* sk = sq + TB_M * LD;                     // [TB_M][LD]
    bf16* sv = sk + TB_M * LD;                     // [TB_M][LD]
    __shared__ unsigned kw[2];
    const int h = blockIdx.y, b = blockIdx.z, L = p.L;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cq = p.dqk / 8, cv = p.dv / 8;
    tc::stage_rows<TB_M, DP, TB_NT>(sq, row_ptr(p.q, p.s[0], b, h, 0), p.s[0][2], L, tid, cq);
    tc::stage_rows<TB_M, DP, TB_NT>(sk, row_ptr(p.k, p.s[1], b, h, 0), p.s[1][2], L, tid, cq);
    tc::stage_rows<TB_M, DP, TB_NT>(sv, row_ptr(p.v, p.s[2], b, h, 0), p.s[2][2], L, tid, cv);
    tc::cp_async_commit();
    key_bits(kw, p.nonpad + (long long)b * L, L, warp, lane);
    tc::cp_async_wait<0>();
    __syncthreads();  // every tile is read-only from here on

    const int r0 = 16 * warp;  // the warp's query rows
    if (r0 >= L) return;
    float s[NB][4], acc[DP / 8][4];
    uint32_t af[KB][4];
    // keys of the 16-blocks 0..warp: up to the warp's causal edge
    score_tile<DP, NB>(s, sq + r0 * LD, sk, 0, warp + 1, lane);
    silu_frags<NB>(s, r0, 0, kw, p.inv_n, 0, warp + 1, lane, af);
    zero_acc<DP>(acc);
    mma_frags<DP, KB>(acc, af, sv, 0, warp + 1, lane);
    __syncwarp();  // the warp's rows of sq, read by it alone, stage the stores
    store_rows<DP>(acc, sq + r0 * LD, row_ptr(p.out, p.s[3], b, h, r0), p.s[3][2],
                   min(16, L - r0), cv, lane);
}

// Query rows [q0, q0 + TB_M) of head (blockIdx.y, batch row blockIdx.z),
// q0 = (gridDim.x − 1 − blockIdx.x) · TB_M: the last query tiles, which walk
// the most key tiles, are scheduled first. Key and value tiles of TB_M rows
// up to the tile's causal edge stream through a ring of two stages. Four
// blocks an SM up to DP = 64 (at most 128 registers a thread: the kernel is
// latency-bound, and 135 registers let only three in), two at DP = 128,
// where fewer registers would spill.
template <int DP>
__global__ void __launch_bounds__(TB_NT, DP <= 64 ? 4 : 2) attn_fwd_tc_kernel(FwdArgs p) {
    constexpr int LD = DP + tc::PAD, NB = TB_M / 8, KB = TB_M / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [TB_M][LD]
    bf16* sk = sq + TB_M * LD;                     // [2][TB_M][LD]
    bf16* sv = sk + 2 * TB_M * LD;                 // [2][TB_M][LD]
    __shared__ unsigned kw[2][2];
    const int q0 = (gridDim.x - 1 - blockIdx.x) * TB_M, h = blockIdx.y, b = blockIdx.z;
    const int L = p.L, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cq = p.dqk / 8, cv = p.dv / 8;
    const int qn = min(TB_M, L - q0), kend = q0 + qn;  // kend: the tile's causal edge
    const bf16* kh = row_ptr(p.k, p.s[1], b, h, 0);
    const bf16* vh = row_ptr(p.v, p.s[2], b, h, 0);
    const unsigned char* np = p.nonpad + (long long)b * L;
    tc::stage_rows<TB_M, DP, TB_NT>(sq, row_ptr(p.q, p.s[0], b, h, q0), p.s[0][2], qn, tid, cq);
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

    const int r0 = q0 + 16 * warp;         // the warp's first query row
    const int last = min(r0 + 15, L - 1);  // its last (no rows when r0 >= L)
    float acc[DP / 8][4];
    zero_acc<DP>(acc);
    for (int tile = 0; tile < ntiles; ++tile) {
        const int buf = tile & 1;
        if (tile + 1 < ntiles) load_kv(tile + 1, buf ^ 1);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // this tile (and q) have landed
        __syncthreads();
        const int k0 = tile * TB_M;
        const int hi = r0 < L && last >= k0 ? min(KB, (last - k0) / 16 + 1) : 0;
        if (hi > 0) {
            float s[NB][4];
            uint32_t af[KB][4];
            score_tile<DP, NB>(s, sq + 16 * warp * LD, sk + buf * TB_M * LD, 0, hi, lane);
            silu_frags<NB>(s, r0, k0, kw[buf], p.inv_n, 0, hi, lane, af);
            mma_frags<DP, KB>(acc, af, sv + buf * TB_M * LD, 0, hi, lane);
        }
        __syncthreads();  // the readers of this stage are done before it is refilled
    }
    if (r0 < L)  // the warp's rows of sq, read by it alone, stage the stores
        store_rows<DP>(acc, sq + 16 * warp * LD, row_ptr(p.out, p.s[3], b, h, r0), p.s[3][2],
                       min(16, L - r0), cv, lane);
}

template <int DP>
int launch_attn_fwd_tc(const FwdArgs& p, int B, cudaStream_t stream) {
    int err;
    if (p.L <= TB_WINDOW) {
        if ((err = set_smem(attn_fwd_tc_window_kernel<DP>, fwd_smem_window<DP>()))) return err;
        attn_fwd_tc_window_kernel<DP>
            <<<dim3(1, p.H, B), TB_NT, fwd_smem_window<DP>(), stream>>>(p);
        return (int)cudaGetLastError();
    }
    if ((err = set_smem(attn_fwd_tc_kernel<DP>, fwd_smem_tiled<DP>()))) return err;
    attn_fwd_tc_kernel<DP><<<dim3((p.L + TB_M - 1) / TB_M, p.H, B), TB_NT, fwd_smem_tiled<DP>(),
                             stream>>>(p);
    return (int)cudaGetLastError();
}

// The tensor-core route on bf16 inputs: dqk and dv multiples of 8 up to 128;
// every tensor 16-byte aligned with strides above the last that are
// multiples of 8. Returns the cudaError_t of the launch (0 = success).
inline int launch_attn_fwd_bf16_tc(const FwdArgs& p, int B, cudaStream_t stream) {
    const int d = p.dqk > p.dv ? p.dqk : p.dv;
    if (d <= 16) return launch_attn_fwd_tc<16>(p, B, stream);
    if (d <= 32) return launch_attn_fwd_tc<32>(p, B, stream);
    if (d <= 64) return launch_attn_fwd_tc<64>(p, B, stream);
    if (d <= 128) return launch_attn_fwd_tc<128>(p, B, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace hstu

// C interface, loaded with ctypes. Strides are in elements (the last
// dimension is contiguous); out is a contiguous [B, H, L, dv] tensor.
// nonpad is [B, L]. dtype: 0 = float32, 1 = bfloat16 on the CUDA cores,
// 2 = bfloat16 on the tensor cores (needs dqk and dv multiples of 8 up to
// 128, q, k, v 16-byte aligned with strides that are multiples of 8).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int hstu_attn_fwd(
    const void* q, const void* k, const void* v, const unsigned char* nonpad, void* out,
    int B, int H, int L, int dqk, int dv,
    long long sqb, long long sqh, long long sql,
    long long skb, long long skh, long long skl,
    long long svb, long long svh, long long svl,
    float inv_n, int dtype, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 2) {
        using hstu::bf16;
        const long long lo = (long long)L * dv;
        const hstu::FwdArgs p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), nonpad, static_cast<bf16*>(out),
                              H, L, dqk, dv,
                              {{sqb, sqh, sql}, {skb, skh, skl}, {svb, svh, svl}, {H * lo, lo, dv}},
                              inv_n};
        return hstu::launch_attn_fwd_bf16_tc(p, B, s);
    }
    if (dtype == 1)
        return hstu::launch<__nv_bfloat16>(q, k, v, nonpad, out, B, H, L, dqk, dv, sqb, sqh,
                                           sql, skb, skh, skl, svb, svh, svl, inv_n, s);
    if (dtype == 0)
        return hstu::launch<float>(q, k, v, nonpad, out, B, H, L, dqk, dv, sqb, sqh, sql,
                                   skb, skh, skl, svb, svh, svl, inv_n, s);
    return (int)cudaErrorInvalidValue;
}

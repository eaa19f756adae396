// row_adamw — row-sparse AdamW on Hopper (sm_90a): for every id ≥ 0 of a
// block of unique row ids, read that row of the f32 parameter table p and of
// its moments m and v, and its gradient row, apply one AdamW step and write
// p, m and v back in place. Pad slots (id −1) are skipped.
//
// Replaces the TPU kernel _row_adam_call / _row_adam_kernel
// (mhrec_tpu/ops/pallas/row_adam_tpu.py, via sparse_adamw_row_update_pallas).
// The TPU kernel's id superblocks, per-row DMA descriptors, phantom-
// descriptor waits and (D/128, 128) row views exist for the TPU's scalar
// core and tiling; here each block walks rows and each thread a strided
// slice of a row, so any D works.
//
// Arithmetic: the JAX kernel's operation order, every operation rounded on
// its own (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, so nvcc contracts
// nothing into an FMA): bias corrections c1 = 1 − b1^t and c2 = 1 − b2^t as
// divisors, and the moments stored as old + (new − old), as the scatter-add
// formulation stores them. The plain PyTorch version (trainer/sparse_adam.py)
// performs the same operations, each as its own elementwise kernel, so the
// two agree bit for bit.
//
// Bound on the H100: memory. Each touched row is read four times (p, m, v,
// g) and written three times, 7·4·D bytes, at one multiply-add or so per
// byte. Row ids must be unique (the batcher's contract): two slots of one id
// would race.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
row_adamw_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                 const long long* __restrict__ ids, const float* __restrict__ g,
                 int U, int D, float neg_lr, float c1, float c2, float eps, float wd,
                 float b1, float b2, float omb1, float omb2) {
    for (int u = blockIdx.x; u < U; u += gridDim.x) {
        const long long id = ids[u];
        if (id < 0) continue;
        float* pr = p + id * D;
        float* mr = m + id * D;
        float* vr = v + id * D;
        const float* gr = g + (long long)u * D;
        for (int c = threadIdx.x; c < D; c += NT) {
            const float gc = gr[c], p_old = pr[c], m_old = mr[c], v_old = vr[c];
            const float m_new = __fadd_rn(__fmul_rn(m_old, b1), __fmul_rn(gc, omb1));
            const float v_new = __fadd_rn(__fmul_rn(v_old, b2), __fmul_rn(__fmul_rn(gc, gc), omb2));
            const float mhat = __fdiv_rn(m_new, c1);
            const float vhat = __fdiv_rn(v_new, c2);
            const float dir = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)),
                                        __fmul_rn(p_old, wd));
            pr[c] = __fadd_rn(p_old, __fmul_rn(dir, neg_lr));
            mr[c] = __fadd_rn(m_old, __fsub_rn(m_new, m_old));
            vr[c] = __fadd_rn(v_old, __fsub_rn(v_new, v_old));
        }
    }
}

}  // namespace

// C interface, loaded with ctypes. p, m, v: contiguous f32 [N, D], updated
// in place; ids: int64 [U] (−1 = pad slot); g: contiguous f32 [U, D].
// neg_lr = −lr; omb1 = 1 − b1 and omb2 = 1 − b2 in f32. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int row_adamw(float* p, float* m, float* v, const long long* ids, const float* g,
                         int U, int D, float neg_lr, float c1, float c2, float eps, float wd,
                         float b1, float b2, float omb1, float omb2, void* stream) {
    if (U == 0) return 0;
    const int grid = U < 132 * 16 ? U : 132 * 16;
    row_adamw_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        p, m, v, ids, g, U, D, neg_lr, c1, c2, eps, wd, b1, b2, omb1, omb2);
    return (int)cudaGetLastError();
}

// hstu_attn_bwd — backward of the pointwise HSTU attention on Hopper (sm_90a):
// dq, dk, dv of out[b, h] = (mask ⊙ silu(q[b, h] k[b, h]ᵀ) / n) · v[b, h]
// over [B, H, L, d] inputs, given the output gradient g; mask = causal &
// non-pad key. Fully padded query rows and pad keys get zero gradients.
//
// Replaces the TPU kernel _bwd_kernel_v2 / _bwd_v2
// (mhrec_tpu/ops/pallas/hstu_attention_tpu.py, the custom VJP of
// hstu_attention_pallas_v2) and, through the v1 layout wrapper
// (hstu_attention_bhld, [B·H, L, d]), _bwd_kernel / _bwd. The TPU kernels'
// L-padding to 128 and head chunking are TPU tiling devices and are left
// out.
//
// Bound on the H100: memory at L=50 (q, k, v, g read and dq, dk, dv written,
// 7·B·H·L·d elements, against about 10·B·H·L²·d/2 causal flops), operations
// at L=400 in f32. The design is in hstu_attn_bwd.cuh: on the bf16
// tensor-core route one block a (batch row, head) for windows of up to 64
// rows, which reads every input once, and a dq and a dk/dv pass over 64-row
// tiles for longer ones; on the CUDA-core route a dk/dv pass over key tiles
// and a dq pass over query tiles, each recomputing the scores in shared
// memory. Both read every input through its strides (a [B, L, H, d] tensor
// viewed as [B, H, L, d] needs no copy) and write [B, H, L, d] gradients at
// the strides they are given.
#include "hstu_attn_bwd.cuh"

// C interface, loaded with ctypes. strides: 21 element strides, (batch,
// head, row) of q, k, v, g, dq, dk, dv in that order; the last dimension of
// every tensor is contiguous. dtype: 0 = float32, 1 = bfloat16 on the CUDA
// cores, 2 = bfloat16 on the tensor cores (needs dqk and dv multiples of 8
// up to 128, every tensor 16-byte aligned with strides above the last that
// are multiples of 8). Returns the cudaError_t of the launches
// (0 = cudaSuccess).
extern "C" int hstu_attn_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const unsigned char* nonpad, void* dq, void* dk, void* dv,
    int B, int H, int L, int dqk, int dv_width, const long long* strides,
    float inv_n, int dtype, void* stream) {
    hstu::BwdArgs p;
    p.q = q; p.k = k; p.v = v; p.g = g; p.nonpad = nonpad;
    p.gq = dq; p.gk = dk; p.gv = dv;
    p.H = H; p.L = L; p.dqk = dqk; p.dv = dv_width; p.inv_n = inv_n;
    for (int t = 0; t < 7; ++t)
        for (int i = 0; i < 3; ++i) p.s[t][i] = strides[3 * t + i];
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 2) return hstu::launch_attn_bwd_bf16_tc(p, B, s);
    if (dtype == 1) return hstu::launch_attn_bwd<__nv_bfloat16>(p, B, s);
    if (dtype == 0) return hstu::launch_attn_bwd<float>(p, B, s);
    return (int)cudaErrorInvalidValue;
}

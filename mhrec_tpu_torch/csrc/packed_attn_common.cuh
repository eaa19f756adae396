// Shared device code of the packed segment attention kernels
// (packed_attn_fwd.cu, packed_attn_bwd.cu, packed_attn_bwd_f32.cu): the
// backward's arguments, the float32 forward's tile sizes and thread layout,
// and the conversions between the input type and float32.
//
// The float32 forward's block has NT = 256 threads, a 16 x 16 grid (ty, tx).
// In a score tile of TQ query rows by TK key rows, thread (ty, tx) owns rows
// ty + 16·r (r < 4) and columns tx + 16·j (j < 4); the 16 lanes of one row
// are one half-warp, so a row's sums reduce with four xor shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace packed {

constexpr int TQ = 64;             // query rows per tile
constexpr int TK = 64;             // key rows per tile
constexpr int NT = 256;            // threads per block, a 16 x 16 grid
constexpr int RQ = TQ / 16;        // query rows per thread
constexpr int RK = TK / 16;        // key rows (score columns) per thread

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Pointers and strides of one backward call; strides in elements
struct BwdArgs {
    const void* q;        // [C, S, H, dh], chunk-row / token strides sqc, sqs
    const void* k;        // [C, S, Hkv, dh], skc, sks
    const void* v;        // [C, S, Hkv, dh], svc, svs
    const void* o;        // [C, S, H, dh] contiguous
    const void* dout;     // [C, S, H, dh] contiguous
    const float* lse;     // [C, H, S]
    const int* seg;       // [C, S]
    void* dq;             // [C, S, H, dh] contiguous
    void* dk;             // [C, S, Hkv, dh] contiguous
    void* dv;             // [C, S, Hkv, dh] contiguous
    float* delta;         // [C, H, S] scratch: written by the dq pass
    int S, H, Hkv, window;
    long long sqc, sqs, skc, sks, svc, svs;
    float scale;
};

// the sum of x over the 16 lanes of one half-warp, in every lane
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

}  // namespace packed

// Warp-level tensor-core primitives of the port's bf16 kernels on Hopper
// (sm_90a): 16-byte cp.async copies into shared memory (zero-filled past a
// tile's edge), ldmatrix (plain and transposed) and mma.sync m16n8k16 with
// bf16 operands and float32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (lane = 4·g + t, g < 8, t < 4):
//   A (16 x 16, row-major) a[0] = (g, 2t..2t+1)   a[1] = (g + 8, 2t..2t+1)
//                          a[2] = (g, 2t+8..2t+9) a[3] = (g + 8, 2t+8..2t+9)
//   B (16 x 8, col-major)  b[0] = (2t..2t+1, g)   b[1] = (2t+8..2t+9, g)
//   C (16 x 8, float32)    c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..2t+1)
// so the C tiles of two neighbouring 8-column blocks, rounded to bf16 pairs
// (pack_bf16), are the A fragment of a product whose depth runs over those
// 16 columns: a score tile feeds the next product from registers.
//
// Shared-memory tiles are row-major with a pitch of (width + 8) bf16: a row
// is a whole number of 16-byte chunks plus one, so the eight rows an
// ldmatrix phase reads at one column fall into eight different bank groups.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace tc {

constexpr int PAD = 8;  // bf16 of padding after each shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !pred (src is
// then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(pred ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, n) of an R x W bf16 tile at src (row stride `stride` elements,
// rows 16-byte aligned) into shared memory at dst (pitch W + PAD); rows n..R-1
// and the 16-byte chunks of a row from cw on are zero-filled. All NTH threads
// of the block take part.
template <int R, int W, int NTH>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long stride, int n, int tid, int cw = W / 8) {
    constexpr int CPR = W / 8;  // 16-byte chunks a row
    static_assert((R * CPR) % NTH == 0, "a tile must split evenly over the block");
#pragma unroll
    for (int it = 0; it < R * CPR / NTH; ++it) {
        const int e = tid + it * NTH, r = e / CPR, ch = e % CPR;
        const bool in = r < n && ch < cw;
        cp_async16(dst + r * (W + PAD) + ch * 8, in ? src + r * stride + ch * 8 : src, in);
    }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// A fragment: rows 0..15, columns col0..col0+15 of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                     int col0, int lane) {
    ldsm_x4(a, tile + (lane & 15) * ld + col0 + (lane >> 4) * 8);
}
// B fragments of two 8-column blocks n0..n0+7 (b[0], b[1]) and n0+8..n0+15
// (b[2], b[3]) over depth k0..k0+15, from a tile stored [n][k]
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                        int n0, int k0, int lane) {
    ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}
// the same from a tile stored [k][n], transposed on the way
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                        int k0, int n0, int lane) {
    ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// d += a · b on the tensor cores, float32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest even into one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc

// Hopper's warp-level tensor-core product for the bf16 kernels (K1-bf16 in
// attn_fwd.cuh, K2-bf16 in node_layer.cuh): mma.sync m16n8k16 on bf16
// operands with an fp32 accumulator, and the loads of its fragments from
// shared memory; m16n8k8 for K1-bf16's logits at d_head 8 and 4 (below).
//
// A product of two bf16 values is exact in fp32, so a bf16 MMA with fp32
// accumulation computes the Pallas kernels' `jnp.dot(..., preferred_element_
// type=jnp.float32)` on bf16 operands up to the order and rounding of the
// sums (trafficbots_tpu/ops/fused_attention.py `_attn_kernel`,
// ops/node_encoder.py `_node_kernel_body`'s `mm`).
//
// The fragments, per the PTX ISA's m16n8k16 layout (.bf16 A and B, .f32 C),
// with g = lane / 4 and t = lane % 4 (two bf16 a 32-bit register, the lower
// column or k in the lower half):
//   A (16 x 16, row-major): a[0] row g, columns 2t, 2t + 1; a[1] row g + 8,
//     the same columns; a[2], a[3] as a[0], a[1] at columns + 8;
//   B (16 x 8, k x n): b[0] k rows 2t, 2t + 1 of column g; b[1] k rows + 8;
//   C (16 x 8): c[0], c[1] row g, columns 2t, 2t + 1; c[2], c[3] row g + 8.
// m16n8k8 (a k-step of 8, for heads narrower than 16): A (16 x 8) a[0]
// row g, columns 2t, 2t + 1; a[1] row g + 8; B (8 x 8) b[0] k rows 2t,
// 2t + 1 of column g; C as m16n8k16's.
// The fragments load with plain 32-bit (A, and B stored n-major) or 16-bit
// (B stored k-major) loads from shared memory: no ldmatrix.
//
// The primitives (the MMA and the fp32 pair to bf16x2 conversion) sit behind
// the small functions below, so that tests/cuda_emu/cuda_runtime.h can give
// each a plain C++ body (one warp's MMA through per-lane slots between two
// warp barriers: tests/test_torch_cuda_emu_mma.py holds it to the
// hardware's layout, and tests/test_torch_cuda.py runs the same source on
// the card).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#ifndef TB_CUDA_EMU
// c += a b: a 16 x 16 bf16, b 16 x 8 bf16, c 16 x 8 fp32 (fragments above)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b: a 16 x 8 bf16, b 8 x 8 bf16, c 16 x 8 fp32 (m16n8k8 fragments above)
__device__ __forceinline__ void mma_bf16_1688(float (&c)[4], const uint32_t (&a)[2], const uint32_t (&b)[1]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// lo and hi rounded to bf16 (to nearest even), lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}
#endif

namespace tb_mma {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// The A fragment of the 16 x 16 tile at (r0, k0) of a row-major bf16
// matrix with row stride ld (even) elements.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* m, int ld, int r0, int k0) {
    const int lane = threadIdx.x & 31;
    const __nv_bfloat16* p = m + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * ld);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * ld + 8);
}

// The B fragment of the 16 x 8 tile at (k0, n0) of B stored n-major:
// B[k][n] at m[n * ld + k] (K rows for q kᵀ, a transposed weight).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2], const __nv_bfloat16* m, int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31;
    const __nv_bfloat16* p = m + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    b[0] = ld32(p);
    b[1] = ld32(p + 8);
}

// The B fragment of the 16 x 8 tile at (k0, n0) of B stored k-major:
// B[k][n] at m[k * ld + n] (V rows for the weighted sum), two 16-bit loads
// a register.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2], const __nv_bfloat16* m, int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31;
    const uint16_t* p = reinterpret_cast<const uint16_t*>(m) + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
    b[0] = (uint32_t)p[0] | (uint32_t)p[ld] << 16;
    b[1] = (uint32_t)p[8 * ld] | (uint32_t)p[9 * ld] << 16;
}

// The m16n8k8 A fragment of the 16 x 8 tile at (r0, k0) of a row-major
// bf16 matrix (row stride ld, even), and the B fragment of the 8 x 8 tile
// at (k0, n0) of B stored n-major (B[k][n] at m[n * ld + k]).
__device__ __forceinline__ void load_a_k8(uint32_t (&a)[2], const __nv_bfloat16* m, int ld, int r0, int k0) {
    const int lane = threadIdx.x & 31;
    const __nv_bfloat16* p = m + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * ld);
}

__device__ __forceinline__ void load_b_nk_k8(uint32_t (&b)[1], const __nv_bfloat16* m, int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31;
    b[0] = ld32(m + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3));
}

}  // namespace tb_mma

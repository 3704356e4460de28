// A one-warp check of csrc/mma.cuh (m16n8k16 and m16n8k8), built by tests/test_torch_cuda_emu_mma.py
// for the CPU emulator and by tests/test_torch_cuda.py with nvcc for the
// card (-I trafficbots_tpu_torch/csrc): the same source, so that the card's
// answers show that the emulator's fragment layout is the hardware's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// c_nk = c_kn = a b over the 16 x 8 tiles of c in turn, k in steps of 16:
// a [M][K] row-major, b both n-major (bt [N][K], load_b_nk) and k-major
// (b [K][N], load_b_kn), all bf16, the fragments read from device memory.
__global__ void mma_check_kernel(const __nv_bfloat16* a, const __nv_bfloat16* bt, const __nv_bfloat16* b,
                                 float* c_nk, float* c_kn, int M, int N, int K) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int m0 = 0; m0 < M; m0 += 16)
        for (int n0 = 0; n0 < N; n0 += 8) {
            float acc_nk[4] = {0.f, 0.f, 0.f, 0.f}, acc_kn[4] = {0.f, 0.f, 0.f, 0.f};
            for (int k0 = 0; k0 < K; k0 += 16) {
                uint32_t fa[4], fb[2];
                tb_mma::load_a(fa, a, K, m0, k0);
                tb_mma::load_b_nk(fb, bt, K, k0, n0);
                mma_bf16_16816(acc_nk, fa, fb);
                tb_mma::load_b_kn(fb, b, N, k0, n0);
                mma_bf16_16816(acc_kn, fa, fb);
            }
            for (int i = 0; i < 4; ++i) {
                const int r = m0 + g + 8 * (i >> 1), c = n0 + 2 * t + (i & 1);
                c_nk[r * N + c] = acc_nk[i];
                c_kn[r * N + c] = acc_kn[i];
            }
        }
}

// c = a b as above with the m16n8k8 product, k in steps of 8 (b n-major).
__global__ void mma_check_k8_kernel(const __nv_bfloat16* a, const __nv_bfloat16* bt, float* c, int M, int N, int K) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int m0 = 0; m0 < M; m0 += 16)
        for (int n0 = 0; n0 < N; n0 += 8) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            for (int k0 = 0; k0 < K; k0 += 8) {
                uint32_t fa[2], fb[1];
                tb_mma::load_a_k8(fa, a, K, m0, k0);
                tb_mma::load_b_nk_k8(fb, bt, K, k0, n0);
                mma_bf16_1688(acc, fa, fb);
            }
            for (int i = 0; i < 4; ++i) c[(m0 + g + 8 * (i >> 1)) * N + n0 + 2 * t + (i & 1)] = acc[i];
        }
}

__global__ void pack_check_kernel(const float* x, uint32_t* out, int n) {
    for (int i = threadIdx.x; i < n; i += 32) out[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

}  // namespace

// One warp: c_nk, c_kn [M][N] fp32 from a [M][K], bt [N][K], b [K][N] bf16
// (M % 16 == N % 8 == K % 16 == 0). Returns the cudaError_t of the launch.
extern "C" int tb_mma_check(const void* a, const void* bt, const void* b, void* c_nk, void* c_kn, int M, int N, int K,
                            void* stream) {
    mma_check_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(bt),
        static_cast<const __nv_bfloat16*>(b), static_cast<float*>(c_nk), static_cast<float*>(c_kn), M, N, K);
    return (int)cudaGetLastError();
}

// One warp: c [M][N] fp32 from a [M][K] and bt [N][K] bf16 by m16n8k8
// (M % 16 == N % 8 == K % 8 == 0).
extern "C" int tb_mma_check_k8(const void* a, const void* bt, void* c, int M, int N, int K, void* stream) {
    mma_check_k8_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(bt), static_cast<float*>(c), M, N, K);
    return (int)cudaGetLastError();
}

// out[i] = pack_bf16(x[2 i], x[2 i + 1]) for i < n, one warp.
extern "C" int tb_pack_check(const void* x, void* out, int n, void* stream) {
    pack_check_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                                       static_cast<uint32_t*>(out), n);
    return (int)cudaGetLastError();
}

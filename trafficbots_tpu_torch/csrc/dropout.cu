// Inverted dropout of a contiguous tensor for Hopper (sm_90a), plain C
// interface: out = x * mask, mask from philox.cuh.
//
// Replaces: the dropout draws of the JAX package that are not inside a
// Pallas kernel (flax nn.Dropout at the MLP, transformer, GRU, latent/goal
// injection and input-encoder sites), and stands for the mask dumps of
// trafficbots_tpu/ops/kernel_common.py `dropout_mask` (dropout of ones is
// the mask). The logical tensor is [rows, C]: row = the flat index of the
// leading coordinates, col = the last one, so the bits are the same as
// those the plain version (ops/dropout.py) and the attention / node-encoder
// kernels draw for the same coordinates.
//
// What bounds it on the card: the bytes, 8 a float element (read x, write
// out), against ~11 integer operations an element for the Philox rounds
// (one Philox call gives four elements' bits). At 3.35 TB/s a 1 M-element
// tensor takes 2.5 us; the integer rate is far above that. One thread
// handles four consecutive elements of a row: one Philox call, one float4
// load and store where the row length is a multiple of four.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dropout_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows, int C,
               tb_philox::Dropout d, uint32_t site) {
    const int c4n = (C + 3) / 4;
    const long long n = rows * c4n;
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS) {
        const long long row = i / c4n;
        const int c4 = (int)(i % c4n);
        float f[4];
        tb_philox::factors4(d, site, (unsigned long long)row, (uint32_t)c4, f);
        const long long base = row * C + 4 * c4;
        if ((C & 3) == 0) {
            float4 v = *reinterpret_cast<const float4*>(x + base);
            v.x *= f[0];
            v.y *= f[1];
            v.z *= f[2];
            v.w *= f[3];
            *reinterpret_cast<float4*>(out + base) = v;
        } else {
            for (int j = 0; j < 4 && 4 * c4 + j < C; ++j) out[base + j] = x[base + j] * f[j];
        }
    }
}

}  // namespace

// x, out [rows, C] fp32 contiguous, not overlapping. threshold/scale as in
// philox.cuh. Returns the cudaError_t of the launch.
extern "C" int tb_dropout(const void* x, void* out, long long rows, int C, unsigned long long seed,
                          unsigned int site, unsigned int threshold, float scale, void* stream) {
    if (rows <= 0 || C <= 0) return 0;
    tb_philox::Dropout d{seed, threshold, scale, 1};
    const long long n = rows * ((C + 3) / 4);
    const long long want = (n + THREADS - 1) / THREADS;
    const int grid = (int)(want < 132LL * 16 ? want : 132LL * 16);
    dropout_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, C, d, site);
    return (int)cudaGetLastError();
}

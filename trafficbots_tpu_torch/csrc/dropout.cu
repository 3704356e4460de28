// Inverted dropout of a contiguous tensor for Hopper (sm_90a), plain C
// interface: out = x * mask, mask from philox.cuh, and two fused entries
// that fold the neighbouring elementwise operation into the same pass:
//   dropout_add:  out = res + x * mask    (a residual add after dropout)
//   relu_dropout: out = relu(x * mask)    (= dropout(relu(x)): the scale is
//                                          positive; its backward below)
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
// out; 12 with the residual), against ~11 integer operations an element for
// the Philox rounds (one Philox call gives four elements' bits). At 3.35
// TB/s a 1 M-element tensor takes 2.5 us; the integer rate is far above
// that. One thread handles four consecutive elements of a row: one Philox
// call, one float4 load and store where the row length is a multiple of
// four and the pointers are 16-byte aligned. At the training step's small
// shapes ([8, 64, 128]: 256 KB) the launch itself is the cost, so the fused
// entries save a launch of the add or the ReLU at every such site.
// Products and sums are rounded separately (no contraction into an FMA), so
// each entry equals the plain composition bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 16;

enum Op { DROP = 0, ADD = 1, RELU = 2 };

template <int OP>
__device__ __forceinline__ float apply(float x, float f, float res) {
    const float y = __fmul_rn(x, f);
    if (OP == ADD) return __fadd_rn(res, y);
    if (OP == RELU) return y > 0.f ? y : 0.f;
    return y;
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
dropout_kernel(const float* __restrict__ x, const float* __restrict__ res, float* __restrict__ out,
               long long rows, int C, int vec, tb_philox::Dropout d, uint32_t site) {
    const int c4n = (C + 3) / 4;
    const long long n = rows * c4n;
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS) {
        const long long row = i / c4n;
        const int c4 = (int)(i % c4n);
        float f[4];
        tb_philox::factors4(d, site, (unsigned long long)row, (uint32_t)c4, f);
        const long long base = row * C + 4 * c4;
        if (vec) {
            const float4 v = *reinterpret_cast<const float4*>(x + base);
            float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
            if (OP == ADD) r = *reinterpret_cast<const float4*>(res + base);
            *reinterpret_cast<float4*>(out + base) = make_float4(
                apply<OP>(v.x, f[0], r.x), apply<OP>(v.y, f[1], r.y), apply<OP>(v.z, f[2], r.z),
                apply<OP>(v.w, f[3], r.w));
        } else {
            for (int j = 0; j < 4 && 4 * c4 + j < C; ++j)
                out[base + j] = apply<OP>(x[base + j], f[j], OP == ADD ? res[base + j] : 0.f);
        }
    }
}

// dx = g * scale where y > 0, else 0: the backward of relu_dropout from its
// output alone (y > 0 exactly where x > 0 and the mask keeps).
__global__ void __launch_bounds__(THREADS)
relu_dropout_bwd_kernel(const float* __restrict__ g, const float* __restrict__ y, float* __restrict__ dx,
                        long long n, float scale) {
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n; i += (long long)gridDim.x * THREADS)
        dx[i] = y[i] > 0.f ? __fmul_rn(g[i], scale) : 0.f;
}

int grid_for(long long n) {
    const long long want = (n + THREADS - 1) / THREADS;
    return (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int OP>
int launch(const void* x, const void* res, void* out, long long rows, int C, unsigned long long seed,
           unsigned int site, unsigned int threshold, float scale, void* stream) {
    if (rows <= 0 || C <= 0) return 0;
    tb_philox::Dropout d{seed, threshold, scale, 1};
    const int vec = (C % 4 == 0) && aligned16(x) && aligned16(res) && aligned16(out);
    dropout_kernel<OP><<<grid_for(rows * ((C + 3) / 4)), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(res), static_cast<float*>(out), rows, C, vec, d,
        site);
    return (int)cudaGetLastError();
}

}  // namespace

// x, res, out [rows, C] fp32 contiguous, out not overlapping the inputs.
// threshold/scale as in philox.cuh. Each returns the cudaError_t of the launch.
extern "C" int tb_dropout(const void* x, void* out, long long rows, int C, unsigned long long seed,
                          unsigned int site, unsigned int threshold, float scale, void* stream) {
    return launch<DROP>(x, nullptr, out, rows, C, seed, site, threshold, scale, stream);
}

extern "C" int tb_dropout_add(const void* res, const void* x, void* out, long long rows, int C,
                              unsigned long long seed, unsigned int site, unsigned int threshold, float scale,
                              void* stream) {
    return launch<ADD>(x, res, out, rows, C, seed, site, threshold, scale, stream);
}

extern "C" int tb_relu_dropout(const void* x, void* out, long long rows, int C, unsigned long long seed,
                               unsigned int site, unsigned int threshold, float scale, void* stream) {
    return launch<RELU>(x, nullptr, out, rows, C, seed, site, threshold, scale, stream);
}

// g, y, dx [n] fp32 contiguous.
extern "C" int tb_relu_dropout_bwd(const void* g, const void* y, void* dx, long long n, float scale, void* stream) {
    if (n <= 0) return 0;
    relu_dropout_bwd_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const float*>(y), static_cast<float*>(dx), n, scale);
    return (int)cudaGetLastError();
}

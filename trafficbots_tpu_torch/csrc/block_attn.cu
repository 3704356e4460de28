// Per-polyline attention core of the hybrid node encoder for Hopper (sm_90a),
// plain C interface.
//
// Replaces: trafficbots_tpu/ops/node_encoder.py, FusedNodeEncoder.
// encode_pooled_hybrid -> _block_attn_kernel (the Pallas TPU kernel). Same
// function, per polyline p of N nodes and per head h:
//   out[p, s, h*dh:(h+1)*dh] = softmax_t(q_h[s] . k_h[t] * scale + mask[t]) . v_h
// with mask[t] = -1e30 for a padded target node and 0 otherwise, and the mask
// lifted (all 0) for a polyline without a valid node. The TPU kernel lifts it
// over its whole 8-polyline block; the rows of such polylines are zeroed by
// the caller after the out-projection, so the two agree wherever it matters.
// The LayerNorms, projections and FFN around the core are plain matmuls in
// the caller (ops/node_encoder.py, encode_pooled_hybrid).
//
// Precision: fp32 throughout; -1e30 stays fp32 (it would overflow bf16 or
// fp16). The softmax is two-pass with the exact row max, as the TPU kernel
// and torch.softmax compute it; a running (online) softmax changes the order
// of operations and was not stable under the 91-step closed loop.
//
// What bounds it on the card: at the map encode's full width (8 scenes x 1024
// polylines, N = 20, D = 128, 4 heads) the call reads q, k, v and writes the
// output, 4 x 8192 x 20 x 128 x 4 B = 335.5 MB (0.100 ms at 3.35 TB/s), for
// 4 N^2 D = 205 kFLOP a polyline, 1.68 GFLOP in all (0.025 ms at 67 TFLOP/s
// fp32): 5 FLOP a byte, so the bytes bound it. This first design reads each
// byte once: one block per polyline loads its q, k, v (N x D each, rows
// padded to D + 1 floats so that a warp walking keys or queries hits distinct
// banks) into shared memory, keeps the [H, N, N] logits there, and writes
// each output element once, a warp to 32 neighbouring columns. 37 KB of
// shared memory a block at N = 20 lets six blocks share an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXN = 32;    // KERNEL_MAX_NODES in the wrapper
constexpr int MAXD = 128;   // KERNEL_MAX_D in the wrapper
constexpr int THREADS = 128;
constexpr int SMEM_OPTIN = 232448;  // bytes of shared memory a block may opt in to on sm_90

// dynamic shared memory of one block: q, k, v rows of D + 1 floats and the
// [H, N, N] weights (smem_bytes in the wrapper adds the static tmask and flag)
constexpr size_t dyn_smem_bytes(int N, int D, int H) {
    return sizeof(float) * ((size_t)3 * N * (D + 1) + (size_t)H * N * N);
}
constexpr size_t STATIC_SMEM = sizeof(float) * MAXN + sizeof(int);

__global__ void __launch_bounds__(THREADS)
block_attn_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const uint8_t* __restrict__ valid, float* __restrict__ out, int N, int D, int H,
                  float scale) {
    extern __shared__ float smem[];
    __shared__ float tmask[MAXN];  // additive mask of each target node: 0 or -1e30
    __shared__ int any_valid;

    const int ld = D + 1;
    float* qs = smem;           // [N][D + 1]
    float* ks = qs + N * ld;    // [N][D + 1]
    float* vs = ks + N * ld;    // [N][D + 1]
    float* at = vs + N * ld;    // [H][N][N]: logits, then weights

    const long long base = (long long)blockIdx.x * N * D;
    const uint8_t* vrow = valid + (long long)blockIdx.x * N;
    const int tid = threadIdx.x;
    for (int i = tid; i < N * D; i += THREADS) {
        const int r = i / D, c = i % D;
        qs[r * ld + c] = q[base + i];
        ks[r * ld + c] = k[base + i];
        vs[r * ld + c] = v[base + i];
    }
    if (tid == 0) {
        int a = 0;
        for (int t = 0; t < N; ++t) a |= vrow[t] != 0;
        any_valid = a;
    }
    __syncthreads();
    if (tid < N) tmask[tid] = (any_valid && vrow[tid] == 0) ? -1e30f : 0.f;
    __syncthreads();

    // ---- logits: entry e = (h, s, t), t fastest; q . k over the head's dh
    // columns, then * scale + mask, in the TPU kernel's order
    const int dh = D / H;
    for (int e = tid; e < H * N * N; e += THREADS) {
        const int t = e % N, s = (e / N) % N, h = e / (N * N);
        const float* qr = qs + s * ld + h * dh;
        const float* kr = ks + t * ld + h * dh;
        float acc = 0.f;
        for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kr[d], acc);
        at[e] = acc * scale + tmask[t];
    }
    __syncthreads();

    // ---- softmax: one thread per (head, query) row, exact max over the row,
    // then exp and sum, then the division (torch.softmax's order)
    for (int r = tid; r < H * N; r += THREADS) {
        float* row = at + r * N;
        float m = -INFINITY;
        for (int t = 0; t < N; ++t) m = fmaxf(m, row[t]);
        float sum = 0.f;
        for (int t = 0; t < N; ++t) {
            const float e = expf(row[t] - m);
            row[t] = e;
            sum += e;
        }
        for (int t = 0; t < N; ++t) row[t] = row[t] / sum;
    }
    __syncthreads();

    // ---- AV: thread c owns output column c of every query row
    for (int c = tid; c < D; c += THREADS) {
        const float* wh = at + (c / dh) * N * N;
        for (int s = 0; s < N; ++s) {
            const float* w = wh + s * N;
            float acc = 0.f;
            for (int t = 0; t < N; ++t) acc = fmaf(w[t], vs[t * ld + c], acc);
            out[base + (long long)s * D + c] = acc;
        }
    }
}

}  // namespace

// q, k, v, out [BP, N, D] fp32 contiguous, valid [BP, N] bool bytes, scale =
// 1 / sqrt(D / n_head) as the caller rounds it to fp32. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for shapes the kernel does
// not take).
extern "C" int tb_block_attn(const void* q, const void* k, const void* v, const void* valid, void* out,
                             int BP, int N, int D, int n_head, float scale, void* stream) {
    if (BP <= 0 || N < 1 || N > MAXN || D < 1 || D > MAXD || n_head < 1 || D % n_head) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = dyn_smem_bytes(N, D, n_head);
    if (smem + STATIC_SMEM > (size_t)SMEM_OPTIN) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(block_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    block_attn_kernel<<<BP, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out), N, D, n_head, scale);
    return (int)cudaGetLastError();
}

// Masked multi-head attention core for Hopper (sm_90a), plain C interface.
//
// Replaces: trafficbots_tpu/ops/fused_attention.py, fused_attention_core ->
// _attn_kernel (the Pallas TPU kernel). Same function:
//   out[b, s, h*dh:(h+1)*dh] = softmax_t(q_h . k_h / sqrt(dh), masked) . v_h
// with invalid[b, s, t] != 0 = disallowed target. A row whose targets are all
// disallowed comes out exactly 0 (the reference lifts the mask on such rows
// and zeroes their output; the result is the same zeros).
//
// Precision: q, the logits, the softmax and the accumulation are fp32. K/V
// may be stored in bf16 (the eval map K/V cache): they are widened to fp32
// as they are loaded and used in fp32 from there on. This matches the JAX
// package's XLA path and the port's plain version (attention_core_plain),
// not the TPU kernel path, which also rounds q and the weights to bf16.
//
// The softmax is two-pass with the exact row max over the whole target row,
// as the TPU kernel computes it. A running (online) softmax changes the
// order of operations and was not stable under the 91-step closed loop.
//
// What bounds it on the card: at the rollout's as2pl site (S = 64 agents,
// T = 1024 map tokens, bf16 K/V, 4 heads of 32) a scene moves the bf16 K/V
// cache (2 x 1024 x 128 x 2 B = 512 KB), q and out (32 KB each) and the mask
// (1 KB: a stride-0 expand of the [T] padding mask, read through its
// strides) for 2 x 2 x 64 x 1024 x 128 = 33.5 MFLOP: 58 FLOP a byte. On the
// fp32 CUDA cores this kernel uses (67 TFLOP/s against 3.35 TB/s of HBM,
// 20 FLOP/B) the operations bound it (0.50 us a scene vs 0.17 us for the
// bytes); once the products move to the tensor cores the bf16 K/V bytes
// will. This first design keeps everything out of device memory but q, K/V,
// the mask and the output: one block per (scene, head, 16 query rows); the
// [16, T] fp32 logits stay in shared memory (4 KB a row at T = 1024); K and
// V stream through a 64-key fp32 tile. No wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;     // query rows per block (ROWS_PER_BLOCK in the wrapper)
constexpr int TK = 64;       // keys per staged K/V tile
constexpr int THREADS = 256; // = TK x (ROWS / 4): one key x 4 rows per thread in the logits phase

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <int DH, typename KV>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
            const uint8_t* __restrict__ inv, float* __restrict__ out,
            int S, int T, int D, long long inv_sb, long long inv_ss) {
    static_assert(THREADS == TK * (ROWS / 4), "logits phase mapping");
    static_assert(THREADS % DH == 0 && ROWS % (THREADS / DH) == 0, "AV phase mapping");
    extern __shared__ float smem[];
    __shared__ int row_dead[ROWS];

    const int t_pad = (T + 3) & ~3;
    float* logit = smem;                 // [ROWS][t_pad]: logits, then weights
    float* qs = logit + ROWS * t_pad;    // [ROWS][DH]
    float* kv = qs + ROWS * DH;          // [TK][DH + 1]: staged K, then V, as fp32

    const int b = blockIdx.z;
    const int h = blockIdx.y;
    const int s0 = blockIdx.x * ROWS;
    const int rows = min(ROWS, S - s0);
    const int tid = threadIdx.x;
    const long long kv_base = (long long)b * T * D + h * DH;

    for (int i = tid; i < ROWS * DH; i += THREADS) {
        const int r = i / DH, d = i % DH;
        qs[i] = r < rows ? q[((long long)b * S + s0 + r) * D + h * DH + d] : 0.f;
    }

    // ---- logits: thread (kt, rg) scores key t0 + kt against rows 4rg..4rg+3
    const float sqrt_dh = sqrtf((float)DH);
    const int kt = tid % TK;
    const int rg = tid / TK;
    for (int t0 = 0; t0 < T; t0 += TK) {
        __syncthreads();
        for (int i = tid; i < TK * DH; i += THREADS) {
            const int tt = i / DH, d = i % DH;
            const int t = t0 + tt;
            kv[tt * (DH + 1) + d] = t < T ? to_f(k[kv_base + (long long)t * D + d]) : 0.f;
        }
        __syncthreads();
        const int t = t0 + kt;
        if (t < T) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int d = 0; d < DH; ++d) {
                const float kd = kv[kt * (DH + 1) + d];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[j] = fmaf(qs[(rg * 4 + j) * DH + d], kd, acc[j]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = rg * 4 + j;
                if (r < rows) {
                    const bool masked = inv[b * inv_sb + (long long)(s0 + r) * inv_ss + t] != 0;
                    logit[r * t_pad + t] = masked ? -INFINITY : acc[j] / sqrt_dh;
                }
            }
        }
    }
    __syncthreads();

    // ---- softmax: one warp per row, exact max over the whole row, then
    // exp and sum, then the division (same order as torch.softmax)
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < ROWS; r += THREADS / 32) {
        if (r >= rows) {
            if (lane == 0) row_dead[r] = 1;
            continue;
        }
        float* lr = logit + r * t_pad;
        float m = -INFINITY;
        for (int t = lane; t < T; t += 32) m = fmaxf(m, lr[t]);
        m = warp_max(m);
        if (m == -INFINITY) {  // every target masked: the row's output is 0
            if (lane == 0) row_dead[r] = 1;
            continue;
        }
        float sum = 0.f;
        for (int t = lane; t < T; t += 32) {
            const float e = expf(lr[t] - m);
            lr[t] = e;
            sum += e;
        }
        sum = warp_sum(sum);
        for (int t = lane; t < T; t += 32) lr[t] = lr[t] / sum;
        if (lane == 0) row_dead[r] = 0;
    }

    // ---- AV: thread (r0, d) accumulates rows r0, r0 + RSTEP, ... of column d
    constexpr int RSTEP = THREADS / DH;
    constexpr int NR = ROWS / RSTEP;
    const int d = tid % DH;
    const int r0 = tid / DH;
    float acc[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j] = 0.f;
    for (int t0 = 0; t0 < T; t0 += TK) {
        __syncthreads();
        for (int i = tid; i < TK * DH; i += THREADS) {
            const int tt = i / DH, dd = i % DH;
            const int t = t0 + tt;
            kv[tt * (DH + 1) + dd] = t < T ? to_f(v[kv_base + (long long)t * D + dd]) : 0.f;
        }
        __syncthreads();
        const int tn = min(TK, T - t0);
        for (int tt = 0; tt < tn; ++tt) {
            const float vd = kv[tt * (DH + 1) + d];
#pragma unroll
            for (int j = 0; j < NR; ++j)
                acc[j] = fmaf(logit[(r0 + j * RSTEP) * t_pad + t0 + tt], vd, acc[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
        const int r = r0 + j * RSTEP;
        if (r < rows) out[((long long)b * S + s0 + r) * D + h * DH + d] = row_dead[r] ? 0.f : acc[j];
    }
}

template <int DH, typename KV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* inv, void* out,
                   int B, int S, int T, int D, int n_head, long long inv_sb, long long inv_ss,
                   cudaStream_t stream) {
    const int t_pad = (T + 3) & ~3;
    const size_t smem = sizeof(float) * ((size_t)ROWS * t_pad + ROWS * DH + TK * (DH + 1));
    cudaError_t err = cudaFuncSetAttribute(attn_kernel<DH, KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((S + ROWS - 1) / ROWS, n_head, B);
    attn_kernel<DH, KV><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
        static_cast<const uint8_t*>(inv), static_cast<float*>(out), S, T, D, inv_sb, inv_ss);
    return cudaGetLastError();
}

}  // namespace

// q [B,S,D] fp32, k/v [B,T,D] fp32 (kv_bf16 = 0) or bf16 (kv_bf16 = 1),
// invalid addressed as inv[b * inv_sb + s * inv_ss + t] (bool bytes),
// out [B,S,D] fp32. Returns the cudaError_t of the launch.
extern "C" int tb_fused_attention(const void* q, const void* k, const void* v, const void* invalid,
                                  void* out, int B, int S, int T, int D, int n_head, int kv_bf16,
                                  long long inv_sb, long long inv_ss, void* stream) {
    const int dh = D / n_head;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TB_LAUNCH(DHV)                                                                           \
    return (int)(kv_bf16 ? launch<DHV, __nv_bfloat16>(q, k, v, invalid, out, B, S, T, D, n_head, \
                                                      inv_sb, inv_ss, st)                        \
                         : launch<DHV, float>(q, k, v, invalid, out, B, S, T, D, n_head, inv_sb, \
                                              inv_ss, st))
    switch (dh) {
        case 16: TB_LAUNCH(16);
        case 32: TB_LAUNCH(32);
        case 64: TB_LAUNCH(64);
        default: return (int)cudaErrorInvalidValue;
    }
#undef TB_LAUNCH
}

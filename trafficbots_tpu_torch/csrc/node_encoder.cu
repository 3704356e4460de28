// DenseTNT polyline-node encoder + masked max-pool for Hopper (sm_90a),
// plain C interface.
//
// Replaces: trafficbots_tpu/ops/node_encoder.py,
// FusedNodeEncoder.encode_pooled -> _node_kernel / _node_kernel_body (the
// Pallas TPU kernel). Same function, per polyline of N <= 31 nodes and
// n_layer pre-norm layers with d_model = d_ff = 128:
//   q = LN1(x) Wq + bq;  k, v = LN_tgt(x0) Wk|Wv + b   (x0 = layer-0 input)
//   a = softmax(q_h k_hᵀ / sqrt(dh), padded nodes masked) v_h per head;
//       a polyline without a valid node runs unmasked and a is zeroed
//   x += a Wo + bo;  x += relu(LN2(x) W1 + b1) W2 + b2;  invalid rows = 0
// then the max over valid nodes (-1e30 for a polyline without one). All
// arithmetic is fp32; LayerNorm uses eps 1e-5 and the two-pass variance.
//
// What bounds it on the card: the fp32 operations, about 6 dense 128 x 128
// products a node a layer (2 x 6 x 128 x 128 = 197 kFLOP) plus the small
// per-polyline attention; it reads 10 KB of node features a polyline and
// writes 512 B. At 8 scenes x 1024 polylines x 20 nodes x 3 layers that is
// ~100 GFLOP against ~85 MB, far on the operations side of the fp32 CUDA
// cores' 20 FLOP/B.
//
// This first design keeps everything between the layers out of device
// memory: a block holds two polylines (40 rows) in shared memory through
// all layers: x, x0 and five [40, 132] work buffers (LN output, q, k, v,
// attention/FFN hidden), 148 KB at N = 20. The dense products stream the
// 128 x 128 fp32 weights (64 KB a matrix, 1.2 MB in all, shared by every
// block) from L2, each matrix read once a block, into register tiles of
// 5 rows x 4 columns a thread (see matmul). A block whose polylines are all
// padding writes -1e30 and returns, like the TPU kernel's skip flag. Only
// the pooled [128] row of each polyline is written. No tensor cores yet:
// the products stay fp32 on the CUDA cores, as the model's fp32 parity needs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // d_model == d_feedforward
constexpr int PPB = 2;        // polylines per block
constexpr int THREADS = PPB * D;
constexpr int MAXN = 31;      // max nodes per polyline: the most that fit shared memory
constexpr int LDS = D + 4;    // padded row stride of the shared buffers (16-byte rows)
constexpr int MAXRT = (PPB * MAXN + 7) / 8;  // rows of a thread's register tile in matmul
constexpr int NBUF = 7;       // x, x0, t, q, k, v, a
constexpr int SMEM_OPTIN = 232448;  // shared memory a block may opt in to on sm_90
constexpr int STATIC_SMEM = sizeof(float) * PPB * MAXN + sizeof(int) * (PPB + 1);  // vf, no_valid, any_valid
static_assert(THREADS / 32 * 16 == D, "matmul: eight warps of 16 columns");
static_assert(sizeof(float) * NBUF * PPB * MAXN * LDS + STATIC_SMEM <= SMEM_OPTIN,
              "MAXN nodes must fit one block's shared memory");
constexpr float NEG = -1e30f;
constexpr float LN_EPS = 1e-5f;

struct NodeWeights {
    const float *ln1_s, *ln1_b, *lnt_s, *lnt_b, *ln2_s, *ln2_b;
    const float *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo, *w1, *b1, *w2, *b2;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// out = LN(in) * s + b over the R rows; one warp per row
__device__ void layer_norm(const float* in, float* out, const float* s, const float* b, int R) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < R; r += THREADS / 32) {
        const float* row = in + r * LDS;
        float v[D / 32];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
            v[j] = row[lane + 32 * j];
            sum += v[j];
        }
        const float mu = warp_sum(sum) / D;
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
            v[j] -= mu;
            sq += v[j] * v[j];
        }
        const float rs = rsqrtf(warp_sum(sq) / D + LN_EPS);
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
            const int c = lane + 32 * j;
            out[r * LDS + c] = v[j] * rs * s[c] + b[c];
        }
    }
}

enum Epilogue { STORE, RELU, ATTN_RESIDUAL, FFN_RESIDUAL };

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& w) {
    acc[0] = fmaf(a, w.x, acc[0]);
    acc[1] = fmaf(a, w.y, acc[1]);
    acc[2] = fmaf(a, w.z, acc[2]);
    acc[3] = fmaf(a, w.w, acc[3]);
}

// out = in @ W (+ bias, epilogue E) over the block's R = PPB * N rows; W a
// [128, 128] row-major matrix in global memory (x @ W layout). Warp w owns
// columns 16w..16w+15, so the block reads W from L2 once; lane (rg, cg)
// holds a register tile of MAXRT rows (rg * rt ...) x 4 columns
// (16w + 4cg ...). Per 4-deep slice of k a thread loads four float4 of W
// (prefetched one slice ahead) and one float4 of each of its rows (at
// N = 20 the eight row groups of a warp hit distinct banks), then does 16
// FMAs a row.
template <Epilogue E>
__device__ void matmul(const float* in, const float* __restrict__ W, const float* __restrict__ bias,
                       float* out, int R, int N, const float* vf, const int* no_valid) {
    const int lane = threadIdx.x % 32;
    const int c0 = (threadIdx.x / 32) * 16 + (lane % 4) * 4;
    const int rt = (R + 7) / 8;
    const int r0 = (lane / 4) * rt;
    float acc[MAXRT][4];
#pragma unroll
    for (int i = 0; i < MAXRT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = __ldg(reinterpret_cast<const float4*>(W + u * D + c0));
    for (int k0 = 0; k0 < D; k0 += 4) {
        float4 wn[4];
        if (k0 + 4 < D) {
#pragma unroll
            for (int u = 0; u < 4; ++u) wn[u] = __ldg(reinterpret_cast<const float4*>(W + (k0 + 4 + u) * D + c0));
        }
#pragma unroll
        for (int i = 0; i < MAXRT; ++i) {
            if (i < rt && r0 + i < R) {
                const float4 a = *reinterpret_cast<const float4*>(in + (r0 + i) * LDS + k0);
                fma4(acc[i], a.x, w[0]);
                fma4(acc[i], a.y, w[1]);
                fma4(acc[i], a.z, w[2]);
                fma4(acc[i], a.w, w[3]);
            }
        }
        if (k0 + 4 < D) {
#pragma unroll
            for (int u = 0; u < 4; ++u) w[u] = wn[u];
        }
    }
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0));
    const float bc[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < MAXRT; ++i) {
        const int r = r0 + i;
        if (i >= rt || r >= R) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float* o = out + r * LDS + c0 + j;
            const float y = acc[i][j] + bc[j];
            if (E == STORE) *o = y;
            if (E == RELU) *o = fmaxf(y, 0.f);
            if (E == ATTN_RESIDUAL) *o = *o + (no_valid[r / N] ? 0.f : y);
            if (E == FFN_RESIDUAL) *o = vf[r] != 0.f ? *o + y : 0.f;
        }
    }
}

// a[row, head] = softmax(q_h k_hᵀ / sqrt(dh)) v_h within each polyline; one
// thread per (polyline, head, query node)
__device__ void node_attention(const float* q, const float* k, const float* v, float* a, int N,
                               int n_head, const float* vf, const int* no_valid) {
    const int dh = D / n_head;
    const float sqrt_dh = sqrtf((float)dh);
    const int n_work = PPB * n_head * N;
    for (int w = threadIdx.x; w < n_work; w += THREADS) {
        const int i = w % N;
        const int h = (w / N) % n_head;
        const int p = w / (N * n_head);
        const float* qi = q + (p * N + i) * LDS + h * dh;
        float sc[MAXN];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= N) break;
            const float* kj = k + (p * N + j) * LDS + h * dh;
            float s = 0.f;
            for (int d = 0; d < dh; ++d) s = fmaf(qi[d], kj[d], s);
            s = s / sqrt_dh;
            if (!no_valid[p] && vf[p * N + j] == 0.f) s = -INFINITY;
            sc[j] = s;
            m = fmaxf(m, s);
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= N) break;
            sc[j] = expf(sc[j] - m);
            sum += sc[j];
        }
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= N) break;
            sc[j] = sc[j] / sum;
        }
        float* ai = a + (p * N + i) * LDS + h * dh;
        for (int d = 0; d < dh; ++d) {
            float o = 0.f;
#pragma unroll
            for (int j = 0; j < MAXN; ++j) {
                if (j >= N) break;
                o = fmaf(sc[j], v[(p * N + j) * LDS + h * dh + d], o);
            }
            ai[d] = o;
        }
    }
}

__global__ void __launch_bounds__(THREADS)
node_kernel(const float* __restrict__ x_in, const uint8_t* __restrict__ valid, float* __restrict__ out,
            int BP, int N, int n_layer, int n_head, NodeWeights w) {
    extern __shared__ float4 smem4[];  // 16-byte aligned for the float4 row loads
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ float vf[PPB * MAXN];
    __shared__ int no_valid[PPB];
    __shared__ int any_valid;

    const int R = PPB * N;
    float* x = smem;
    float* x0 = x + R * LDS;
    float* t = x0 + R * LDS;
    float* q = t + R * LDS;
    float* k = q + R * LDS;
    float* v = k + R * LDS;
    float* a = v + R * LDS;

    const int poly0 = blockIdx.x * PPB;
    const int c = threadIdx.x % D;
    const int p = threadIdx.x / D;
    const int poly = poly0 + p;

    if (threadIdx.x == 0) any_valid = 0;
    if (threadIdx.x < PPB) no_valid[threadIdx.x] = 1;
    __syncthreads();
    for (int i = threadIdx.x; i < R; i += THREADS) {
        const int pp = i / N, nn = i % N;
        const bool ok = poly0 + pp < BP && valid[(long long)(poly0 + pp) * N + nn] != 0;
        vf[i] = ok ? 1.f : 0.f;
        if (ok) {
            no_valid[pp] = 0;
            any_valid = 1;
        }
    }
    __syncthreads();
    if (!any_valid) {  // all padding: the pool identity, as the TPU kernel's skip writes
        if (poly < BP) out[(long long)poly * D + c] = NEG;
        return;
    }
    for (int r = 0; r < N; ++r) {
        const float val = poly < BP ? x_in[((long long)poly * N + r) * D + c] : 0.f;
        x[(p * N + r) * LDS + c] = val;
        x0[(p * N + r) * LDS + c] = val;
    }
    __syncthreads();

    for (int l = 0; l < n_layer; ++l) {
        const int lv = l * D, lm = l * D * D;
        layer_norm(x0, t, w.lnt_s + lv, w.lnt_b + lv, R);
        __syncthreads();
        matmul<STORE>(t, w.wk + lm, w.bk + lv, k, R, N, vf, no_valid);
        matmul<STORE>(t, w.wv + lm, w.bv + lv, v, R, N, vf, no_valid);
        __syncthreads();
        layer_norm(x, t, w.ln1_s + lv, w.ln1_b + lv, R);
        __syncthreads();
        matmul<STORE>(t, w.wq + lm, w.bq + lv, q, R, N, vf, no_valid);
        __syncthreads();
        node_attention(q, k, v, a, N, n_head, vf, no_valid);
        __syncthreads();
        matmul<ATTN_RESIDUAL>(a, w.wo + lm, w.bo + lv, x, R, N, vf, no_valid);
        __syncthreads();
        layer_norm(x, t, w.ln2_s + lv, w.ln2_b + lv, R);
        __syncthreads();
        matmul<RELU>(t, w.w1 + lm, w.b1 + lv, a, R, N, vf, no_valid);
        __syncthreads();
        matmul<FFN_RESIDUAL>(a, w.w2 + lm, w.b2 + lv, x, R, N, vf, no_valid);
        __syncthreads();
    }

    if (poly < BP) {
        float m = NEG;
        for (int r = 0; r < N; ++r)
            m = fmaxf(m, vf[p * N + r] != 0.f ? x[(p * N + r) * LDS + c] : NEG);
        out[(long long)poly * D + c] = m;
    }
}

}  // namespace

// x [BP, N, 128] fp32, valid [BP, N] bool bytes, out [BP, 128] fp32; w is a
// host array of the 18 device pointers in the order ln1_s, ln1_b, lnt_s,
// lnt_b, ln2_s, ln2_b, wq, bq, wk, bk, wv, bv, wo, bo, w1, b1, w2, b2 (each
// stacked over layers, matrices [L, 128, 128] in x @ W layout). Returns the
// cudaError_t of the launch.
extern "C" int tb_node_encoder(const void* x, const void* valid, void* out, int BP, int N,
                               int n_layer, int n_head, const void* const* w, void* stream) {
    if (N < 1 || N > MAXN || D % n_head != 0) return (int)cudaErrorInvalidValue;
    const float* const* f = reinterpret_cast<const float* const*>(w);
    NodeWeights nw{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                   f[9], f[10], f[11], f[12], f[13], f[14], f[15], f[16], f[17]};
    const size_t smem = sizeof(float) * (size_t)NBUF * PPB * N * LDS;
    cudaError_t err = cudaFuncSetAttribute(node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (BP + PPB - 1) / PPB;
    node_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(valid), static_cast<float*>(out),
        BP, N, n_layer, n_head, nw);
    return (int)cudaGetLastError();
}

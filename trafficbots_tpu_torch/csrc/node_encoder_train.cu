// Training DenseTNT polyline-node encoder + masked max-pool with dropout,
// forward and hand-derived backward, for Hopper (sm_90a), plain C interface.
//
// Replaces: trafficbots_tpu/ops/node_encoder_train.py,
// node_encoder_train_pooled -> _fwd_kernel (_layer_fwd) and its custom VJP
// _vjp_bwd -> _bwd_kernel / _bwd_block. The function is K2's
// (csrc/node_encoder.cu) with inverted dropout at four sites a layer, from
// philox.cuh at site 4 l + k:
//   k = 0  the attention weights, logical [BP, H, N, N], row (p H + h) N + i
//   k = 1  the out-projection output (m1)    logical [BP, N, D], row p N + i
//   k = 2  the FFN hidden after the ReLU (m2), same rows
//   k = 3  the FFN output (m3), same rows
// Its backward (the formulas of node_encoder_train.py:27-30): LayerNorm,
// dense, softmax and dropout VJPs walked from layer L-1 down to 0, and a
// max-pool VJP that splits each column's cotangent evenly among the nodes
// tied at the max (JAX's reduce_max VJP).
//
// Design. One polyline a block (N <= 32 rows, d_model = d_ff = 128, 256
// threads): rows in shared [N, 132] fp32 buffers, the 128 x 128 weights read
// from L2 in K2's register-tiled products. The forward keeps x, x0 and five
// work buffers (74 KB at N = 20); an all-padding polyline writes -1e30 and
// returns. The backward keeps the per-layer inputs, recomputes one layer at
// a time (its q, k, v, attention weights, out-projection input, residual and
// FFN pre-activation) and walks down, as _bwd_block does: 11 + L buffers and
// two [H, N, N] attention arrays, 161 KB at N = 20, L = 3, H = 4.
// Weight gradients are sums over all polylines. The TPU revisits one output
// block in a sequential grid; here the backward runs a FIXED grid of
// NBLOCKS blocks, each walking polylines blockIdx.x, blockIdx.x + NBLOCKS,
// ... and adding into its own slice of a [NBLOCKS, n_params] partial buffer
// (each element owned by one thread, updated in polyline order), and a
// second kernel sums the slices in block order. No float atomics: dx and
// every dW are bitwise the same run to run. All-padding polylines contribute
// exactly 0 (their pooled cotangent is 0) and are skipped.
//
// What bounds it on the card: the fp32 operations. A valid node costs
// 12 D^2 = 197 kFLOP a layer forward (six 128 x 128 products); the backward
// recomputes the forward (twice for the layer inputs) and does twelve more
// products a node a layer (cotangents and weight gradients), ~4x the
// forward. The partial-slice updates read and write 2 x 400 KB of each
// block's slice per polyline (L2/HBM traffic of ~12 GB at 6k valid
// polylines). No tensor cores yet: fp32 parity with the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int D = 128;       // d_model == d_feedforward
constexpr int THREADS = 256;
constexpr int MAXN = 32;     // nodes a polyline (rows of a block)
constexpr int LDS = D + 4;   // padded row stride of the shared buffers
constexpr int MAXRT = (MAXN + 7) / 8;
constexpr int NBLOCKS = 132;  // the backward's fixed grid (one wave on an H100)
constexpr float NEG = -1e30f;
constexpr float LN_EPS = 1e-5f;
static_assert(THREADS / 32 * 16 == D, "matmul: eight warps of 16 columns");

using tb_philox::Dropout;

enum Name { LN1_S, LN1_B, LNT_S, LNT_B, LN2_S, LN2_B, WQ, BQ, WK, BK, WV, BV, WO, BO, W1, B1, W2, B2, N_NAMES };

__host__ __device__ constexpr bool is_matrix(int n) { return n == WQ || n == WK || n == WV || n == WO || n == W1 || n == W2; }

// Offset of parameter `name`, layer l, in the flat gradient vector (the
// 18 stacked arrays in W_NAMES order, each [L, ...]).
__host__ __device__ inline long long grad_off(int name, int l, int L) {
    long long o = 0;
    for (int i = 0; i < name; ++i) o += (long long)L * (is_matrix(i) ? D * D : D);
    return o + (long long)l * (is_matrix(name) ? D * D : D);
}

__host__ __device__ inline long long n_params(int L) { return grad_off(N_NAMES, 0, L); }

struct Weights {
    const float* p[N_NAMES];
    __device__ const float* at(int name, int l) const { return p[name] + (long long)l * (is_matrix(name) ? D * D : D); }
};

struct Ctx {
    int N, H;
    unsigned long long row0;  // poly * N: the block's first node row in the logical [BP, N, *] tensors
    unsigned long long poly;
    const float* vf;          // [N] 1 = valid node
    Dropout drop;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// out = LN(in) * s + b over the N rows; one warp a row (two-pass variance)
__device__ void layer_norm(const float* in, float* out, const float* __restrict__ s, const float* __restrict__ b,
                           int R) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < R; r += THREADS / 32) {
        float v[D / 32];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
            v[j] = in[r * LDS + lane + 32 * j];
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

// dx = LN backward of dy at x (scale s): recomputes mean and rstd per row;
// adds the scale and bias gradients to ds/db (partial slice, global).
__device__ void layer_norm_bwd(const float* dy, const float* x, const float* __restrict__ s, float* dx,
                               float* ds, float* db, int R, float* mu_s, float* rs_s) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < R; r += THREADS / 32) {
        float xh[D / 32], g[D / 32];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
            xh[j] = x[r * LDS + lane + 32 * j];
            sum += xh[j];
        }
        const float mu = warp_sum(sum) / D;
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
            xh[j] -= mu;
            sq += xh[j] * xh[j];
        }
        const float rs = rsqrtf(warp_sum(sq) / D + LN_EPS);
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
            const int c = lane + 32 * j;
            xh[j] = xh[j] * rs;
            g[j] = dy[r * LDS + c] * s[c];
            m1 += g[j];
            m2 += g[j] * xh[j];
        }
        m1 = warp_sum(m1) / D;
        m2 = warp_sum(m2) / D;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) dx[r * LDS + lane + 32 * j] = (g[j] - m1 - xh[j] * m2) * rs;
        if (lane == 0) {
            mu_s[r] = mu;
            rs_s[r] = rs;
        }
    }
    __syncthreads();
    if (threadIdx.x < D) {
        const int c = threadIdx.x;
        float a = 0.f, bb = 0.f;
        for (int r = 0; r < R; ++r) {
            const float d = dy[r * LDS + c];
            a += d * ((x[r * LDS + c] - mu_s[r]) * rs_s[r]);
            bb += d;
        }
        ds[c] += a;
        db[c] += bb;
    }
}

enum Epilogue { STORE, RELU_DROP, ATTN_RESIDUAL, FFN_RESIDUAL, ACC };

// out = in @ W (TRANS: in @ Wᵀ) over the N rows, W a [128, 128] row-major
// matrix in global memory, then the epilogue E on y = product (+ bias):
//   STORE y;  RELU_DROP relu(y) m2;  ATTN_RESIDUAL res + y m1;
//   FFN_RESIDUAL valid ? res + y m3 : 0;  ACC out + y
// Warp w owns columns 16 w .. 16 w + 15 (W read once a block, from L2);
// lane (rg, cg) a register tile of rows rg * rt .. and 4 columns.
template <Epilogue E, bool TRANS>
__device__ void matmul(const float* in, const float* __restrict__ W, const float* __restrict__ bias, float* out,
                       const float* res, const Ctx& cx, int site) {
    const int R = cx.N;
    const int lane = threadIdx.x % 32;
    const int c0 = (threadIdx.x / 32) * 16 + (lane % 4) * 4;
    const int rt = (R + 7) / 8;
    const int r0 = (lane / 4) * rt;
    float acc[MAXRT][4];
#pragma unroll
    for (int i = 0; i < MAXRT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += 4) {
        float4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            w[u] = __ldg(reinterpret_cast<const float4*>(TRANS ? W + (c0 + u) * D + k0 : W + (k0 + u) * D + c0));
#pragma unroll
        for (int i = 0; i < MAXRT; ++i) {
            if (i < rt && r0 + i < R) {
                const float4 a = *reinterpret_cast<const float4*>(in + (r0 + i) * LDS + k0);
                if (TRANS) {
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        float t = acc[i][u];
                        t = fmaf(a.x, w[u].x, t);
                        t = fmaf(a.y, w[u].y, t);
                        t = fmaf(a.z, w[u].z, t);
                        acc[i][u] = fmaf(a.w, w[u].w, t);
                    }
                } else {
                    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        acc[i][0] = fmaf(av[kk], w[kk].x, acc[i][0]);
                        acc[i][1] = fmaf(av[kk], w[kk].y, acc[i][1]);
                        acc[i][2] = fmaf(av[kk], w[kk].z, acc[i][2]);
                        acc[i][3] = fmaf(av[kk], w[kk].w, acc[i][3]);
                    }
                }
            }
        }
    }
    float bc[4] = {0.f, 0.f, 0.f, 0.f};
    if (bias != nullptr) {
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0));
        bc[0] = b4.x, bc[1] = b4.y, bc[2] = b4.z, bc[3] = b4.w;
    }
#pragma unroll
    for (int i = 0; i < MAXRT; ++i) {
        const int r = r0 + i;
        if (i >= rt || r >= R) break;
        float f[4] = {1.f, 1.f, 1.f, 1.f};
        if (E == RELU_DROP || E == ATTN_RESIDUAL || E == FFN_RESIDUAL)
            tb_philox::factors4(cx.drop, site, cx.row0 + r, (uint32_t)(c0 / 4), f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float* o = out + r * LDS + c0 + j;
            const float y = acc[i][j] + bc[j];
            if (E == STORE) *o = y;
            if (E == RELU_DROP) *o = fmaxf(y, 0.f) * f[j];
            if (E == ATTN_RESIDUAL) *o = res[r * LDS + c0 + j] + y * f[j];
            if (E == FFN_RESIDUAL) *o = cx.vf[r] != 0.f ? res[r * LDS + c0 + j] + y * f[j] : 0.f;
            if (E == ACC) *o = *o + y;
        }
    }
}

// a[i, head h] = (softmax_j(q_h[i] . k_h[j] / sqrt(dh), padded j masked) ⊙ M0) v_h;
// one thread a (head, query node). P (optional) receives the weights
// before dropout, P[(h N + i) N + j].
__device__ void attention_fwd(const float* q, const float* k, const float* v, float* a, float* P, const Ctx& cx,
                              int site) {
    const int N = cx.N, H = cx.H, dh = D / H;
    const float sqrt_dh = sqrtf((float)dh);
    for (int w = threadIdx.x; w < H * N; w += THREADS) {
        const int i = w % N, h = w / N;
        const float* qi = q + i * LDS + h * dh;
        float sc[MAXN];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= N) break;
            const float* kj = k + j * LDS + h * dh;
            float s = 0.f;
            for (int d = 0; d < dh; ++d) s = fmaf(qi[d], kj[d], s);
            s = cx.vf[j] == 0.f ? -INFINITY : s / sqrt_dh;
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
            if (P != nullptr) P[(h * N + i) * N + j] = sc[j];
        }
        if (cx.drop.on) {
            const unsigned long long row = (cx.poly * H + h) * N + i;
#pragma unroll
            for (int j4 = 0; j4 < MAXN / 4; ++j4) {
                if (4 * j4 >= N) break;
                float f[4];
                tb_philox::factors4(cx.drop, site, row, (uint32_t)j4, f);
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (4 * j4 + u < N) sc[4 * j4 + u] *= f[u];
            }
        }
        float* ai = a + i * LDS + h * dh;
        for (int d = 0; d < dh; ++d) {
            float o = 0.f;
#pragma unroll
            for (int j = 0; j < MAXN; ++j) {
                if (j >= N) break;
                o = fmaf(sc[j], v[j * LDS + h * dh + d], o);
            }
            ai[d] = o;
        }
    }
}

// The attention half of layer l: k, v from LN_tgt(x0); q from LN1(xl);
// x1 = xl + (attention out-projection) ⊙ M1 (x1 may be xl). `t` is scratch.
__device__ void attn_half(int l, const float* xl, const float* x0, float* t, float* q, float* k, float* v,
                          float* a, float* x1, float* P, const Weights& w, const Ctx& cx) {
    const int R = cx.N;
    layer_norm(x0, t, w.at(LNT_S, l), w.at(LNT_B, l), R);
    __syncthreads();
    matmul<STORE, false>(t, w.at(WK, l), w.at(BK, l), k, nullptr, cx, 0);
    matmul<STORE, false>(t, w.at(WV, l), w.at(BV, l), v, nullptr, cx, 0);
    __syncthreads();
    layer_norm(xl, t, w.at(LN1_S, l), w.at(LN1_B, l), R);
    __syncthreads();
    matmul<STORE, false>(t, w.at(WQ, l), w.at(BQ, l), q, nullptr, cx, 0);
    __syncthreads();
    attention_fwd(q, k, v, a, P, cx, 4 * l);
    __syncthreads();
    matmul<ATTN_RESIDUAL, false>(a, w.at(WO, l), w.at(BO, l), x1, xl, cx, 4 * l + 1);
    __syncthreads();
}

// The FFN half of layer l: out = valid ? x1 + (relu(LN2(x1) W1 + b1) ⊙ M2) W2 ⊙ M3 : 0
// (out may be x1). `t` and `hbuf` are scratch.
__device__ void ffn_half(int l, const float* x1, float* t, float* hbuf, float* out, const Weights& w, const Ctx& cx) {
    layer_norm(x1, t, w.at(LN2_S, l), w.at(LN2_B, l), cx.N);
    __syncthreads();
    matmul<RELU_DROP, false>(t, w.at(W1, l), w.at(B1, l), hbuf, nullptr, cx, 4 * l + 2);
    __syncthreads();
    matmul<FFN_RESIDUAL, false>(hbuf, w.at(W2, l), w.at(B2, l), out, x1, cx, 4 * l + 3);
    __syncthreads();
}

// Loads the polyline's validity; returns whether it has a valid node.
__device__ bool load_valid(const uint8_t* __restrict__ valid, long long poly, int N, float* vf, int* any) {
    if (threadIdx.x == 0) *any = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += THREADS) {
        const bool ok = valid[poly * N + i] != 0;
        vf[i] = ok ? 1.f : 0.f;
        if (ok) *any = 1;
    }
    __syncthreads();
    return *any != 0;
}

__device__ void load_rows(const float* __restrict__ x, long long poly, int N, float* dst) {
    for (int i = threadIdx.x; i < N * D; i += THREADS) dst[(i / D) * LDS + i % D] = x[poly * N * D + i];
}

__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ x_in, const uint8_t* __restrict__ valid, float* __restrict__ out, int N,
           int L, int H, Weights w, Dropout drop) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ float vf[MAXN];
    __shared__ int any;
    const long long poly = blockIdx.x;
    float* x = smem;
    float* x0 = x + N * LDS;
    float* t = x0 + N * LDS;
    float* q = t + N * LDS;
    float* k = q + N * LDS;
    float* v = k + N * LDS;
    float* a = v + N * LDS;
    if (!load_valid(valid, poly, N, vf, &any)) {  // all padding: the pool identity
        if (threadIdx.x < D) out[poly * D + threadIdx.x] = NEG;
        return;
    }
    const Ctx cx{N, H, (unsigned long long)poly * N, (unsigned long long)poly, vf, drop};
    load_rows(x_in, poly, N, x);
    load_rows(x_in, poly, N, x0);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
        attn_half(l, x, x0, t, q, k, v, a, x, nullptr, w, cx);
        ffn_half(l, x, t, a, x, w, cx);
    }
    if (threadIdx.x < D) {
        const int c = threadIdx.x;
        float m = NEG;
        for (int r = 0; r < N; ++r) m = fmaxf(m, vf[r] != 0.f ? x[r * LDS + c] : NEG);
        out[poly * D + c] = m;
    }
}

// dW += Aᵀ B over the N rows (A, B [N, 128] shared; dW a [128, 128] slice
// in global memory): thread (ti, tj) owns the 8 x 8 tile at (8 ti, 8 tj).
__device__ void wgrad(const float* A, const float* B, float* dW, int R) {
    const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < R; ++r) {
        const float4 a0 = *reinterpret_cast<const float4*>(A + r * LDS + 8 * ti);
        const float4 a1 = *reinterpret_cast<const float4*>(A + r * LDS + 8 * ti + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(B + r * LDS + 8 * tj);
        const float4 b1 = *reinterpret_cast<const float4*>(B + r * LDS + 8 * tj + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float4* row = reinterpret_cast<float4*>(dW + (8 * ti + i) * D + 8 * tj);
        float4 u = row[0], v = row[1];
        u.x += acc[i][0], u.y += acc[i][1], u.z += acc[i][2], u.w += acc[i][3];
        v.x += acc[i][4], v.y += acc[i][5], v.z += acc[i][6], v.w += acc[i][7];
        row[0] = u;
        row[1] = v;
    }
}

// db += column sums of A over the N rows
__device__ void vgrad(const float* A, float* db, int R) {
    if (threadIdx.x < D) {
        float s = 0.f;
        for (int r = 0; r < R; ++r) s += A[r * LDS + threadIdx.x];
        db[threadIdx.x] += s;
    }
}

// Attention backward of one layer: dcat -> dq, dk, dv (dq, dk scaled by
// 1/sqrt(dh) as the logits are). P holds the weights before dropout (it is
// overwritten by dS); PM receives the dropped weights.
__device__ void attention_bwd(const float* dcat, const float* q, const float* k, const float* v, float* P, float* PM,
                              float* dq, float* dk, float* dv, const Ctx& cx, int site) {
    const int N = cx.N, H = cx.H, dh = D / H;
    const float sqrt_dh = sqrtf((float)dh);
    for (int w = threadIdx.x; w < H * N; w += THREADS) {
        const int i = w % N, h = w / N;
        float* pr = P + (h * N + i) * N;
        float* pmr = PM + (h * N + i) * N;
        const float* gi = dcat + i * LDS + h * dh;
        const unsigned long long row = (cx.poly * H + h) * N + i;
        float dA[MAXN];
        float rsum = 0.f;
#pragma unroll
        for (int j4 = 0; j4 < MAXN / 4; ++j4) {
            if (4 * j4 >= N) break;
            float f[4];
            tb_philox::factors4(cx.drop, site, row, (uint32_t)j4, f);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = 4 * j4 + u;
                if (j < N) {
                    const float* vj = v + j * LDS + h * dh;
                    float s = 0.f;
                    for (int d = 0; d < dh; ++d) s = fmaf(gi[d], vj[d], s);
                    dA[j] = s * f[u];
                    pmr[j] = pr[j] * f[u];
                    rsum += dA[j] * pr[j];
                }
            }
        }
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= N) break;
            pr[j] = pr[j] * (dA[j] - rsum);
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < N * D; e += THREADS) {
        const int r = e / D, c = e % D, h = c / dh;
        const float* ds = P + h * N * N;
        const float* pm = PM + h * N * N;
        float aq = 0.f, ak = 0.f, av = 0.f;
        for (int j = 0; j < N; ++j) {
            aq = fmaf(ds[r * N + j], k[j * LDS + c], aq);
            ak = fmaf(ds[j * N + r], q[j * LDS + c], ak);
            av = fmaf(pm[j * N + r], dcat[j * LDS + c], av);
        }
        dq[r * LDS + c] = aq / sqrt_dh;
        dk[r * LDS + c] = ak / sqrt_dh;
        dv[r * LDS + c] = av;
    }
}

__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ x_in, const uint8_t* __restrict__ valid, const float* __restrict__ g_pool,
           float* __restrict__ dx_out, float* __restrict__ part, int BP, int N, int L, int H, Weights w,
           Dropout drop) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ float vf[MAXN], mu_s[MAXN], rs_s[MAXN];
    __shared__ int any;
    const int NL = N * LDS;
    float* X0 = smem;
    float* XIN = X0 + NL;             // layer inputs 1 .. L-1
    float* G = XIN + (L - 1) * NL;    // cotangent of the current layer's output
    float* DX0 = G + NL;              // cotangent of x0 through the K/V side
    float* Q = DX0 + NL;
    float* K = Q + NL;
    float* V = K + NL;
    float* CAT = V + NL;
    float* X1 = CAT + NL;
    float* Z1 = X1 + NL;
    float* S1 = Z1 + NL;
    float* S2 = S1 + NL;
    float* S3 = S2 + NL;
    float* P = S3 + NL;               // [H, N, N]
    float* PM = P + H * N * N;        // [H, N, N]
    float* slice = part + (long long)blockIdx.x * n_params(L);
    auto gp = [&](int name, int l) { return slice + grad_off(name, l, L); };

    for (long long poly = blockIdx.x; poly < BP; poly += gridDim.x) {
        if (!load_valid(valid, poly, N, vf, &any)) {  // no valid node: zero cotangent, dx = 0
            for (int i = threadIdx.x; i < N * D; i += THREADS) dx_out[poly * N * D + i] = 0.f;
            continue;
        }
        const Ctx cx{N, H, (unsigned long long)poly * N, (unsigned long long)poly, vf, drop};
        load_rows(x_in, poly, N, X0);
        __syncthreads();
        // forward to the layer inputs and the output (into G)
        for (int l = 0; l < L; ++l) {
            const float* xl = l == 0 ? X0 : XIN + (l - 1) * NL;
            attn_half(l, xl, X0, S1, Q, K, V, CAT, X1, nullptr, w, cx);
            ffn_half(l, X1, S1, S2, l + 1 < L ? XIN + l * NL : G, w, cx);
        }
        // max-pool backward: each column's cotangent split among its tied maxima
        if (threadIdx.x < D) {
            const int c = threadIdx.x;
            float m = NEG;
            for (int r = 0; r < N; ++r) m = fmaxf(m, vf[r] != 0.f ? G[r * LDS + c] : NEG);
            float cnt = 0.f;
            for (int r = 0; r < N; ++r) cnt += (vf[r] != 0.f ? G[r * LDS + c] : NEG) == m ? 1.f : 0.f;
            const float gc = g_pool[poly * D + c] / fmaxf(cnt, 1.f);
            for (int r = 0; r < N; ++r) {
                const bool top = (vf[r] != 0.f ? G[r * LDS + c] : NEG) == m;
                G[r * LDS + c] = top ? gc : 0.f;
            }
        }
        for (int i = threadIdx.x; i < N * D; i += THREADS) DX0[(i / D) * LDS + i % D] = 0.f;
        __syncthreads();

        for (int l = L - 1; l >= 0; --l) {
            const float* xl = l == 0 ? X0 : XIN + (l - 1) * NL;
            // recompute the layer, keeping q, k, v, P, the attention output,
            // x1 and the FFN pre-activation
            attn_half(l, xl, X0, S1, Q, K, V, CAT, X1, P, w, cx);
            layer_norm(X1, S1, w.at(LN2_S, l), w.at(LN2_B, l), N);
            __syncthreads();
            matmul<STORE, false>(S1, w.at(W1, l), w.at(B1, l), Z1, nullptr, cx, 0);
            __syncthreads();
            // g2 = g * valid;  df = g2 M3;  fdo = relu(z1) M2
            for (int e = threadIdx.x; e < N * (D / 4); e += THREADS) {
                const int r = e / (D / 4), c0 = 4 * (e % (D / 4));
                float f3[4], f2[4];
                tb_philox::factors4(drop, 4 * l + 3, cx.row0 + r, (uint32_t)(c0 / 4), f3);
                tb_philox::factors4(drop, 4 * l + 2, cx.row0 + r, (uint32_t)(c0 / 4), f2);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int i = r * LDS + c0 + u;
                    const float g2 = vf[r] != 0.f ? G[i] : 0.f;
                    G[i] = g2;
                    S2[i] = g2 * f3[u];
                    S3[i] = fmaxf(Z1[i], 0.f) * f2[u];
                }
            }
            __syncthreads();
            wgrad(S3, S2, gp(W2, l), N);
            vgrad(S2, gp(B2, l), N);
            __syncthreads();
            matmul<STORE, true>(S2, w.at(W2, l), nullptr, S3, nullptr, cx, 0);  // dfdo
            __syncthreads();
            for (int e = threadIdx.x; e < N * (D / 4); e += THREADS) {  // dz1 = dfdo M2 (z1 > 0)
                const int r = e / (D / 4), c0 = 4 * (e % (D / 4));
                float f2[4];
                tb_philox::factors4(drop, 4 * l + 2, cx.row0 + r, (uint32_t)(c0 / 4), f2);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int i = r * LDS + c0 + u;
                    S3[i] = Z1[i] > 0.f ? S3[i] * f2[u] : 0.f;
                }
            }
            layer_norm(X1, S1, w.at(LN2_S, l), w.at(LN2_B, l), N);  // src2b
            __syncthreads();
            wgrad(S1, S3, gp(W1, l), N);
            vgrad(S3, gp(B1, l), N);
            __syncthreads();
            matmul<STORE, true>(S3, w.at(W1, l), nullptr, S2, nullptr, cx, 0);  // dsrc2b
            __syncthreads();
            layer_norm_bwd(S2, X1, w.at(LN2_S, l), S1, gp(LN2_S, l), gp(LN2_B, l), N, mu_s, rs_s);
            __syncthreads();
            // dx1 = g2 + dx1_ln;  da = dx1 M1
            for (int e = threadIdx.x; e < N * (D / 4); e += THREADS) {
                const int r = e / (D / 4), c0 = 4 * (e % (D / 4));
                float f1[4];
                tb_philox::factors4(drop, 4 * l + 1, cx.row0 + r, (uint32_t)(c0 / 4), f1);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int i = r * LDS + c0 + u;
                    G[i] = G[i] + S1[i];
                    S2[i] = G[i] * f1[u];
                }
            }
            __syncthreads();
            wgrad(CAT, S2, gp(WO, l), N);
            vgrad(S2, gp(BO, l), N);
            __syncthreads();
            matmul<STORE, true>(S2, w.at(WO, l), nullptr, S3, nullptr, cx, 0);  // dcat
            __syncthreads();
            attention_bwd(S3, Q, K, V, P, PM, S1, S2, CAT, cx, 4 * l);  // dq, dk, dv
            layer_norm(xl, X1, w.at(LN1_S, l), w.at(LN1_B, l), N);  // src2
            layer_norm(X0, Z1, w.at(LNT_S, l), w.at(LNT_B, l), N);  // tgtn
            __syncthreads();
            wgrad(X1, S1, gp(WQ, l), N);
            vgrad(S1, gp(BQ, l), N);
            __syncthreads();
            wgrad(Z1, S2, gp(WK, l), N);
            vgrad(S2, gp(BK, l), N);
            __syncthreads();
            wgrad(Z1, CAT, gp(WV, l), N);
            vgrad(CAT, gp(BV, l), N);
            __syncthreads();
            matmul<STORE, true>(S1, w.at(WQ, l), nullptr, S3, nullptr, cx, 0);  // dsrc2
            matmul<STORE, true>(S2, w.at(WK, l), nullptr, X1, nullptr, cx, 0);  // dtgtn ...
            __syncthreads();
            matmul<ACC, true>(CAT, w.at(WV, l), nullptr, X1, nullptr, cx, 0);  // ... + dv Wvᵀ
            __syncthreads();
            layer_norm_bwd(S3, xl, w.at(LN1_S, l), Q, gp(LN1_S, l), gp(LN1_B, l), N, mu_s, rs_s);
            __syncthreads();
            layer_norm_bwd(X1, X0, w.at(LNT_S, l), K, gp(LNT_S, l), gp(LNT_B, l), N, mu_s, rs_s);
            __syncthreads();
            for (int e = threadIdx.x; e < N * D; e += THREADS) {  // g = dx1 + dx_ln;  dx0 += dx0_ln
                const int i = (e / D) * LDS + e % D;
                G[i] = G[i] + Q[i];
                DX0[i] = DX0[i] + K[i];
            }
            __syncthreads();
        }
        for (int e = threadIdx.x; e < N * D; e += THREADS) {
            const int i = (e / D) * LDS + e % D;
            dx_out[poly * N * D + e] = G[i] + DX0[i];
        }
        __syncthreads();
    }
}

// dw[i] = sum over blocks b (in order) of part[b, i]
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, long long n, int nb) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int b = 0; b < nb; ++b) s += part[(long long)b * n + i];
        dw[i] = s;
    }
}

Weights weights(const void* const* w) {
    Weights ws;
    for (int i = 0; i < N_NAMES; ++i) ws.p[i] = static_cast<const float*>(w[i]);
    return ws;
}

size_t fwd_smem(int N) { return sizeof(float) * 7 * (size_t)N * LDS; }
size_t bwd_smem(int N, int L, int H) { return sizeof(float) * ((size_t)(11 + L) * N * LDS + 2 * (size_t)H * N * N); }

}  // namespace

// The backward's fixed grid: the rows of the partial buffer it takes.
extern "C" int tb_node_encoder_train_nblocks() { return NBLOCKS; }

// x [BP, N, 128] fp32, valid [BP, N] bool bytes, out [BP, 128] fp32; w the
// 18 device pointers in W_NAMES order (stacked over layers, matrices
// [L, 128, 128] in x @ W layout). Returns the cudaError_t of the launch.
extern "C" int tb_node_encoder_train_fwd(const void* x, const void* valid, void* out, int BP, int N, int L, int H,
                                         const void* const* w, unsigned long long seed, unsigned int threshold,
                                         float scale, int on, void* stream) {
    if (N < 1 || N > MAXN || L < 1 || D % H != 0) return (int)cudaErrorInvalidValue;
    const size_t smem = fwd_smem(N);
    cudaError_t err = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fwd_kernel<<<BP, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(valid), static_cast<float*>(out), N, L, H,
        weights(w), Dropout{seed, threshold, scale, on});
    return (int)cudaGetLastError();
}

// The backward: g [BP, 128] -> dx [BP, N, 128] and dw, the flat gradient of
// the 18 arrays (n_params(L) floats, W_NAMES order). part is scratch of
// NBLOCKS x n_params(L) floats, zeroed by the caller.
extern "C" int tb_node_encoder_train_bwd(const void* x, const void* valid, const void* g, void* dx, void* part,
                                         void* dw, int BP, int N, int L, int H, const void* const* w,
                                         unsigned long long seed, unsigned int threshold, float scale, int on,
                                         void* stream) {
    if (N < 1 || N > MAXN || L < 1 || D % H != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = bwd_smem(N, L, H);
    cudaError_t err = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    bwd_kernel<<<NBLOCKS, THREADS, smem, st>>>(static_cast<const float*>(x), static_cast<const uint8_t*>(valid),
                                               static_cast<const float*>(g), static_cast<float*>(dx),
                                               static_cast<float*>(part), BP, N, L, H, weights(w),
                                               Dropout{seed, threshold, scale, on});
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = n_params(L);
    reduce_kernel<<<(int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024), 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(dw), n, NBLOCKS);
    return (int)cudaGetLastError();
}

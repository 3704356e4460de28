// Training masked multi-head attention core with attention-weight dropout,
// forward and backward, for Hopper (sm_90a), plain C interface.
//
// Replaces: trafficbots_tpu/ops/attention_train.py, fused_attention_train
// (forward: _fwd_kernel / _fwd_kernel_qb) and its custom VJP _vjp_bwd
// (_bwd_kernel / _bwd_kernel_qb). Same function, per head h:
//   A = softmax(q_h k_hᵀ / sqrt(dh), masked);  out_h = (A ⊙ M) v_h
// with M the inverted-dropout mask of the weights (philox.cuh; logical
// tensor [B, H, S, T], row (b H + h) S + s, col t). A row whose targets are
// all masked comes out 0 and gets no gradient (the TPU kernel lifts the mask
// and zeroes the output and the cotangent: the same zeros).
//
// Backward, per head (the formulas of attention_train.py:30-36):
//   dv = (A ⊙ M)ᵀ g;  dA = (g vᵀ) ⊙ M;  dZ = A ⊙ (dA - D_s)
//   dq = dZ k / sqrt(dh);  dk = dZᵀ q / sqrt(dh)
// where D_s = rowsum(dA ⊙ A) = g_s · out_s is read from the forward's output
// rather than from an [S, T] buffer. The forward saves each row's softmax
// max and sum ([B, H, S] fp32), so the backward rebuilds A exactly (same
// logits, same expf, same division) without a max/sum pass.
//
// Grid on Hopper. The TPU query-blocked backward sums dk/dv across query
// blocks in a sequential grid; here blocks run in no order, so the backward
// is two kernels with no float atomics: a dq kernel over (16 query rows,
// head, scene), and a dk/dv kernel over (64 keys, head, scene) whose block
// loops over all query rows in order. Every output element is summed by one
// thread in a fixed order, so dq, dk and dv are bitwise the same run to run.
//
// What bounds it on the card: at the rollout's as2pl (B = 8, S = 64,
// T = 1024, fp32 K/V, 4 heads of 32) a call moves q, out, K, V and the [T]
// padding mask (~4.4 MB) for 4 x 64 x 1024 x 128 FLOP a scene (33.5 MFLOP
// x 8): the fp32 operations (67 TFLOP/s) bound it, 4 us against 1.3 us for
// the bytes. The backward does 2.5x the forward's operations. This first
// design keeps the [16, T] logits of a query block in shared memory (the K1
// design: 64 KB a row block at T = 1024, plus an [16, T] buffer for dA in
// the dq kernel) and streams K and V through 64-key fp32 tiles; no tensor
// cores yet (fp32 parity). The dropout bits cost one Philox call for four
// weights, in a separate pass over the row block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int ROWS = 16;      // query rows per block (forward, dq)
constexpr int TK = 64;        // keys per staged K/V tile
constexpr int THREADS = 256;  // = TK x (ROWS / 4)

using tb_philox::Dropout;

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

struct Shape {
    int B, S, T, D, H;
    long long inv_sb, inv_ss;
};

__device__ __forceinline__ bool masked(const uint8_t* inv, const Shape& sh, int b, int s, int t) {
    return inv[b * sh.inv_sb + (long long)s * sh.inv_ss + t] != 0;
}

// Stage rows t0 .. t0 + TK - 1 of one head's columns of src ([B, T, D]) into
// tile[TK][DH + 1] (zeros past T).
template <int DH>
__device__ void stage(float* tile, const float* __restrict__ src, long long base, int t0, int T, int D) {
    for (int i = threadIdx.x; i < TK * DH; i += THREADS) {
        const int tt = i / DH, d = i % DH;
        const int t = t0 + tt;
        tile[tt * (DH + 1) + d] = t < T ? src[base + (long long)t * D + d] : 0.f;
    }
}

// lr[r][t] = rows' (r < rows) dots a_r . k_t over the whole target row,
// one key and four rows a thread (the K1 mapping). LOGITS: divided by
// sqrt(dh), masked entries -inf; else the raw dots (inv unused).
template <int DH, bool LOGITS>
__device__ void scores(float* lr, int t_pad, const float* qs, float* kv, const float* __restrict__ k,
                       long long kv_base, const uint8_t* inv, const Shape& sh, int b, int s0, int rows) {
    const float sqrt_dh = sqrtf((float)DH);
    const int kt = threadIdx.x % TK;
    const int rg = threadIdx.x / TK;
    for (int t0 = 0; t0 < sh.T; t0 += TK) {
        __syncthreads();
        stage<DH>(kv, k, kv_base, t0, sh.T, sh.D);
        __syncthreads();
        const int t = t0 + kt;
        if (t < sh.T) {
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
                    if (LOGITS)
                        lr[r * t_pad + t] = masked(inv, sh, b, s0 + r, t) ? -INFINITY : acc[j] / sqrt_dh;
                    else
                        lr[r * t_pad + t] = acc[j];
                }
            }
        }
    }
    __syncthreads();
}

// out[r][d] = sum_t w[r][t] src[t][d] over the row block (the K1 AV phase);
// returns the thread's NR accumulators for rows r0 + j * RSTEP, column d.
template <int DH>
__device__ void weighted_sum(float (&acc)[ROWS / (THREADS / DH)], const float* w, int t_pad, float* kv,
                             const float* __restrict__ src, long long kv_base, int T, int D) {
    constexpr int RSTEP = THREADS / DH;
    constexpr int NR = ROWS / RSTEP;
    const int d = threadIdx.x % DH;
    const int r0 = threadIdx.x / DH;
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j] = 0.f;
    for (int t0 = 0; t0 < T; t0 += TK) {
        __syncthreads();
        stage<DH>(kv, src, kv_base, t0, T, D);
        __syncthreads();
        const int tn = min(TK, T - t0);
        for (int tt = 0; tt < tn; ++tt) {
            const float vd = kv[tt * (DH + 1) + d];
#pragma unroll
            for (int j = 0; j < NR; ++j) acc[j] = fmaf(w[(r0 + j * RSTEP) * t_pad + t0 + tt], vd, acc[j]);
        }
    }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const uint8_t* __restrict__ inv, float* __restrict__ out, float* __restrict__ rmax,
           float* __restrict__ rsum, Shape sh, Dropout drop, uint32_t site) {
    extern __shared__ float smem[];
    __shared__ int row_dead[ROWS];
    const int t_pad = (sh.T + 3) & ~3;
    float* lr = smem;                  // [ROWS][t_pad]: logits, then weights
    float* qs = lr + ROWS * t_pad;     // [ROWS][DH]
    float* kv = qs + ROWS * DH;        // [TK][DH + 1]
    const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * ROWS;
    const int rows = min(ROWS, sh.S - s0);
    const long long kv_base = (long long)b * sh.T * sh.D + h * DH;
    const long long stat0 = ((long long)b * sh.H + h) * sh.S + s0;

    for (int i = threadIdx.x; i < ROWS * DH; i += THREADS) {
        const int r = i / DH, d = i % DH;
        qs[i] = r < rows ? q[((long long)b * sh.S + s0 + r) * sh.D + h * DH + d] : 0.f;
    }
    scores<DH, true>(lr, t_pad, qs, kv, k, kv_base, inv, sh, b, s0, rows);

    // softmax: one warp a row, exact max over the whole row, exp and sum,
    // then the division (same order as torch.softmax and K1)
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < ROWS; r += THREADS / 32) {
        if (r >= rows) {
            if (lane == 0) row_dead[r] = 1;
            continue;
        }
        float* row = lr + r * t_pad;
        float m = -INFINITY;
        for (int t = lane; t < sh.T; t += 32) m = fmaxf(m, row[t]);
        m = warp_max(m);
        if (m == -INFINITY) {  // every target masked: the row's output is 0
            if (lane == 0) {
                row_dead[r] = 1;
                rmax[stat0 + r] = -INFINITY;
                rsum[stat0 + r] = 0.f;
            }
            continue;
        }
        float sum = 0.f;
        for (int t = lane; t < sh.T; t += 32) {
            const float e = expf(row[t] - m);
            row[t] = e;
            sum += e;
        }
        sum = warp_sum(sum);
        for (int t = lane; t < sh.T; t += 32) row[t] = row[t] / sum;
        if (lane == 0) {
            row_dead[r] = 0;
            rmax[stat0 + r] = m;
            rsum[stat0 + r] = sum;
        }
    }
    __syncthreads();
    if (drop.on) {  // weights *= M, four weights a Philox call
        const int c4n = t_pad / 4;
        for (int i = threadIdx.x; i < rows * c4n; i += THREADS) {
            const int r = i / c4n, c4 = i % c4n;
            float f[4];
            tb_philox::factors4(drop, site, (unsigned long long)(stat0 + r), (uint32_t)c4, f);
#pragma unroll
            for (int j = 0; j < 4; ++j) lr[r * t_pad + 4 * c4 + j] *= f[j];
        }
    }

    constexpr int RSTEP = THREADS / DH;
    constexpr int NR = ROWS / RSTEP;
    float acc[NR];
    weighted_sum<DH>(acc, lr, t_pad, kv, v, kv_base, sh.T, sh.D);
    const int d = threadIdx.x % DH, r0 = threadIdx.x / DH;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
        const int r = r0 + j * RSTEP;
        if (r < rows) out[((long long)b * sh.S + s0 + r) * sh.D + h * DH + d] = row_dead[r] ? 0.f : acc[j];
    }
}

// D_s = g_s . out_s of the block's rows (one warp a row), 0 for a dead row.
template <int DH>
__device__ void row_dots(float* di, const float* __restrict__ g, const float* __restrict__ out, const Shape& sh,
                         int b, int h, int s0, int nrows, const int* dead) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < nrows; r += THREADS / 32) {
        float acc = 0.f;
        if (s0 + r < sh.S && !dead[r]) {
            const long long base = ((long long)b * sh.S + s0 + r) * sh.D + h * DH;
            for (int d = lane; d < DH; d += 32) acc += g[base + d] * out[base + d];
        }
        acc = warp_sum(acc);
        if (lane == 0) di[r] = acc;
    }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const uint8_t* __restrict__ inv, const float* __restrict__ out, const float* __restrict__ rmax,
              const float* __restrict__ rsum, const float* __restrict__ g, float* __restrict__ dq, Shape sh,
              Dropout drop, uint32_t site) {
    extern __shared__ float smem[];
    __shared__ float m_s[ROWS], l_s[ROWS], di[ROWS];
    __shared__ int dead[ROWS];
    const int t_pad = (sh.T + 3) & ~3;
    float* pz = smem;                  // [ROWS][t_pad]: A, then dZ
    float* da = pz + ROWS * t_pad;     // [ROWS][t_pad]: g . v
    float* qs = da + ROWS * t_pad;     // [ROWS][DH]: q, then g
    float* kv = qs + ROWS * DH;        // [TK][DH + 1]
    const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * ROWS;
    const int rows = min(ROWS, sh.S - s0);
    const long long kv_base = (long long)b * sh.T * sh.D + h * DH;
    const long long stat0 = ((long long)b * sh.H + h) * sh.S + s0;
    const float sqrt_dh = sqrtf((float)DH);

    if (threadIdx.x < ROWS) {
        const int r = threadIdx.x;
        const float m = r < rows ? rmax[stat0 + r] : -INFINITY;
        m_s[r] = m;
        l_s[r] = r < rows ? rsum[stat0 + r] : 1.f;
        dead[r] = m == -INFINITY;
    }
    for (int i = threadIdx.x; i < ROWS * DH; i += THREADS) {
        const int r = i / DH, d = i % DH;
        qs[i] = r < rows ? q[((long long)b * sh.S + s0 + r) * sh.D + h * DH + d] : 0.f;
    }
    __syncthreads();
    row_dots<DH>(di, g, out, sh, b, h, s0, ROWS, dead);
    scores<DH, true>(pz, t_pad, qs, kv, k, kv_base, inv, sh, b, s0, rows);
    // A = exp(z - max) / sum with the forward's statistics; 0 where masked
    for (int i = threadIdx.x; i < rows * sh.T; i += THREADS) {
        const int r = i / sh.T, t = i % sh.T;
        pz[r * t_pad + t] = dead[r] ? 0.f : expf(pz[r * t_pad + t] - m_s[r]) / l_s[r];
    }
    for (int i = threadIdx.x; i < ROWS * DH; i += THREADS) {  // qs <- g rows
        const int r = i / DH, d = i % DH;
        qs[i] = r < rows ? g[((long long)b * sh.S + s0 + r) * sh.D + h * DH + d] : 0.f;
    }
    scores<DH, false>(da, t_pad, qs, kv, v, kv_base, inv, sh, b, s0, rows);  // da = g . v
    // dZ = A (dA - D), dA = (g . v) M
    const int c4n = t_pad / 4;
    for (int i = threadIdx.x; i < rows * c4n; i += THREADS) {
        const int r = i / c4n, c4 = i % c4n;
        float f[4];
        tb_philox::factors4(drop, site, (unsigned long long)(stat0 + r), (uint32_t)c4, f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int t = 4 * c4 + j;
            if (t < sh.T) {
                const float a = pz[r * t_pad + t];
                const float dA = da[r * t_pad + t] * f[j];
                pz[r * t_pad + t] = a * (dA - di[r]);
            }
        }
    }
    constexpr int RSTEP = THREADS / DH;
    constexpr int NR = ROWS / RSTEP;
    float acc[NR];
    weighted_sum<DH>(acc, pz, t_pad, kv, k, kv_base, sh.T, sh.D);
    const int d = threadIdx.x % DH, r0 = threadIdx.x / DH;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
        const int r = r0 + j * RSTEP;
        if (r < rows) dq[((long long)b * sh.S + s0 + r) * sh.D + h * DH + d] = acc[j] / sqrt_dh;
    }
}

constexpr int RQ = 16;  // query rows a step of the dk/dv kernel
static_assert(RQ * TK / 4 == THREADS, "dk/dv mask phase: one Philox call a thread");

template <int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const uint8_t* __restrict__ inv, const float* __restrict__ out, const float* __restrict__ rmax,
                const float* __restrict__ rsum, const float* __restrict__ g, float* __restrict__ dk,
                float* __restrict__ dv, Shape sh, Dropout drop, uint32_t site) {
    // head widths the kernel takes: its static shared memory (K and V tiles,
    // q/g rows, two [RQ, TK] buffers) stays under 48 KB
    static_assert(DH == 16 || DH == 32, "head width");
    constexpr int NC = DH / 4;  // columns a thread accumulates, for dk and for dv
    __shared__ float ks[TK][DH + 1], vs[TK][DH + 1];
    __shared__ float qs[RQ][DH], gs[RQ][DH];
    __shared__ float pm[RQ][TK], dz[RQ][TK];
    __shared__ float m_s[RQ], l_s[RQ], di[RQ];
    __shared__ int dead[RQ];
    const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * TK;
    const long long kv_base = (long long)b * sh.T * sh.D + h * DH;
    const long long stat_b = ((long long)b * sh.H + h) * sh.S;
    const float sqrt_dh = sqrtf((float)DH);
    const int kt = threadIdx.x % TK, grp = threadIdx.x / TK;  // grp 0..3
    const int t = t0 + kt;

    for (int i = threadIdx.x; i < TK * DH; i += THREADS) {
        const int tt = i / DH, d = i % DH;
        const bool in = t0 + tt < sh.T;
        ks[tt][d] = in ? k[kv_base + (long long)(t0 + tt) * sh.D + d] : 0.f;
        vs[tt][d] = in ? v[kv_base + (long long)(t0 + tt) * sh.D + d] : 0.f;
    }
    float acc_k[NC], acc_v[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_k[j] = acc_v[j] = 0.f;

    for (int s0 = 0; s0 < sh.S; s0 += RQ) {
        __syncthreads();
        if (threadIdx.x < RQ) {
            const int r = threadIdx.x;
            const float m = s0 + r < sh.S ? rmax[stat_b + s0 + r] : -INFINITY;
            m_s[r] = m;
            l_s[r] = s0 + r < sh.S ? rsum[stat_b + s0 + r] : 1.f;
            dead[r] = m == -INFINITY;
        }
        for (int i = threadIdx.x; i < RQ * DH; i += THREADS) {
            const int r = i / DH, d = i % DH;
            const bool in = s0 + r < sh.S;
            const long long a = ((long long)b * sh.S + s0 + r) * sh.D + h * DH + d;
            qs[r][d] = in ? q[a] : 0.f;
            gs[r][d] = in ? g[a] : 0.f;
        }
        __syncthreads();
        row_dots<DH>(di, g, out, sh, b, h, s0, RQ, dead);
        // A and g . v for rows 4 grp .. 4 grp + 3 against key t
        {
            float z[4] = {0.f, 0.f, 0.f, 0.f}, gv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int d = 0; d < DH; ++d) {
                const float kd = ks[kt][d], vd = vs[kt][d];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    z[j] = fmaf(qs[grp * 4 + j][d], kd, z[j]);
                    gv[j] = fmaf(gs[grp * 4 + j][d], vd, gv[j]);
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = grp * 4 + j;
                const bool live = t < sh.T && !dead[r] && !masked(inv, sh, b, s0 + r, t);
                pm[r][kt] = live ? expf(z[j] / sqrt_dh - m_s[r]) / l_s[r] : 0.f;
                dz[r][kt] = gv[j];
            }
        }
        __syncthreads();
        {  // one Philox call a thread: row r, keys 4 c4 .. 4 c4 + 3 of the tile
            const int r = threadIdx.x / (TK / 4), c4 = threadIdx.x % (TK / 4);
            float f[4];
            tb_philox::factors4(drop, site, (unsigned long long)(stat_b + s0 + r), (uint32_t)(t0 / 4 + c4), f);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = 4 * c4 + j;
                const float a = pm[r][c];
                dz[r][c] = a * (dz[r][c] * f[j] - di[r]);
                pm[r][c] = a * f[j];
            }
        }
        __syncthreads();
#pragma unroll 4
        for (int r = 0; r < RQ; ++r) {
            const float w = pm[r][kt], zz = dz[r][kt];
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                acc_v[j] = fmaf(w, gs[r][grp + 4 * j], acc_v[j]);
                acc_k[j] = fmaf(zz, qs[r][grp + 4 * j], acc_k[j]);
            }
        }
    }
    if (t < sh.T) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            const long long a = kv_base + (long long)t * sh.D + grp + 4 * j;
            dk[a] = acc_k[j] / sqrt_dh;
            dv[a] = acc_v[j];
        }
    }
}

size_t fwd_smem(int T, int dh) { return sizeof(float) * ((size_t)ROWS * ((T + 3) & ~3) + ROWS * dh + TK * (dh + 1)); }
size_t dq_smem(int T, int dh) { return fwd_smem(T, dh) + sizeof(float) * (size_t)ROWS * ((T + 3) & ~3); }

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* inv, void* out, void* rmax,
                       void* rsum, Shape sh, Dropout drop, uint32_t site, cudaStream_t st) {
    const size_t smem = fwd_smem(sh.T, DH);
    cudaError_t err = cudaFuncSetAttribute(fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((sh.S + ROWS - 1) / ROWS, sh.H, sh.B);
    fwd_kernel<DH><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(inv), static_cast<float*>(out), static_cast<float*>(rmax),
        static_cast<float*>(rsum), sh, drop, site);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* inv, const void* out,
                       const void* rmax, const void* rsum, const void* g, void* dq, void* dk, void* dv, Shape sh,
                       Dropout drop, uint32_t site, cudaStream_t st) {
    const size_t smem = dq_smem(sh.T, DH);
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *of = static_cast<const float*>(out),
                *mf = static_cast<const float*>(rmax), *lf = static_cast<const float*>(rsum),
                *gf = static_cast<const float*>(g);
    const uint8_t* iv = static_cast<const uint8_t*>(inv);
    dim3 grid_q((sh.S + ROWS - 1) / ROWS, sh.H, sh.B);
    bwd_dq_kernel<DH><<<grid_q, THREADS, smem, st>>>(qf, kf, vf, iv, of, mf, lf, gf, static_cast<float*>(dq), sh,
                                                      drop, site);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dim3 grid_k((sh.T + TK - 1) / TK, sh.H, sh.B);
    bwd_dkdv_kernel<DH><<<grid_k, THREADS, 0, st>>>(qf, kf, vf, iv, of, mf, lf, gf, static_cast<float*>(dk),
                                                     static_cast<float*>(dv), sh, drop, site);
    return cudaGetLastError();
}

}  // namespace

// q [B,S,D], k/v [B,T,D], out [B,S,D] fp32 contiguous; invalid read as
// inv[b * inv_sb + s * inv_ss + t] (bool bytes); rmax/rsum [B,H,S] fp32.
// Dropout: on = (p > 0), keep iff bits >= threshold, kept weights * scale.
// Returns the cudaError_t of the launch.
extern "C" int tb_attention_train_fwd(const void* q, const void* k, const void* v, const void* invalid, void* out,
                                      void* rmax, void* rsum, int B, int S, int T, int D, int n_head,
                                      long long inv_sb, long long inv_ss, unsigned long long seed,
                                      unsigned int site, unsigned int threshold, float scale, int on,
                                      void* stream) {
    Shape sh{B, S, T, D, n_head, inv_sb, inv_ss};
    Dropout drop{seed, threshold, scale, on};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D / n_head) {
        case 16: return (int)launch_fwd<16>(q, k, v, invalid, out, rmax, rsum, sh, drop, site, st);
        case 32: return (int)launch_fwd<32>(q, k, v, invalid, out, rmax, rsum, sh, drop, site, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The backward: g [B,S,D] -> dq [B,S,D], dk/dv [B,T,D] (two kernels).
extern "C" int tb_attention_train_bwd(const void* q, const void* k, const void* v, const void* invalid,
                                      const void* out, const void* rmax, const void* rsum, const void* g, void* dq,
                                      void* dk, void* dv, int B, int S, int T, int D, int n_head, long long inv_sb,
                                      long long inv_ss, unsigned long long seed, unsigned int site,
                                      unsigned int threshold, float scale, int on, void* stream) {
    Shape sh{B, S, T, D, n_head, inv_sb, inv_ss};
    Dropout drop{seed, threshold, scale, on};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D / n_head) {
        case 16: return (int)launch_bwd<16>(q, k, v, invalid, out, rmax, rsum, g, dq, dk, dv, sh, drop, site, st);
        case 32: return (int)launch_bwd<32>(q, k, v, invalid, out, rmax, rsum, g, dq, dk, dv, sh, drop, site, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

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
// and zeroes the output and the cotangent: the same zeros). A query row
// marked dead in src_invalid (kernel_common.row_live's padding rows, whose
// blocks the TPU kernels skip forward and backward) comes out 0 with row max
// -inf, so the backward below drops it as it drops an all-masked row: with
// the callers' zero cotangent there, dq, dk and dv are those of the
// unskipped call.
//
// Backward, per head (the formulas of attention_train.py:30-36):
//   dv = (A ⊙ M)ᵀ g;  dP = (g vᵀ) ⊙ M;  dS = A ⊙ (dP - D_s)
//   dq = dS k / sqrt(dh);  dk = dSᵀ q / sqrt(dh)
// where D_s = rowsum(dP ⊙ A) = g_s · out_s is read from the forward's output
// rather than from an [S, T] buffer. The forward saves each row's softmax
// max and sum ([B, H, S] fp32), so the backward rebuilds A tile by tile
// (the logits summed in the forward's order; exp2 with the constants folded
// in and a multiply by 1 / sum, within an ulp or two of the forward's
// weights), with no max/sum pass and no [rows, T] buffer.
//
// What bounds it on the card: fp32 operations. At the map self-attention
// (B = 8, S = T = 1024, 4 heads of 32, 768 allowed keys) the backward does
// 8 D FLOP per allowed (query, key) pair (dv, dP, dq, dk) against ~17 MB of
// bytes: 0.096 ms at 67 TFLOP/s. The design recomputes the logits and g vᵀ
// in both of its kernels (12 D FLOP a pair), on fp32 CUDA cores (the
// gradients are held to 1e-5 of the plain version: no TF32).
//
// The forward (K3f) is the shared forward of csrc/attn_fwd.cuh with
// dropout and the row statistics: a thread-block cluster over T at the
// rollout's as2pl (S = 64), 32-row blocks with register micro-tiles at the
// map self-attention and the posterior latent as2pl, and past the T whose
// [32, T] logits fit shared memory the same blocks with the logits in a
// global workspace (path G); that header says what bounds it and what each
// path does about it. The backward streams key tiles and does not grow
// with T. On an H100 80GB HBM3 at
// 700 W (chip_smoke.py, PERF.md section 6), on the device: 0.256 and 0.318
// ms at the map self-attention and the posterior latent as2pl (the first
// design 0.509 and 0.597 in the same run, above SDPA's forward's 0.432 and
// 0.486), 0.0400 ms at the rollout as2pl (0.0637).
//
// The backward is FlashAttention-2-like and
// streams the other axis in 64-wide tiles, holding no row of length T:
//   dq kernel, (BQ query rows, head, scene) blocks: per 64-key tile,
//     S = q kᵀ, P, dP = g vᵀ, dS = P ⊙ (dP ⊙ M - D) into shared memory,
//     then dq += dS k in registers. It also writes D = g · out ([B, H, S]
//     fp32 scratch) for the second kernel. BQ is 64, or 16 where 64 would
//     give fewer than MIN_BLOCKS blocks (the rollout's as2pl, S = 64): then
//     four groups of 64 threads take four key tiles at once and their dq
//     partials are summed in group order at the end (at d_head 128 always
//     64: the four groups' tiles of a 16-row block would take 316 KB).
//   dk/dv kernel, (64 keys, head, scene) blocks: per 64-row query tile, the
//     same tiles from the key side, then dv += (P ⊙ M)ᵀ g and dk += dSᵀ q
//     in registers.
// Each thread owns a 4 (rows) x 4 (consecutive keys) micro-tile of S, dP and
// dS: one Philox call gives a micro-tile row its four mask bits, and the
// operands come from transposed [DH][rows] tiles as float4 loads (8 FMA a
// load in the products, 5 in the accumulations); a warp holds 4 x 8
// micro-tiles, and the accumulations take rows 16 apart, so that each load
// is one shared-memory wavefront (the products are bound by shared-memory
// wavefronts before the FMA rate at this tile size). A tile that no (row, key)
// pair of the block may use is skipped: the dk/dv kernel writes zeros for a
// key block that no row attends to. No float atomics: every output element
// is summed by one thread (or one thread per group, then in group order) in
// a fixed order, so dq, dk and dv are bitwise the same run to run.
//
// Below d_head 16 (hidden 128 with 16 or 32 heads) a thread of that grid
// would own no output column: bwd_dq_narrow and bwd_dkdv_narrow (below)
// keep the micro-tile's dS in registers and accumulate whole head rows
// from it. On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3a, PERF.md
// section 6), on the device: 1.59 / 2.01 ms at the map self-attention and
// 0.162 / 0.181 ms at the rollout as2pl at d_head 8 / 4 (SDPA's backward
// 2.59 / 5.10 and 0.441 / 0.823).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fwd.cuh"
#include "philox.cuh"

namespace {

constexpr int THREADS = 256;  // threads of a backward block

using tb_philox::Dropout;

struct Shape {
    int B, S, T, D, H;
    long long inv_sb, inv_ss;
};

// ------------------------------------------------------------------ backward

constexpr int BT = 64;          // keys of a backward tile; query rows of a dk/dv step
constexpr int PAD = 4;          // floats after each transposed tile row: stride = 4 mod 32 banks
constexpr int MIN_BLOCKS = 128;  // the dq kernel takes 16-row blocks below this many 64-row ones

// A warp's place in a 16 x 16 grid of micro-tiles: 4 rows of 8, so that a
// float4 load of a tile row serves the warp in one wavefront (8 distinct
// 16-byte chunks, or 4) where 2 x 16 would take two.
__device__ __forceinline__ void warp_grid(int tid, int& ty, int& tx) {
    const int lane = tid & 31, w = tid >> 5;
    ty = (w >> 1) * 4 + (lane >> 3);
    tx = (w & 1) * 8 + (lane & 7);
}

// Stage rows row0 .. row0 + R - 1 of one head's DH columns of src (rows of D
// floats from `base`) transposed into dst[DH][R + PAD], zeros past n_rows.
// A warp covers 8 consecutive columns of 4 rows: 32-byte reads, and with a
// row stride of 4 mod 32 banks, stores without bank conflicts.
template <int DH, int R, int NT>
__device__ __forceinline__ void stage_t(float* __restrict__ dst, const float* __restrict__ src, long long base,
                                        int row0, int n_rows, int D, int tid) {
    for (int idx = tid; idx < R * DH; idx += NT) {
        const int rest = idx >> 5;
        const int d = (idx & 7) + 8 * (rest % (DH / 8));
        const int r = ((idx >> 3) & 3) + 4 * (rest / (DH / 8));
        const int row = row0 + r;
        dst[d * (R + PAD) + r] = row < n_rows ? src[base + (long long)row * D + d] : 0.f;
    }
}

// Bit 4 i + j: query row s + i may use key t + j (i, j < 4): the row is live
// (row_live bit i), the key lies below T and is not masked. A padding mask
// (row stride 0) is read once for the four rows.
__device__ __forceinline__ uint32_t allowed_bits(const uint8_t* __restrict__ inv, const Shape& sh, int b, int s,
                                                 int t, uint32_t row_live) {
    uint32_t bits = 0, keys = 0;
    bool loaded = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if (!((row_live >> i) & 1u)) continue;
        if (!loaded || sh.inv_ss != 0) {
            const uint8_t* row = inv + b * sh.inv_sb + (long long)(s + i) * sh.inv_ss;
            keys = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (t + j < sh.T && !row[t + j]) keys |= 1u << j;
            loaded = true;
        }
        bits |= keys << (4 * i);
    }
    return bits;
}

// The softmax weight from the forward's row statistics, in base 2: with
// c2 = log2(e) / sqrt(dh), m2 = max * log2(e) and il = 1 / sum,
// A = exp2(z c2 - m2) il (within an ulp or two of the forward's
// expf(z / sqrt(dh) - max) / sum, without its two divisions).
__device__ __forceinline__ float weight(float z, float c2, float m2, float il) {
    return exp2f(fmaf(z, c2, -m2)) * il;
}

constexpr float LOG2E = 1.4426950408889634f;

// The thread's 4 x 4 micro-tile product acc[i][j] = a_i . b_j over DH,
// from transposed tiles (row stride la for a, lb for b), summed over d in
// order (the logits as the forward sums them). The kernels take the logits
// and g vᵀ one after the other, so that only one set of sums is live
// beside the weights.
template <int DH>
__device__ __forceinline__ void micro_product(float (&acc)[4][4], const float* at, int la, const float* bt, int lb) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(at + d * la);
        const float4 b = *reinterpret_cast<const float4*>(bt + d * lb);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// Bit j: weight col4 * 4 + j of the row is kept (all kept without dropout,
// whose scale is then 1), the bits of philox.cuh's factors4.
__device__ __forceinline__ uint32_t keep4(const Dropout& d, uint32_t site, unsigned long long row, uint32_t col4) {
    if (!d.on) return 0xFu;
    const tb_philox::U4 b = tb_philox::bits4(d.seed, site, row, col4);
    return (uint32_t)(b.x >= d.threshold) | (uint32_t)(b.y >= d.threshold) << 1 |
           (uint32_t)(b.z >= d.threshold) << 2 | (uint32_t)(b.w >= d.threshold) << 3;
}

// The thread's 4 x 4 weights from its logits (in place) and their keep
// bits: A = 0 where a pair is not allowed.
__device__ __forceinline__ uint32_t weights(float (&a)[4][4], uint32_t bits, const float* m_s, const float* l_s,
                                            int r0, float c2, const Dropout& drop, uint32_t site,
                                            unsigned long long row0, uint32_t col4) {
    uint32_t keep = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if ((bits >> (4 * i)) & 0xFu) keep |= keep4(drop, site, row0 + i, col4) << (4 * i);
        const float m2 = m_s[r0 + i], il = l_s[r0 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = (bits >> (4 * i + j)) & 1u ? weight(a[i][j], c2, m2, il) : 0.f;
    }
    return keep;
}

// acc[i][j] += x_i . y_j over four rows of the reduction axis: x_i, y_j float4s.
template <int NC>
__device__ __forceinline__ void fma4x4(float (&acc)[4][NC], const float4 (&x)[4], const float4 (&y)[NC]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            float a = acc[i][j];
            a = fmaf(x[i].x, y[j].x, a);
            a = fmaf(x[i].y, y[j].y, a);
            a = fmaf(x[i].z, y[j].z, a);
            a = fmaf(x[i].w, y[j].w, a);
            acc[i][j] = a;
        }
}

size_t dq_smem(int dh, int bq) {
    const int ng = THREADS / (4 * bq);
    return sizeof(float) * ((size_t)2 * dh * (bq + PAD) + 3 * bq + (size_t)ng * (2 * dh + bq) * (BT + PAD));
}

size_t dkdv_smem(int dh) { return sizeof(float) * ((size_t)(4 * dh + 2 * BT) * (BT + PAD) + 3 * BT); }

// dq of BQ query rows of one head; D = g . out of those rows into dsum.
template <int DH, int BQ>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const uint8_t* __restrict__ inv, const float* __restrict__ out, const float* __restrict__ rmax,
              const float* __restrict__ rsum, const float* __restrict__ g, float* __restrict__ dq,
              float* __restrict__ dsum, Shape sh, Dropout drop, uint32_t site) {
    constexpr int GT = BQ * 4;        // threads of a key group: a 4 x 4 micro-tile each
    constexpr int NG = THREADS / GT;  // key tiles in flight
    constexpr int NC = DH / 16;       // dq columns a thread accumulates
    constexpr int LQ = BQ + PAD, LK = BT + PAD;
    static_assert(NG * GT == THREADS && DH % 16 == 0, "micro-tiles");
    extern __shared__ float smem[];
    float* qt = smem;               // [DH][LQ] q rows, transposed
    float* gt = qt + DH * LQ;       // [DH][LQ] g rows, transposed
    float* m_s = gt + DH * LQ;      // [BQ] row max * log2(e) (-inf: dead or past S)
    float* l_s = m_s + BQ;          // [BQ] 1 / row sum
    float* d_s = l_s + BQ;          // [BQ] D = g . out
    float* groups = d_s + BQ;       // NG x {kt [DH][LK], vt [DH][LK], ds [BQ][LK]}; then the dq partials
    const int grp = threadIdx.x / GT, tid = threadIdx.x % GT;
    float* kt = groups + grp * (2 * DH + BQ) * LK;
    float* vt = kt + DH * LK;
    float* ds = vt + DH * LK;

    const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * BQ;
    const long long q_base = (long long)b * sh.S * sh.D + h * DH;
    const long long kv_base = (long long)b * sh.T * sh.D + h * DH;
    const long long stat0 = ((long long)b * sh.H + h) * sh.S;
    const float sqrt_dh = sqrtf((float)DH);

    stage_t<DH, BQ, THREADS>(qt, q, q_base, s0, sh.S, sh.D, threadIdx.x);
    stage_t<DH, BQ, THREADS>(gt, g, q_base, s0, sh.S, sh.D, threadIdx.x);
    if (threadIdx.x < BQ) {
        const int r = threadIdx.x, s = s0 + r;
        const float m = s < sh.S ? rmax[stat0 + s] : -INFINITY;
        float dot = 0.f;
        if (m != -INFINITY) {
            const float* gr = g + q_base + (long long)s * sh.D;
            const float* orow = out + q_base + (long long)s * sh.D;
            for (int d = 0; d < DH; ++d) dot = fmaf(gr[d], orow[d], dot);
        }
        m_s[r] = m * LOG2E;
        l_s[r] = s < sh.S ? 1.f / rsum[stat0 + s] : 1.f;
        d_s[r] = dot;
        if (s < sh.S) dsum[stat0 + s] = dot;
    }
    __syncthreads();

    // micro-tile: rows 4 ty .., keys 4 tx ..; dq: rows ty + BQ / 4 i, cols tx + 16 j
    int ty, tx;
    warp_grid(tid, ty, tx);
    const float c2 = LOG2E / sqrt_dh;
    uint32_t row_live = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) row_live |= (m_s[4 * ty + i] != -INFINITY ? 1u : 0u) << i;
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

    const int n_iter = (sh.T + BT * NG - 1) / (BT * NG);
    for (int it = 0; it < n_iter; ++it) {
        const int t0 = (it * NG + grp) * BT;
        const int tk = t0 + 4 * tx;
        const uint32_t bits = allowed_bits(inv, sh, b, s0 + 4 * ty, tk, row_live);
        if (!__syncthreads_or(bits)) continue;  // no pair of this step's tiles is allowed
        stage_t<DH, BT, GT>(kt, k, kv_base, t0, sh.T, sh.D, tid);
        stage_t<DH, BT, GT>(vt, v, kv_base, t0, sh.T, sh.D, tid);
        __syncthreads();
        float a[4][4], dp[4][4];
        micro_product<DH>(a, qt + 4 * ty, LQ, kt + 4 * tx, LK);
        const uint32_t keep = weights(a, bits, m_s, l_s, 4 * ty, c2, drop, site,
                                      (unsigned long long)(stat0 + s0 + 4 * ty), (uint32_t)(tk >> 2));
        micro_product<DH>(dp, gt + 4 * ty, LQ, vt + 4 * tx, LK);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float dd = d_s[4 * ty + i];
            float o[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) o[j] = a[i][j] * (dp[i][j] * ((keep >> (4 * i + j)) & 1u ? drop.scale : 0.f) - dd);
            *reinterpret_cast<float4*>(ds + (4 * ty + i) * LK + 4 * tx) = make_float4(o[0], o[1], o[2], o[3]);
        }
        __syncthreads();
#pragma unroll 4
        for (int tt = 0; tt < BT; tt += 4) {
            float4 x[4], y[NC];
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(ds + (ty + BQ / 4 * i) * LK + tt);
#pragma unroll
            for (int j = 0; j < NC; ++j) y[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * LK + tt);
            fma4x4<NC>(acc, x, y);
        }
    }

    if (NG == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int s = s0 + ty + BQ / 4 * i;
            if (s < sh.S)
#pragma unroll
                for (int j = 0; j < NC; ++j) dq[q_base + (long long)s * sh.D + tx + 16 * j] = acc[i][j] / sqrt_dh;
        }
        return;
    }
    __syncthreads();  // the groups' tiles are free: they take the dq partials [NG][BQ][DH]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) groups[(grp * BQ + ty + BQ / 4 * i) * DH + tx + 16 * j] = acc[i][j];
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * DH; idx += THREADS) {
        const int r = idx / DH, c = idx % DH, s = s0 + r;
        float sum = groups[r * DH + c];
        for (int gi = 1; gi < NG; ++gi) sum += groups[(gi * BQ + r) * DH + c];
        if (s < sh.S) dq[q_base + (long long)s * sh.D + c] = sum / sqrt_dh;
    }
}

// dk and dv of 64 keys of one head, over all query rows in 64-row steps.
template <int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const uint8_t* __restrict__ inv, const float* __restrict__ rmax, const float* __restrict__ rsum,
                const float* __restrict__ dsum, const float* __restrict__ g, float* __restrict__ dk,
                float* __restrict__ dv, Shape sh, Dropout drop, uint32_t site) {
    constexpr int NC = DH / 16;  // dk / dv columns a thread accumulates
    constexpr int L = BT + PAD;
    static_assert(DH % 16 == 0, "micro-tiles");
    extern __shared__ float smem[];
    float* kt = smem;           // [DH][L] the block's keys, transposed
    float* vt = kt + DH * L;    // [DH][L]
    float* qt = vt + DH * L;    // [DH][L] a step's query rows, transposed
    float* gt = qt + DH * L;    // [DH][L]
    float* dst = gt + DH * L;   // [BT keys][L]: dS, transposed
    float* pmt = dst + BT * L;  // [BT keys][L]: A ⊙ M, transposed
    float* m_s = pmt + BT * L;  // [BT] the step's row max * log2(e), 1 / row sum and D
    float* l_s = m_s + BT;
    float* d_s = l_s + BT;

    const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BT;
    const long long q_base = (long long)b * sh.S * sh.D + h * DH;
    const long long kv_base = (long long)b * sh.T * sh.D + h * DH;
    const long long stat0 = ((long long)b * sh.H + h) * sh.S;
    const float sqrt_dh = sqrtf((float)DH);
    // micro-tile: rows 4 ty .., keys 4 tx ..; dk, dv: keys ty + 16 i, cols tx + 16 j
    int ty, tx;
    warp_grid(threadIdx.x, ty, tx);
    const int tk = t0 + 4 * tx;
    const float c2 = LOG2E / sqrt_dh;

    stage_t<DH, BT, THREADS>(kt, k, kv_base, t0, sh.T, sh.D, threadIdx.x);
    stage_t<DH, BT, THREADS>(vt, v, kv_base, t0, sh.T, sh.D, threadIdx.x);
    float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

    for (int s0 = 0; s0 < sh.S; s0 += BT) {
        const int sr = s0 + 4 * ty;
        uint32_t row_live = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (sr + i < sh.S && rmax[stat0 + sr + i] != -INFINITY) row_live |= 1u << i;
        const uint32_t bits = allowed_bits(inv, sh, b, sr, tk, row_live);
        // also the barrier after the previous step's reads of the row tiles
        if (!__syncthreads_or(bits)) continue;
        stage_t<DH, BT, THREADS>(qt, q, q_base, s0, sh.S, sh.D, threadIdx.x);
        stage_t<DH, BT, THREADS>(gt, g, q_base, s0, sh.S, sh.D, threadIdx.x);
        if (threadIdx.x < BT) {
            const int s = s0 + threadIdx.x;
            m_s[threadIdx.x] = s < sh.S ? rmax[stat0 + s] * LOG2E : -INFINITY;
            l_s[threadIdx.x] = s < sh.S ? 1.f / rsum[stat0 + s] : 1.f;
            d_s[threadIdx.x] = s < sh.S ? dsum[stat0 + s] : 0.f;
        }
        __syncthreads();
        float sc[4][4], dp[4][4];  // the logits and g vᵀ, then in place A ⊙ M and dS
        micro_product<DH>(sc, qt + 4 * ty, L, kt + 4 * tx, L);
        const uint32_t keep = weights(sc, bits, m_s, l_s, 4 * ty, c2, drop, site,
                                      (unsigned long long)(stat0 + s0 + 4 * ty), (uint32_t)(tk >> 2));
        micro_product<DH>(dp, gt + 4 * ty, L, vt + 4 * tx, L);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float dd = d_s[4 * ty + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float f = (keep >> (4 * i + j)) & 1u ? drop.scale : 0.f;
                dp[i][j] = sc[i][j] * (dp[i][j] * f - dd);
                sc[i][j] *= f;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            *reinterpret_cast<float4*>(dst + (4 * tx + j) * L + 4 * ty) = make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
            *reinterpret_cast<float4*>(pmt + (4 * tx + j) * L + 4 * ty) = make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
        }
        __syncthreads();
#pragma unroll 4
        for (int rr = 0; rr < BT; rr += 4) {
            float4 x[4], y[NC];
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(pmt + (ty + 16 * i) * L + rr);
#pragma unroll
            for (int j = 0; j < NC; ++j) y[j] = *reinterpret_cast<const float4*>(gt + (tx + 16 * j) * L + rr);
            fma4x4<NC>(acc_v, x, y);
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(dst + (ty + 16 * i) * L + rr);
#pragma unroll
            for (int j = 0; j < NC; ++j) y[j] = *reinterpret_cast<const float4*>(qt + (tx + 16 * j) * L + rr);
            fma4x4<NC>(acc_k, x, y);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t < sh.T)
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                const long long a = kv_base + (long long)t * sh.D + tx + 16 * j;
                dk[a] = acc_k[i][j] / sqrt_dh;
                dv[a] = acc_v[i][j];
            }
    }
}

template <int DH, int BQ>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const uint8_t* inv, const float* out,
                      const float* rmax, const float* rsum, const float* g, float* dq, float* dsum, Shape sh,
                      Dropout drop, uint32_t site, cudaStream_t st) {
    const size_t smem = dq_smem(DH, BQ);
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<DH, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((sh.S + BQ - 1) / BQ, sh.H, sh.B);
    bwd_dq_kernel<DH, BQ><<<grid, THREADS, smem, st>>>(q, k, v, inv, out, rmax, rsum, g, dq, dsum, sh, drop, site);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* inv, const void* out,
                       const void* rmax, const void* rsum, const void* g, void* dq, void* dk, void* dv, void* dsum,
                       Shape sh, Dropout drop, uint32_t site, cudaStream_t st) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *of = static_cast<const float*>(out),
                *mf = static_cast<const float*>(rmax), *lf = static_cast<const float*>(rsum),
                *gf = static_cast<const float*>(g);
    const uint8_t* iv = static_cast<const uint8_t*>(inv);
    float* df = static_cast<float*>(dsum);
    const long long blocks64 = (long long)((sh.S + BT - 1) / BT) * sh.H * sh.B;
    cudaError_t err;
    if constexpr (DH > 64)  // the 16-row block's four groups' tiles would take 316 KB
        err = launch_dq<DH, 64>(qf, kf, vf, iv, of, mf, lf, gf, static_cast<float*>(dq), df, sh, drop, site, st);
    else
        err = blocks64 >= MIN_BLOCKS
            ? launch_dq<DH, 64>(qf, kf, vf, iv, of, mf, lf, gf, static_cast<float*>(dq), df, sh, drop, site, st)
            : launch_dq<DH, 16>(qf, kf, vf, iv, of, mf, lf, gf, static_cast<float*>(dq), df, sh, drop, site, st);
    if (err != cudaSuccess) return err;
    const size_t smem = dkdv_smem(DH);
    err = cudaFuncSetAttribute(bwd_dkdv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid_k((sh.T + BT - 1) / BT, sh.H, sh.B);
    bwd_dkdv_kernel<DH><<<grid_k, THREADS, smem, st>>>(qf, kf, vf, iv, mf, lf, df, gf, static_cast<float*>(dk),
                                                        static_cast<float*>(dv), sh, drop, site);
    return cudaGetLastError();
}

// ------------------------------------------------------------------ d_head 8 and 4
//
// The 16 x 16 grid of micro-tiles above gives a thread DH / 16 output
// columns of the dq and dk/dv accumulations: none below d_head 16. There a
// thread keeps its 4 x 4 micro-tile of dS (and of A ⊙ M) in registers and
// accumulates whole head rows from it: in the dq kernel its 4 query rows x
// DH columns over its 4 keys of each tile (dS k), in the dk/dv kernel its
// 4 keys x DH columns over its 4 query rows of each step ((A ⊙ M)ᵀ g,
// dSᵀ q). No dS or A ⊙ M tile goes through shared memory, and a tile takes
// one barrier where the kernels above take two. At the end the 16 threads
// that share rows (dq: the tx of a ty; dk/dv: the ty of a tx) add their
// partials, within a warp by a butterfly and then across warps in warp
// order through shared memory. The dq kernel takes 64-row blocks only.
// Every sum runs in a fixed order: bitwise the same run to run.

constexpr int NARROW = 16;  // head widths below this take the kernels below

// Stage rows row0 .. row0 + R - 1 of one head's DH columns of src (rows of D
// floats from `base`) transposed into dst[DH][R + PAD], zeros past n_rows.
template <int DH, int R, int NT>
__device__ __forceinline__ void stage_t_narrow(float* __restrict__ dst, const float* __restrict__ src, long long base,
                                               int row0, int n_rows, int D, int tid) {
    for (int idx = tid; idx < R * DH; idx += NT) {
        const int r = idx / DH, d = idx % DH, row = row0 + r;
        dst[d * (R + PAD) + r] = row < n_rows ? src[base + (long long)row * D + d] : 0.f;
    }
}

size_t dq_narrow_smem(int dh) { return sizeof(float) * ((size_t)4 * dh * (BT + PAD) + 3 * BT + 2 * BT * dh); }

size_t dkdv_narrow_smem(int dh) { return sizeof(float) * ((size_t)4 * dh * (BT + PAD) + 3 * BT + 8 * BT * dh); }

// dq of BT query rows of one head; D = g . out of those rows into dsum.
template <int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dq_narrow(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const uint8_t* __restrict__ inv, const float* __restrict__ out, const float* __restrict__ rmax,
              const float* __restrict__ rsum, const float* __restrict__ g, float* __restrict__ dq,
              float* __restrict__ dsum, Shape sh, Dropout drop, uint32_t site) {
    constexpr int L = BT + PAD;
    static_assert(DH < NARROW && DH % 4 == 0, "narrow heads");
    extern __shared__ float smem[];
    float* qt = smem;           // [DH][L] the block's q rows, transposed
    float* gt = qt + DH * L;    // [DH][L] its g rows
    float* kt = gt + DH * L;    // [DH][L] a tile's keys
    float* vt = kt + DH * L;    // [DH][L] its values
    float* m_s = vt + DH * L;   // [BT] row max * log2(e) (-inf: dead or past S)
    float* l_s = m_s + BT;      // [BT] 1 / row sum
    float* d_s = l_s + BT;      // [BT] D = g . out
    float* red = d_s + BT;      // [2][BT][DH] the two warp columns' dq partials

    const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * BT;
    const long long q_base = (long long)b * sh.S * sh.D + h * DH;
    const long long kv_base = (long long)b * sh.T * sh.D + h * DH;
    const long long stat0 = ((long long)b * sh.H + h) * sh.S;
    const float sqrt_dh = sqrtf((float)DH);

    stage_t_narrow<DH, BT, THREADS>(qt, q, q_base, s0, sh.S, sh.D, threadIdx.x);
    stage_t_narrow<DH, BT, THREADS>(gt, g, q_base, s0, sh.S, sh.D, threadIdx.x);
    if (threadIdx.x < BT) {
        const int r = threadIdx.x, s = s0 + r;
        const float m = s < sh.S ? rmax[stat0 + s] : -INFINITY;
        float dot = 0.f;
        if (m != -INFINITY) {
            const float* gr = g + q_base + (long long)s * sh.D;
            const float* orow = out + q_base + (long long)s * sh.D;
            for (int d = 0; d < DH; ++d) dot = fmaf(gr[d], orow[d], dot);
        }
        m_s[r] = m * LOG2E;
        l_s[r] = s < sh.S ? 1.f / rsum[stat0 + s] : 1.f;
        d_s[r] = dot;
        if (s < sh.S) dsum[stat0 + s] = dot;
    }
    __syncthreads();

    // micro-tile: rows 4 ty .., keys 4 tx ..; dq partials: the same rows, every column
    int ty, tx;
    warp_grid(threadIdx.x, ty, tx);
    const float c2 = LOG2E / sqrt_dh;
    uint32_t row_live = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) row_live |= (m_s[4 * ty + i] != -INFINITY ? 1u : 0u) << i;
    float acc[4][DH];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DH; ++c) acc[i][c] = 0.f;

    for (int t0 = 0; t0 < sh.T; t0 += BT) {
        const int tk = t0 + 4 * tx;
        const uint32_t bits = allowed_bits(inv, sh, b, s0 + 4 * ty, tk, row_live);
        // also the barrier after the previous tile's reads of kt and vt
        if (!__syncthreads_or(bits)) continue;  // no pair of this tile is allowed
        stage_t_narrow<DH, BT, THREADS>(kt, k, kv_base, t0, sh.T, sh.D, threadIdx.x);
        stage_t_narrow<DH, BT, THREADS>(vt, v, kv_base, t0, sh.T, sh.D, threadIdx.x);
        __syncthreads();
        float a[4][4], dp[4][4];
        micro_product<DH>(a, qt + 4 * ty, L, kt + 4 * tx, L);
        const uint32_t keep = weights(a, bits, m_s, l_s, 4 * ty, c2, drop, site,
                                      (unsigned long long)(stat0 + s0 + 4 * ty), (uint32_t)(tk >> 2));
        micro_product<DH>(dp, gt + 4 * ty, L, vt + 4 * tx, L);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float dd = d_s[4 * ty + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = a[i][j] * (dp[i][j] * ((keep >> (4 * i + j)) & 1u ? drop.scale : 0.f) - dd);
        }
#pragma unroll
        for (int c = 0; c < DH; ++c) {  // dq += dS k over the thread's 4 keys, in key order
            const float4 kc = *reinterpret_cast<const float4*>(kt + c * L + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float x = acc[i][c];
                x = fmaf(a[i][0], kc.x, x);
                x = fmaf(a[i][1], kc.y, x);
                x = fmaf(a[i][2], kc.z, x);
                x = fmaf(a[i][3], kc.w, x);
                acc[i][c] = x;
            }
        }
    }

    // the 16 threads of a row group: the 8 of its warp, then the two warps in order
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DH; ++c) {
            const float x = tb_attn::group_sum<8>(acc[i][c]);
            if ((lane & 7) == 0) red[((w & 1) * BT + 4 * ty + i) * DH + c] = x;
        }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * DH; idx += THREADS) {
        const int s = s0 + idx / DH;
        if (s < sh.S) dq[q_base + (long long)s * sh.D + idx % DH] = (red[idx] + red[BT * DH + idx]) / sqrt_dh;
    }
}

// dk and dv of BT keys of one head, over all query rows in BT-row steps.
template <int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_narrow(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const uint8_t* __restrict__ inv, const float* __restrict__ rmax, const float* __restrict__ rsum,
                const float* __restrict__ dsum, const float* __restrict__ g, float* __restrict__ dk,
                float* __restrict__ dv, Shape sh, Dropout drop, uint32_t site) {
    constexpr int L = BT + PAD;
    static_assert(DH < NARROW && DH % 4 == 0, "narrow heads");
    extern __shared__ float smem[];
    float* kt = smem;           // [DH][L] the block's keys, transposed
    float* vt = kt + DH * L;    // [DH][L]
    float* qt = vt + DH * L;    // [DH][L] a step's query rows, transposed
    float* gt = qt + DH * L;    // [DH][L]
    float* m_s = gt + DH * L;   // [BT] the step's row max * log2(e), 1 / row sum and D
    float* l_s = m_s + BT;
    float* d_s = l_s + BT;
    float* red = d_s + BT;      // [4][BT][DH] the four warp rows' dk partials, then [4][BT][DH] dv's

    const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BT;
    const long long q_base = (long long)b * sh.S * sh.D + h * DH;
    const long long kv_base = (long long)b * sh.T * sh.D + h * DH;
    const long long stat0 = ((long long)b * sh.H + h) * sh.S;
    const float sqrt_dh = sqrtf((float)DH);
    // micro-tile: rows 4 ty .., keys 4 tx ..; dk, dv partials: the same keys, every column
    int ty, tx;
    warp_grid(threadIdx.x, ty, tx);
    const int tk = t0 + 4 * tx;
    const float c2 = LOG2E / sqrt_dh;

    stage_t_narrow<DH, BT, THREADS>(kt, k, kv_base, t0, sh.T, sh.D, threadIdx.x);
    stage_t_narrow<DH, BT, THREADS>(vt, v, kv_base, t0, sh.T, sh.D, threadIdx.x);
    float acc_k[4][DH], acc_v[4][DH];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < DH; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

    for (int s0 = 0; s0 < sh.S; s0 += BT) {
        const int sr = s0 + 4 * ty;
        uint32_t row_live = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (sr + i < sh.S && rmax[stat0 + sr + i] != -INFINITY) row_live |= 1u << i;
        const uint32_t bits = allowed_bits(inv, sh, b, sr, tk, row_live);
        // also the barrier after the previous step's reads of the row tiles
        if (!__syncthreads_or(bits)) continue;
        stage_t_narrow<DH, BT, THREADS>(qt, q, q_base, s0, sh.S, sh.D, threadIdx.x);
        stage_t_narrow<DH, BT, THREADS>(gt, g, q_base, s0, sh.S, sh.D, threadIdx.x);
        if (threadIdx.x < BT) {
            const int s = s0 + threadIdx.x;
            m_s[threadIdx.x] = s < sh.S ? rmax[stat0 + s] * LOG2E : -INFINITY;
            l_s[threadIdx.x] = s < sh.S ? 1.f / rsum[stat0 + s] : 1.f;
            d_s[threadIdx.x] = s < sh.S ? dsum[stat0 + s] : 0.f;
        }
        __syncthreads();
        float sc[4][4], dp[4][4];  // the logits and g vᵀ, then in place A ⊙ M and dS
        micro_product<DH>(sc, qt + 4 * ty, L, kt + 4 * tx, L);
        const uint32_t keep = weights(sc, bits, m_s, l_s, 4 * ty, c2, drop, site,
                                      (unsigned long long)(stat0 + s0 + 4 * ty), (uint32_t)(tk >> 2));
        micro_product<DH>(dp, gt + 4 * ty, L, vt + 4 * tx, L);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float dd = d_s[4 * ty + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float f = (keep >> (4 * i + j)) & 1u ? drop.scale : 0.f;
                dp[i][j] = sc[i][j] * (dp[i][j] * f - dd);
                sc[i][j] *= f;
            }
        }
#pragma unroll
        for (int c = 0; c < DH; ++c) {  // dv += (A ⊙ M)ᵀ g, dk += dSᵀ q over the thread's 4 rows, in row order
            const float4 gc = *reinterpret_cast<const float4*>(gt + c * L + 4 * ty);
            const float4 qc = *reinterpret_cast<const float4*>(qt + c * L + 4 * ty);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float x = acc_v[j][c], y = acc_k[j][c];
                x = fmaf(sc[0][j], gc.x, x);
                x = fmaf(sc[1][j], gc.y, x);
                x = fmaf(sc[2][j], gc.z, x);
                x = fmaf(sc[3][j], gc.w, x);
                y = fmaf(dp[0][j], qc.x, y);
                y = fmaf(dp[1][j], qc.y, y);
                y = fmaf(dp[2][j], qc.z, y);
                y = fmaf(dp[3][j], qc.w, y);
                acc_v[j][c] = x;
                acc_k[j][c] = y;
            }
        }
    }

    // the 16 threads of a key group: the 4 of its warp (lanes 8 apart), then the four warp rows in order
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < DH; ++c) {
            float x = acc_k[j][c], y = acc_v[j][c];
            x += __shfl_xor_sync(0xffffffffu, x, 8);
            y += __shfl_xor_sync(0xffffffffu, y, 8);
            x += __shfl_xor_sync(0xffffffffu, x, 16);
            y += __shfl_xor_sync(0xffffffffu, y, 16);
            if ((lane >> 3) == 0) {
                const int i = ((w >> 1) * BT + 4 * tx + j) * DH + c;
                red[i] = x;
                red[4 * BT * DH + i] = y;
            }
        }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * DH; idx += THREADS) {
        const int t = t0 + idx / DH;
        if (t >= sh.T) continue;
        float sk = red[idx], sv = red[4 * BT * DH + idx];
        for (int x = 1; x < 4; ++x) {
            sk += red[x * BT * DH + idx];
            sv += red[(4 + x) * BT * DH + idx];
        }
        const long long a = kv_base + (long long)t * sh.D + idx % DH;
        dk[a] = sk / sqrt_dh;
        dv[a] = sv;
    }
}

template <int DH>
cudaError_t bwd_narrow(const void* q, const void* k, const void* v, const void* inv, const void* out,
                       const void* rmax, const void* rsum, const void* g, void* dq, void* dk, void* dv, void* dsum,
                       Shape sh, Dropout drop, uint32_t site, cudaStream_t st) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *mf = static_cast<const float*>(rmax),
                *lf = static_cast<const float*>(rsum), *gf = static_cast<const float*>(g);
    const uint8_t* iv = static_cast<const uint8_t*>(inv);
    float* df = static_cast<float*>(dsum);
    size_t smem = dq_narrow_smem(DH);
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_narrow<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid_q((sh.S + BT - 1) / BT, sh.H, sh.B), grid_k((sh.T + BT - 1) / BT, sh.H, sh.B);
    bwd_dq_narrow<DH><<<grid_q, THREADS, smem, st>>>(
        qf, kf, vf, iv, static_cast<const float*>(out), mf, lf, gf, static_cast<float*>(dq), df, sh, drop, site);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    smem = dkdv_narrow_smem(DH);
    err = cudaFuncSetAttribute(bwd_dkdv_narrow<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bwd_dkdv_narrow<DH><<<grid_k, THREADS, smem, st>>>(
        qf, kf, vf, iv, mf, lf, df, gf, static_cast<float*>(dk), static_cast<float*>(dv), sh, drop, site);
    return cudaGetLastError();
}

}  // namespace

// q [B,S,D], k/v [B,T,D], out [B,S,D] fp32 contiguous; invalid read as
// inv[b * inv_sb + s * inv_ss + t] (bool bytes); src_invalid [B,S]
// contiguous bool bytes (dead query rows) or null; rmax/rsum [B,H,S] fp32.
// Dropout: on = (p > 0), keep iff bits >= threshold, kept weights * scale.
// ws: ws_floats fp32 of workspace for path G's logits, as tb_fused_attention's.
// Returns the cudaError_t of the launch.
extern "C" int tb_attention_train_fwd(const void* q, const void* k, const void* v, const void* invalid,
                                      const void* src_invalid, void* out, void* rmax, void* rsum, int B, int S,
                                      int T, int D, int n_head,
                                      long long inv_sb, long long inv_ss, unsigned long long seed,
                                      unsigned int site, unsigned int threshold, float scale, int on,
                                      void* ws, long long ws_floats, void* stream) {
    tb_attn::Args a{static_cast<const float*>(q), k, v, static_cast<const uint8_t*>(invalid), static_cast<float*>(out),
                    static_cast<float*>(rmax), static_cast<float*>(rsum), B, S, T, D, n_head, inv_sb, inv_ss,
                    Dropout{seed, threshold, scale, on}, site, tb_attn::aligned16(q, k, v),
                    static_cast<const uint8_t*>(src_invalid), static_cast<float*>(ws), ws_floats};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D / n_head) {
        case 4: return (int)tb_attn::launch<4, float, true, true>(a, st);
        case 8: return (int)tb_attn::launch<8, float, true, true>(a, st);
        case 16: return (int)tb_attn::launch<16, float, true, true>(a, st);
        case 32: return (int)tb_attn::launch<32, float, true, true>(a, st);
        case 64: return (int)tb_attn::launch<64, float, true, true>(a, st);
        case 128: return (int)tb_attn::launch<128, float, true, true>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The backward: g [B,S,D] -> dq [B,S,D], dk/dv [B,T,D] (two kernels on one
// stream); dsum [B,H,S] fp32 scratch for D = g . out.
extern "C" int tb_attention_train_bwd(const void* q, const void* k, const void* v, const void* invalid,
                                      const void* out, const void* rmax, const void* rsum, const void* g, void* dq,
                                      void* dk, void* dv, void* dsum, int B, int S, int T, int D, int n_head,
                                      long long inv_sb, long long inv_ss, unsigned long long seed, unsigned int site,
                                      unsigned int threshold, float scale, int on, void* stream) {
    Shape sh{B, S, T, D, n_head, inv_sb, inv_ss};
    Dropout drop{seed, threshold, scale, on};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D / n_head) {
        case 4: return (int)bwd_narrow<4>(q, k, v, invalid, out, rmax, rsum, g, dq, dk, dv, dsum, sh, drop, site, st);
        case 8: return (int)bwd_narrow<8>(q, k, v, invalid, out, rmax, rsum, g, dq, dk, dv, dsum, sh, drop, site, st);
        case 16: return (int)launch_bwd<16>(q, k, v, invalid, out, rmax, rsum, g, dq, dk, dv, dsum, sh, drop, site, st);
        case 32: return (int)launch_bwd<32>(q, k, v, invalid, out, rmax, rsum, g, dq, dk, dv, dsum, sh, drop, site, st);
        case 64: return (int)launch_bwd<64>(q, k, v, invalid, out, rmax, rsum, g, dq, dk, dv, dsum, sh, drop, site, st);
        case 128: return (int)launch_bwd<128>(q, k, v, invalid, out, rmax, rsum, g, dq, dk, dv, dsum, sh, drop, site, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

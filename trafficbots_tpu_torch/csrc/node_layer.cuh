// The DenseTNT node stack's layer code for Hopper (sm_90a), shared by K2
// (node_encoder.cu, eval) and K4b's forward (node_encoder_train.cu).
//
// A block holds the valid nodes of a group of P consecutive polylines as
// the rows of shared [rows, 132] fp32 buffers (P N <= RCAP rows; each
// kernel sizes its group to its shared memory), padding nodes dropped (a
// padding node's key is masked and its output zeroed, so it never moves a
// valid node: compaction changes no bit of a valid row) and all-padding
// polylines skipped. The per-node products (d_model = d_ff = 128) run as
//   out = epilogue(in @ W)
// over the block's R rows: the 128 x 128 fp32 weight streams through
// shared memory in k-tiles of 32 rows, two or three in flight by
// cp.async, and each of a block's 512 threads keeps a register tile of up
// to 4 rows x 4 columns (warp w owns columns 16 (w % 8) .., lane (rg, cg)
// rows 8 (w / 8) + rg, + 16, ... and columns 16 (w % 8) + 4 cg ..). A
// 4-deep k slice costs a thread one float4 of W per k and one float4 of
// each of its rows, for 16 FMAs a row, with no load from L2 on the
// products' path (the first K2 read every weight from L2 into registers,
// its phase trace gave the products 71% of its cycles). 16 warps hide the
// shared-memory latency that 8 left exposed. The sums run over k in order
// with fmaf, as the first K2 did, so with the LayerNorm and attention
// below K2's output is the first design's to the bit.
//
// The attention of a polyline is one thread per (head, row): its q row
// and output in registers, the segment's K and V rows read by float4, its
// scores in registers (at most MAXN), the exact softmax, optional dropout
// of the weights (DROP; off for K2), the weighted sum written over the
// thread's own q slice.
//
// K2's bf16 variant (map_encoder.kernel_matmul_bf16) rounds the operands of
// every product to bf16, as the TPU kernel's `mm` does: its dense products
// run on the tensor cores (dense_mma: bf16 mma.sync with fp32
// accumulation, exact products, the sums in the hardware's order), its
// q, k and v projections round their outputs to bf16 and its attention
// rounds the weights, and runs the fp32 CUDA-core products on those bf16
// values (attention<DROP, BF>: the small per-polyline products stay
// there, as K2's phase trace decided), while LayerNorm, the softmax,
// the residuals and the pool stay fp32. dense and attention<DROP, false>
// are the fp32 code (K2, K4).
//
// The Hopper primitives (cp.async; mma.cuh's MMA) sit behind small
// functions, so that tests/cuda_emu/cuda_runtime.h can give each a plain
// C++ body.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "node_trace.cuh"
#include "philox.cuh"

#ifndef TB_CUDA_EMU
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

namespace tb_node {

constexpr int D = 128;        // d_model == d_feedforward
constexpr int NT = 512;       // threads a block: 16 warps, two for each 16 columns
constexpr int RCAP = 64;      // the most rows a block's buffers may hold
constexpr int MAXRT = RCAP / 16;  // rows of a thread's register tile
constexpr int KT = 32;        // rows of a weight k-tile
constexpr int MAXN = 32;      // nodes a polyline (a thread's scores in registers)
constexpr int MAXH = 8;       // heads of K4b's backward (its row statistics in shared memory)
constexpr int LDS = D + 4;    // row stride of the shared row buffers (16-byte rows)
constexpr int SMEM_OPTIN = 232448;      // shared memory a block may opt in to on sm_90
constexpr float NEG = -1e30f;
constexpr float LN_EPS = 1e-5f;

// floats of the weight ring of dense<NSTAGE>
template <int NSTAGE>
__host__ __device__ constexpr int ring_floats() { return NSTAGE * KT * D; }

// the attention's d_head = 128 / H: at most 32 (a thread's row in
// registers) and a multiple of 4 (float4 rows)
__host__ __device__ constexpr bool heads_ok(int H) { return H > 0 && D % H == 0 && D / H <= 32 && (D / H) % 4 == 0; }

using tb_philox::Dropout;

// A block's rows: the valid nodes of polylines poly0 .. poly0 + P - 1, in
// order, grouped by polyline into segments.
struct Block {
    int N;                      // nodes a polyline
    int R, np;                  // rows, segments (polylines with a valid node)
    long long grow[RCAP];       // global node row (poly * N + node) of each row
    int rseg[RCAP];             // segment of each row
    int rnode[RCAP];            // node of each row within its polyline
    int seg0[RCAP + 1];         // first row of each segment; seg0[np] = R
    long long spoly[RCAP];      // global polyline of each segment
    int nrow[RCAP];             // the row of node (p, n) of the group, -1 for padding
};

// Fills b from the validity of the group's P polylines (P * N <= RCAP).
__device__ void load_block(const uint8_t* __restrict__ valid, long long BP, int N, long long poly0, int P, Block& b) {
    for (int t = threadIdx.x; t < P * N; t += NT) {
        const long long p = poly0 + t / N;
        b.nrow[t] = p < BP && valid[p * N + t % N] != 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int R = 0, np = 0;
        for (int p = 0; p < P; ++p) {
            const int s0 = R;
            for (int n = 0; n < N; ++n) {
                const int t = p * N + n;
                if (b.nrow[t]) {
                    b.grow[R] = (poly0 + p) * N + n;
                    b.rnode[R] = n;
                    b.rseg[R] = np;
                    b.nrow[t] = R++;
                } else {
                    b.nrow[t] = -1;
                }
            }
            if (R > s0) {
                b.seg0[np] = s0;
                b.spoly[np++] = poly0 + p;
            }
        }
        b.seg0[np] = R;
        b.N = N;
        b.R = R;
        b.np = np;
    }
    __syncthreads();
}

// dst[r] = x[grow[r]] for the block's rows
__device__ void load_rows(const float* __restrict__ x, const Block& b, float* dst) {
    for (int e = threadIdx.x; e < b.R * (D / 4); e += NT) {
        const int r = e / (D / 4), c = 4 * (e % (D / 4));
        *reinterpret_cast<float4*>(dst + r * LDS + c) = __ldg(reinterpret_cast<const float4*>(x + b.grow[r] * D + c));
    }
}

// x rounded to bf16 (to nearest even) and widened back
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// out = LN(row) * s + b for one row, by one warp (two-pass variance); the
// first K2's arithmetic and order
__device__ __forceinline__ void ln_row(const float* row, float* out, const float* __restrict__ s,
                                       const float* __restrict__ b, int lane) {
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
        out[c] = v[j] * rs * s[c] + b[c];
    }
}

// out[r] = LN(in[r]) over the block's rows, one warp a row; with gsave,
// also written to gsave[r] (device memory, row stride D)
__device__ void layer_norm(const float* in, float* out, const float* __restrict__ s, const float* __restrict__ b,
                           int R, float* gsave = nullptr) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < R; r += NT / 32) {
        ln_row(in + r * LDS, out + r * LDS, s, b, lane);
        if (gsave != nullptr)  // the columns this lane wrote
#pragma unroll
            for (int j = 0; j < D / 32; ++j) gsave[(long long)r * D + lane + 32 * j] = out[r * LDS + lane + 32 * j];
    }
}

// the same from rows of x in device memory (x[grow[r]]: the layer-0 input)
__device__ void layer_norm_x0(const float* __restrict__ x, const Block& b, float* out, const float* __restrict__ s,
                              const float* __restrict__ bb, float* gsave = nullptr) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < b.R; r += NT / 32) {
        ln_row(x + b.grow[r] * D, out + r * LDS, s, bb, lane);
        if (gsave != nullptr)  // the columns this lane wrote
#pragma unroll
            for (int j = 0; j < D / 32; ++j) gsave[(long long)r * D + lane + 32 * j] = out[r * LDS + lane + 32 * j];
    }
}

// epi(r, c0, acc) for each of this thread's rows r of in @ W (columns
// c0 .. c0 + 3, the bias not added): W a [128, 128] row-major matrix in
// device memory (x @ W layout), wsm the block's weight ring
// (ring_floats<NSTAGE>() floats) of NSTAGE (2 or 3) k-tiles in flight.
// Warp w owns columns 16 (w % 8) ..; the warps w and w + 8 take alternate
// groups of 8 rows. A warp's row tiles run to the
// same count for every lane, so the loop bound is the warp's, not the
// lane's (a lane's rows past R compute on whatever the buffer holds there,
// up to row 63, and are not stored). Begins with a barrier, so that the
// ring is free; the caller synchronises before reading what epi wrote.
template <int NSTAGE, class Epi>
__device__ void dense(const float* in, const float* __restrict__ W, float* wsm, int R, Epi epi) {
    static_assert(NSTAGE == 2 || NSTAGE == 3, "dense: 2 or 3 tiles in flight");
    constexpr int WTILE = KT * D;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int rg = (warp / 8) * 8 + lane / 4, c0 = (warp % 8) * 16 + (lane % 4) * 4;
    // row tiles: rows rg, rg + 16, ..., the same count for the warp's lanes
    const int nrt = (R - (warp / 8) * 8 + 15) / 16;
    constexpr int NTILE = D / KT;
    auto stage = [&](int t) {
        const float* src = W + t * WTILE;
        float* dst = wsm + (t % NSTAGE) * WTILE;
        for (int i = threadIdx.x; i < WTILE / 4; i += NT) cp_async16(dst + 4 * i, src + 4 * i);
    };
    float acc[MAXRT][4];
#pragma unroll
    for (int i = 0; i < MAXRT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    __syncthreads();
#pragma unroll
    for (int t = 0; t < NSTAGE - 1; ++t) {
        stage(t);
        cp_async_commit();
    }
    for (int t = 0; t < NTILE; ++t) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();  // tile t landed for every thread; tile t - 1's slot is free
        if (t + NSTAGE - 1 < NTILE) stage(t + NSTAGE - 1);
        cp_async_commit();
        const float* ws = wsm + (t % NSTAGE) * WTILE;
        const float* a0 = in + rg * LDS + t * KT;
#pragma unroll
        for (int kk = 0; kk < KT; kk += 4) {
            float4 w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) w[u] = *reinterpret_cast<const float4*>(ws + (kk + u) * D + c0);
#pragma unroll
            for (int i = 0; i < MAXRT; ++i) {
                if (i < nrt) {
                    const float4 a = *reinterpret_cast<const float4*>(a0 + 16 * i * LDS + kk);
                    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        acc[i][0] = fmaf(av[u], w[u].x, acc[i][0]);
                        acc[i][1] = fmaf(av[u], w[u].y, acc[i][1]);
                        acc[i][2] = fmaf(av[u], w[u].z, acc[i][2]);
                        acc[i][3] = fmaf(av[u], w[u].w, acc[i][3]);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < MAXRT; ++i)
        if (i < nrt && rg + 16 * i < R) epi(rg + 16 * i, c0, acc[i]);
}

// bf16 row stride of dense_mma's buffers: 68 words a row, so that a
// fragment's loads fall in distinct banks
constexpr int LDA = D + 8;
// bytes of dense_mma's buffers: the rows [RCAP][LDA] and W [D][LDA] in bf16
constexpr int MMA_BYTES = 2 * (RCAP + D) * LDA;

// dense's epi(r, c0, acc) on the tensor cores, both operands rounded to
// bf16 (K2-bf16): each product a bf16 MMA with fp32 accumulation. W is read
// once a block by 16-byte loads from device memory (L2), all issued before
// the block's first barrier, and rounded into a bf16 copy [D][LDA] in wsm;
// the block's R rows of `in` are rounded beside it [16 ceil(R / 16)][LDA]
// (zero rows past R). Warp w takes columns 16 (w % 8) .. as two 8-column
// n-tiles, n-tile j's column n being W column 16 (w % 8) + 2 n + j, so that
// a lane's four outputs of a row are the consecutive columns c0 .. c0 + 3
// that epi takes (a B fragment register: the halves of two W words, one
// word holding both n-tiles' columns), and m-tiles w / 8, w / 8 + 2, ...
// Begins with a barrier, so that wsm is free (MMA_BYTES); the caller
// synchronises before reading what epi wrote.
template <class Epi>
__device__ void dense_mma(const float* in, const float* __restrict__ W, float* wsm, int R, Epi epi) {
    constexpr int KS = D / 16, NV = D * D / 4 / NT, LW = LDA / 2;  // k-steps, float4s of W a thread, words a row
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane >> 2, t = lane & 3;
    const int MT = (R + 15) / 16, n0 = 16 * (warp % 8);
    __nv_bfloat16* a16 = reinterpret_cast<__nv_bfloat16*>(wsm);
    __nv_bfloat16* w16 = a16 + RCAP * LDA;
    float4 wv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) wv[i] = __ldg(reinterpret_cast<const float4*>(W) + threadIdx.x + NT * i);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const int e = threadIdx.x + NT * i, k = e / (D / 4), c = 4 * (e % (D / 4));
        *reinterpret_cast<uint2*>(w16 + k * LDA + c) =
            make_uint2(pack_bf16(wv[i].x, wv[i].y), pack_bf16(wv[i].z, wv[i].w));
    }
    for (int e = threadIdx.x; e < MT * 16 * (D / 4); e += NT) {
        const int r = e / (D / 4), c = 4 * (e % (D / 4));
        uint2 u = make_uint2(0u, 0u);
        if (r < R) {
            const float4 v = *reinterpret_cast<const float4*>(in + r * LDS + c);
            u = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
        }
        *reinterpret_cast<uint2*>(a16 + r * LDA + c) = u;
    }
    __syncthreads();
    const uint32_t* wcol = reinterpret_cast<const uint32_t*>(w16 + 2 * t * LDA + n0 + 2 * g);
    for (int mt = warp / 8; mt < MT; mt += NT / 32 / 8) {
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t fa[4];
            tb_mma::load_a(fa, a16, LDA, 16 * mt, 16 * ks);
            const uint32_t* wk = wcol + 16 * ks * LW;  // W rows 16 ks + 2t, + 1, + 8, + 9 at columns n0 + 2g, + 1
            const uint32_t w0 = wk[0], w1 = wk[LW], w8 = wk[8 * LW], w9 = wk[9 * LW];
            const uint32_t b0[2] = {__byte_perm(w0, w1, 0x5410), __byte_perm(w8, w9, 0x5410)};
            const uint32_t b1[2] = {__byte_perm(w0, w1, 0x7632), __byte_perm(w8, w9, 0x7632)};
            mma_bf16_16816(acc[0], fa, b0);
            mma_bf16_16816(acc[1], fa, b1);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int r = 16 * mt + g + 8 * hf;
            const float y[4] = {acc[0][2 * hf], acc[1][2 * hf], acc[0][2 * hf + 1], acc[1][2 * hf + 1]};
            if (r < R) epi(r, n0 + 4 * t, y);
        }
    }
}

__device__ __forceinline__ float4 bias4(const float* __restrict__ b, int c0) {
    return __ldg(reinterpret_cast<const float4*>(b + c0));
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// f[u] for a u known only at run time, without indexing a local array
__device__ __forceinline__ float pick4(const float (&f)[4], int u) {
    return u == 0 ? f[0] : u == 1 ? f[1] : u == 2 ? f[2] : f[3];
}

// dst[d] = src[d] for d < dh (<= 32, a multiple of 4), by float4
__device__ __forceinline__ void load_head(const float* src, float (&dst)[32], int dh) {
#pragma unroll
    for (int d4 = 0; d4 < 8; ++d4)
        if (4 * d4 < dh) {
            const float4 v = *reinterpret_cast<const float4*>(src + 4 * d4);
            dst[4 * d4] = v.x, dst[4 * d4 + 1] = v.y, dst[4 * d4 + 2] = v.z, dst[4 * d4 + 3] = v.w;
        }
}

// sum_d a[d] b[d] over d < dh in order (fmaf), b read by float4
__device__ __forceinline__ float dot_head(const float (&a)[32], const float* b, int dh) {
    float t = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < 8; ++d4)
        if (4 * d4 < dh) {
            const float4 v = *reinterpret_cast<const float4*>(b + 4 * d4);
            t = fmaf(a[4 * d4], v.x, t);
            t = fmaf(a[4 * d4 + 1], v.y, t);
            t = fmaf(a[4 * d4 + 2], v.z, t);
            t = fmaf(a[4 * d4 + 3], v.w, t);
        }
    return t;
}

// acc[d] += w b[d] for d < dh, b read by float4
__device__ __forceinline__ void axpy_head(float (&acc)[32], float w, const float* b, int dh) {
#pragma unroll
    for (int d4 = 0; d4 < 8; ++d4)
        if (4 * d4 < dh) {
            const float4 v = *reinterpret_cast<const float4*>(b + 4 * d4);
            acc[4 * d4] = fmaf(w, v.x, acc[4 * d4]);
            acc[4 * d4 + 1] = fmaf(w, v.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(w, v.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(w, v.w, acc[4 * d4 + 3]);
        }
}

// dst[d] = a[d] for d < dh, by float4
__device__ __forceinline__ void store_head(float* dst, const float (&a)[32], int dh) {
#pragma unroll
    for (int d4 = 0; d4 < 8; ++d4)
        if (4 * d4 < dh) store4(dst + 4 * d4, a[4 * d4], a[4 * d4 + 1], a[4 * d4 + 2], a[4 * d4 + 3]);
}

// a[r, head h] = (softmax_j(q_h[r] . k_h[j] / sqrt(dh)) [⊙ M0]) v_h over
// the keys j of r's polyline (d_head = 128 / H <= 32, a multiple of 4),
// written over q (A may be Q: each thread reads its own q slice, into
// registers, before writing it). With DROP, the weights' dropout at
// `site`, row (poly H + h) N + node_r, column node_j; with gsave, a also
// written to gsave[r] (device memory, row stride D). The sums over d and
// over j run in order, as the first design's did. With BF (K2-bf16) the
// weights are rounded to bf16 before their product with v; Q, K and V then
// hold bf16 values (their projections round them), so that every operand
// of the two products is bf16.
template <bool DROP, bool BF = false>
__device__ void attention(const float* Q, const float* K, const float* V, float* A, const Block& b, int H,
                          const Dropout& drop, int site, float* gsave = nullptr) {
    const int dh = D / H;
    const float sqrt_dh = sqrtf((float)dh);
    for (int w = threadIdx.x; w < H * b.R; w += NT) {
        const int r = w % b.R, h = w / b.R;
        const int s = b.rseg[r], j0 = b.seg0[s], n = b.seg0[s + 1] - j0;
        float acc[32];
        load_head(Q + r * LDS + h * dh, acc, dh);  // q, then the output
        float sc[MAXN];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= n) break;
            sc[j] = dot_head(acc, K + (j0 + j) * LDS + h * dh, dh) / sqrt_dh;
            m = fmaxf(m, sc[j]);
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= n) break;
            sc[j] = expf(sc[j] - m);
            sum += sc[j];
        }
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= n) break;
            sc[j] = BF ? round_bf16(sc[j] / sum) : sc[j] / sum;
        }
        if (DROP && drop.on) {
            const unsigned long long row = ((unsigned long long)b.spoly[s] * H + h) * b.N + b.rnode[r];
            int c4 = -1;
            float f[4];
#pragma unroll
            for (int j = 0; j < MAXN; ++j) {
                if (j >= n) break;
                const int nj = b.rnode[j0 + j];
                if (nj / 4 != c4) {
                    c4 = nj / 4;
                    tb_philox::factors4(drop, site, row, (uint32_t)c4, f);
                }
                sc[j] *= pick4(f, nj % 4);
            }
        }
#pragma unroll
        for (int d = 0; d < 32; ++d) acc[d] = 0.f;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= n) break;
            axpy_head(acc, sc[j], V + (j0 + j) * LDS + h * dh, dh);
        }
        store_head(A + r * LDS + h * dh, acc, dh);
        if (gsave != nullptr) store_head(gsave + (long long)r * D + h * dh, acc, dh);
    }
}

}  // namespace tb_node

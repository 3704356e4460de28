// Training DenseTNT polyline-node encoder + masked max-pool with dropout,
// forward (K4f) and hand-derived backward (K4b), for Hopper (sm_90a), plain
// C interface.
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
// K4f and K4b's save kernel run one forward body, group_forward (namespace
// k4, on csrc/node_layer.cuh, as K2): a block holds the valid nodes of a
// group of polylines as rows, the 128 x 128 weights stream through shared
// memory by cp.async k-tiles into 512 threads' register tiles, and the
// dropout factors multiply in the products' epilogues and the attention
// weights; the save kernel also writes each layer's tensors. So the forward
// that K4b differentiates is the one K4f ran, to the bit, and the max-pool
// argmax K4b recomputes is the one K4f chose. K4f writes only each
// polyline's pooled row (-1e30 for a polyline without a valid node). With
// dropout off it is K2 (every factor exactly 1.0): its output is K2's to
// the bit. The first K4f (one polyline a 256-thread block, every weight
// read from L2 by __ldg for each of 6 products a layer and each polyline,
// padding nodes computed) ran at 8.12 ms; its phase trace gave the
// attention halves (four of the six products and the attention) 75% of a
// polyline's cycles. This one: 3.52 ms at the main path's 8 scenes
// (p = 0.1; the first design 8.12 in the same run, K2 3.21), 5.0x its
// 0.701 ms bound, on an H100 80GB HBM3 at a 700.00 W power limit
// (PERF.md); its output is the first design's to the bit (the same sums in
// the same order; the padding the first design computed added exact zeros).
//
// K4b (namespace k4b), redesigned. The first design walked one polyline at
// a time through a forward to the layer inputs, a second forward per layer
// and 18 weight-gradient updates read-modify-written into a block's own
// 1.2 MB partial slice; its phase trace (ops/node_trace.py) gave the two
// forwards 59% of a polyline's cycles, the cotangent products 18%, the
// weight-gradient updates 13%, the attention backward 8%. This design:
//   1. count / scan: each group of ROWS / N polylines' valid nodes, and the
//      group's first row in a compacted row space (valid nodes only);
//   2. transpose: the six weight matrices of each layer, for the
//      cotangent products (dy @ Wᵀ as a plain product on Wᵀ);
//   3. save (one 512-thread block a group): the group's valid nodes as
//      rows, the forward ONCE with node_layer.cuh's products, saving each
//      layer's tensors to device memory (compacted rows), and the max-pool
//      backward (the rows' cotangent g saved);
//   4. walk (a fixed grid of nblocks 256-thread blocks, group g on block
//      g % nblocks): layer by layer down, the cotangents (the products on
//      Wᵀ, the attention backward recomputing its weights from q, k and
//      the row statistics), each weight product's output-cotangent rows
//      saved once beside its saved input rows, the LayerNorm vector
//      gradients added into the block's own slice in group order; dx;
//   5. dw: the 18 weight products dW = Aᵀ B (and the bias gradients, the
//      column sums of B) over all valid rows, as a fixed-order split-K
//      fp32 product: block (product, split) sums its rows in order into
//      its own partial;
//   6. reduce: the partials and the slices summed in a fixed order.
// No float atomics: dx and every gradient are bitwise the same run to run.
// All-padding polylines contribute exactly 0 (their pooled cotangent is 0)
// and are skipped; padding nodes get dx = 0.
//
// On an H100 80GB HBM3 at 700.00 W (PERF.md), at the main path's 8 scenes:
// 12.8-12.9 ms (the first design 65.3-65.5 in the same run, autograd
// through the plain version 26.5): the save 4.2, the walk 7.2, the dw
// products 1.3.
//
// What bounds it on the card: the fp32 operations. A valid node costs
// 12 D^2 = 197 kFLOP a layer forward (six 128 x 128 products): K4f does
// ~47 GFLOP at the main path's ~80k valid nodes x 3 layers (0.701 ms at
// 67 TFLOP/s) against ~85 MB read; the
// backward's walk does the forward once and six cotangent products, the dW
// products six more: ~3x the forward. The saved tensors are 11 a layer
// (and the layer inputs), ~41 MB each at ~80k valid nodes, written once
// and read once or twice. No tensor cores: fp32 parity with the plain
// version (the gradients below a max-pool are ulp-sensitive).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "node_layer.cuh"
#include "node_trace.cuh"
#include "philox.cuh"

// the parameter layout both passes share
namespace k4 {

constexpr int DM = 128;

enum Name { LN1_S, LN1_B, LNT_S, LNT, LN2_S, LN2_B, WQ, BQ, WK, BK, WV, BV, WO, BO, W1, B1, W2, B2, N_NAMES };

__host__ __device__ constexpr bool is_matrix(int n) { return n == WQ || n == WK || n == WV || n == WO || n == W1 || n == W2; }

// Offset of parameter `name`, layer l, in the flat gradient vector (the
// 18 stacked arrays in W_NAMES order, each [L, ...]).
__host__ __device__ inline long long grad_off(int name, int l, int L) {
    long long o = 0;
    for (int i = 0; i < name; ++i) o += (long long)L * (is_matrix(i) ? DM * DM : DM);
    return o + (long long)l * (is_matrix(name) ? DM * DM : DM);
}

__host__ __device__ inline long long n_params(int L) { return grad_off(N_NAMES, 0, L); }

struct Weights {
    const float* p[N_NAMES];
    __device__ const float* at(int name, int l) const { return p[name] + (long long)l * (is_matrix(name) ? DM * DM : DM); }
};

}  // namespace k4

// ------------------------------------------------------------------ the forward (K4f, K4b's save)

namespace k4 {

using namespace tb_node;

// the per-layer tensors K4b's save kernel keeps [cap, 128] (compacted
// rows); the walk down overwrites q, k, v, x1 by dq, dk, dv, da
enum Saved { TG, S2, CAT, S2B, FDO, KS, VS, QS, X1, DF, DZ1, N_SAVED };

// The layers' forward over a block's rows: X holds the rows of x_in (the
// layer-0 input) and ends as the last layer's output; A1 .. A4 and the
// weight ring wsm are scratch. Dropout at site 4 l + k: k = 0 the attention
// weights (node_layer.cuh), 1, 2, 3 in the epilogues of the out-projection,
// the FFN hidden after the ReLU and the FFN output, each at the global node
// row. With SAVE (K4b's save kernel) each layer's tensors also go to
// saved(l, s) and its input to saved_x(l) (l > 0; device memory, row
// stride D); K4f runs it without. Phases of kernel K: 2 the LayerNorms,
// 3 the dense products, 4 the attention.
template <int K, bool SAVE, class SavedAt, class SavedX>
__device__ void group_forward(const float* __restrict__ x_in, const Block& blk, int L, int H, const Weights& w,
                              const Dropout& drop, float* X, float* A1, float* A2, float* A3, float* A4, float* wsm,
                              SavedAt saved, SavedX saved_x) {
    TB_NODE_RESUME();
    const int R = blk.R;
    for (int l = 0; l < L; ++l) {
        if (SAVE && l > 0) {
            float* xs = saved_x(l);
            for (int e = threadIdx.x; e < R * (D / 4); e += NT)
                *reinterpret_cast<float4*>(xs + (long long)(e / (D / 4)) * D + 4 * (e % (D / 4))) =
                    *reinterpret_cast<const float4*>(X + (e / (D / 4)) * LDS + 4 * (e % (D / 4)));
        }
        layer_norm_x0(x_in, blk, A1, w.at(LNT_S, l), w.at(LNT, l), saved(l, TG));
        TB_NODE_MARK(K, 2);
        const float* bk = w.at(BK, l);
        float* gk = saved(l, KS);
        dense<3>(A1, w.at(WK, l), wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(bk, c0);
            store4(A3 + r * LDS + c0, y[0] + b.x, y[1] + b.y, y[2] + b.z, y[3] + b.w);
            if (SAVE) store4(gk + (long long)r * D + c0, y[0] + b.x, y[1] + b.y, y[2] + b.z, y[3] + b.w);
        });
        const float* bv = w.at(BV, l);
        float* gv = saved(l, VS);
        dense<3>(A1, w.at(WV, l), wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(bv, c0);
            store4(A4 + r * LDS + c0, y[0] + b.x, y[1] + b.y, y[2] + b.z, y[3] + b.w);
            if (SAVE) store4(gv + (long long)r * D + c0, y[0] + b.x, y[1] + b.y, y[2] + b.z, y[3] + b.w);
        });
        __syncthreads();
        TB_NODE_MARK(K, 3);
        layer_norm(X, A1, w.at(LN1_S, l), w.at(LN1_B, l), R, saved(l, S2));
        TB_NODE_MARK(K, 2);
        const float* bq = w.at(BQ, l);
        float* gq = saved(l, QS);
        dense<3>(A1, w.at(WQ, l), wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(bq, c0);
            store4(A2 + r * LDS + c0, y[0] + b.x, y[1] + b.y, y[2] + b.z, y[3] + b.w);
            if (SAVE) store4(gq + (long long)r * D + c0, y[0] + b.x, y[1] + b.y, y[2] + b.z, y[3] + b.w);
        });
        __syncthreads();
        TB_NODE_MARK(K, 3);
        attention<true>(A2, A3, A4, A2, blk, H, drop, 4 * l, saved(l, CAT));
        __syncthreads();
        TB_NODE_MARK(K, 4);
        const float* bo = w.at(BO, l);
        float* gx1 = saved(l, X1);
        dense<3>(A2, w.at(WO, l), wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(bo, c0);
            float f[4];
            tb_philox::factors4(drop, 4 * l + 1, blk.grow[r], (uint32_t)(c0 / 4), f);
            float* o = X + r * LDS + c0;
            const float4 v = make_float4(o[0] + (y[0] + b.x) * f[0], o[1] + (y[1] + b.y) * f[1],
                                         o[2] + (y[2] + b.z) * f[2], o[3] + (y[3] + b.w) * f[3]);
            *reinterpret_cast<float4*>(o) = v;
            if (SAVE) *reinterpret_cast<float4*>(gx1 + (long long)r * D + c0) = v;
        });
        __syncthreads();
        TB_NODE_MARK(K, 3);
        layer_norm(X, A1, w.at(LN2_S, l), w.at(LN2_B, l), R, saved(l, S2B));
        TB_NODE_MARK(K, 2);
        const float* b1 = w.at(B1, l);
        float* gf = saved(l, FDO);
        dense<3>(A1, w.at(W1, l), wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(b1, c0);
            float f[4];
            tb_philox::factors4(drop, 4 * l + 2, blk.grow[r], (uint32_t)(c0 / 4), f);
            const float4 v = make_float4(fmaxf(y[0] + b.x, 0.f) * f[0], fmaxf(y[1] + b.y, 0.f) * f[1],
                                         fmaxf(y[2] + b.z, 0.f) * f[2], fmaxf(y[3] + b.w, 0.f) * f[3]);
            *reinterpret_cast<float4*>(A2 + r * LDS + c0) = v;
            if (SAVE) *reinterpret_cast<float4*>(gf + (long long)r * D + c0) = v;
        });
        const float* b2 = w.at(B2, l);
        dense<3>(A2, w.at(W2, l), wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(b2, c0);
            float f[4];
            tb_philox::factors4(drop, 4 * l + 3, blk.grow[r], (uint32_t)(c0 / 4), f);
            float* o = X + r * LDS + c0;
            store4(o, o[0] + (y[0] + b.x) * f[0], o[1] + (y[1] + b.y) * f[1], o[2] + (y[2] + b.z) * f[2],
                   o[3] + (y[3] + b.w) * f[3]);
        });
        __syncthreads();
        TB_NODE_MARK(K, 3);
    }
}

// K4f: K2's node_kernel (csrc/node_encoder.cu) with the dropout, a block
// a group of ROWS_F / N polylines, each polyline's max-pool written
// (-1e30 for one without a valid node). Five [64, 132] row buffers and
// three weight k-tiles in flight take K2's 213 KB: the dropout epilogues
// need no buffer of their own, so the group is K2's 64 rows, not the 60 of
// K4b's save kernel (whose walk needs six buffers).
constexpr int ROWS_F = 64;
constexpr size_t FWD_SMEM = sizeof(float) * ((size_t)5 * ROWS_F * LDS + ring_floats<3>());
static_assert(ROWS_F <= RCAP && FWD_SMEM + sizeof(Block) <= SMEM_OPTIN, "the buffers must fit one block's shared memory");

__global__ void __launch_bounds__(NT, 1)
fwd_kernel(const float* __restrict__ x_in, const uint8_t* __restrict__ valid, float* __restrict__ out, long long BP,
           int N, int L, int H, Weights w, Dropout drop) {
    extern __shared__ float4 smem4[];
    float* X = reinterpret_cast<float*>(smem4);
    float* A1 = X + ROWS_F * LDS;
    float* A2 = A1 + ROWS_F * LDS;
    float* A3 = A2 + ROWS_F * LDS;
    float* A4 = A3 + ROWS_F * LDS;
    float* wsm = A4 + ROWS_F * LDS;
    __shared__ Block blk;

    const int P = ROWS_F / N;
    const long long poly0 = (long long)blockIdx.x * P;
    load_block(valid, BP, N, poly0, P, blk);
    if (blk.R == 0) {  // all padding: the pool identity
        for (int e = threadIdx.x; e < P * D; e += NT)
            if (poly0 + e / D < BP) out[(poly0 + e / D) * D + e % D] = NEG;
        return;
    }
    TB_NODE_BEGIN(1);
    load_rows(x_in, blk, X);
    __syncthreads();
    TB_NODE_MARK(1, 1);
    group_forward<1, false>(x_in, blk, L, H, w, drop, X, A1, A2, A3, A4, wsm,
                            [](int, int) -> float* { return nullptr; }, [](int) -> float* { return nullptr; });
    TB_NODE_RESTART();
    for (int e = threadIdx.x; e < P * D; e += NT) {
        const int p = e / D, c = e % D;
        if (poly0 + p >= BP) break;
        float m = NEG;
        for (int n = 0; n < N; ++n) {
            const int r = blk.nrow[p * N + n];
            if (r >= 0) m = fmaxf(m, X[r * LDS + c]);
        }
        out[(poly0 + p) * D + c] = m;
    }
    TB_NODE_MARK(1, 5);
}

}  // namespace k4

// ------------------------------------------------------------------ K4b

namespace k4b {

using namespace k4;
using namespace tb_node;

constexpr int ROWS = 60;     // rows (valid nodes) a block holds: the walk's six buffers and weight ring fit 227 KB
constexpr int NS_B = 2;      // weight k-tiles in flight in the walk: two (six buffers; the forward's three)
constexpr int NTS = 256;     // threads of the small kernels
constexpr int NSPLIT = 14;   // splits of the rows in the dW products: 18 x 14 blocks, one wave of two an SM
constexpr int RC = 32;       // rows a stage of the dW products
constexpr int NKIND = 6;     // weight matrices a layer: q, k, v, o, 1, 2
constexpr size_t SAVE_SMEM = sizeof(float) * ((size_t)5 * ROWS * LDS + ring_floats<3>());      // x, a1 .. a4
constexpr size_t WALK_SMEM = sizeof(float) * ((size_t)6 * ROWS * LDS + ring_floats<NS_B>());  // g, dx0, a1 .. a4
constexpr size_t DW_SMEM = sizeof(float) * 2 * 2 * RC * D;  // two stages of A and B rows
// the walk's static shared memory: its Block, the attention's and the LayerNorms' row statistics
static_assert(WALK_SMEM + sizeof(Block) + sizeof(float) * (3 * MAXH + 2) * ROWS <= SMEM_OPTIN,
              "the walk's buffers must fit one block's shared memory");
static_assert(ROWS <= RCAP && ROWS % 4 == 0, "a walk block's rows");

// each kind's product dW = Aᵀ B, its matrix and its bias
__device__ const int A_OF[NKIND] = {S2, TG, TG, CAT, S2B, FDO};
__device__ const int B_OF[NKIND] = {QS, KS, VS, X1, DZ1, DF};
__host__ __device__ constexpr int matrix_of(int kind) { return WQ + 2 * kind; }

// The backward's scratch (floats), carved from one buffer the wrapper
// allocates (tb_node_encoder_train_scratch).
struct Scratch {
    float* rows;     // [L N_SAVED + L][cap][128]: the saved tensors, the layer inputs x_1 .. x_{L-1}, the output's cotangent
    long long cap;   // rows of each tensor: BP N, every node valid at most
    float* wt;       // [NKIND][L][128][128] the transposed matrices
    float* part;     // [NSPLIT][NKIND L][128][128] the dW products' partials
    float* bpart;    // [NSPLIT][NKIND L][128] the bias gradients' partials
    float* vpart;    // [nblocks][L][6][128] the LayerNorm gradients' slices (LN1_S .. LN2_B)
    int* off;        // [G + 1] each group's first compacted row; off[G] = rows in all
    __host__ __device__ float* t(int l, int s) const { return rows + ((long long)l * N_SAVED + s) * cap * D; }
    __host__ __device__ float* xl(int l, int L) const { return rows + ((long long)L * N_SAVED + l - 1) * cap * D; }
    __host__ __device__ float* g_rows(int L) const { return rows + ((long long)L * N_SAVED + L - 1) * cap * D; }
    __host__ __device__ float* wt_of(int kind, int l, int L) const { return wt + ((long long)kind * L + l) * D * D; }
};

struct Shape {
    long long BP;
    int N, L, H, P, G, nblocks;
};

__host__ __device__ inline Shape shape_of(long long BP, int N, int L, int H, int nblocks) {
    const int P = ROWS / N;
    return Shape{BP, N, L, H, P, (int)((BP + P - 1) / P), nblocks};
}

// floats of each part of the scratch, in order
__host__ __device__ inline long long scratch_floats(const Shape& s, long long* parts) {
    const long long cap = s.BP * s.N;
    parts[0] = ((long long)s.L * N_SAVED + s.L) * cap * D;
    parts[1] = (long long)NKIND * s.L * D * D;
    parts[2] = (long long)NSPLIT * NKIND * s.L * D * D;
    parts[3] = (long long)NSPLIT * NKIND * s.L * D;
    parts[4] = (long long)s.nblocks * s.L * 6 * D;
    parts[5] = s.G + 1;
    long long n = 0;
    for (int i = 0; i < 6; ++i) n += parts[i];
    return n;
}

Scratch carve(float* base, const Shape& s) {
    long long parts[6];
    scratch_floats(s, parts);
    Scratch sc;
    sc.cap = s.BP * s.N;
    sc.rows = base;
    sc.wt = sc.rows + parts[0];
    sc.part = sc.wt + parts[1];
    sc.bpart = sc.part + parts[2];
    sc.vpart = sc.bpart + parts[3];
    sc.off = reinterpret_cast<int*>(sc.vpart + parts[4]);
    return sc;
}

// off[g + 1] = the valid nodes of group g (one warp a group)
__global__ void __launch_bounds__(NTS) count_kernel(const uint8_t* __restrict__ valid, Shape s, int* off) {
    const int g = blockIdx.x * (NTS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (g >= s.G) return;
    const long long first = (long long)g * s.P * s.N, end = min((long long)(g + 1) * s.P * s.N, s.BP * s.N);
    int n = 0;
    for (long long i = first + lane; i < end; i += 32) n += valid[i] != 0;
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if (lane == 0) off[g + 1] = n;
}

// off = the exclusive prefix sums of the counts, in place (one block)
__global__ void __launch_bounds__(NTS) scan_kernel(int G, int* off) {
    __shared__ int tot[NTS];
    const int per = (G + NTS - 1) / NTS, g0 = threadIdx.x * per, g1 = min(g0 + per, G);
    int sum = 0;
    for (int g = g0; g < g1; ++g) sum += off[g + 1];
    tot[threadIdx.x] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
        int run = 0;
        for (int t = 0; t < NTS; ++t) {
            const int c = tot[t];
            tot[t] = run;
            run += c;
        }
        off[0] = 0;
    }
    __syncthreads();
    int run = tot[threadIdx.x];
    for (int g = g0; g < g1; ++g) {
        run += off[g + 1];
        off[g + 1] = run;
    }
}

// wt[kind][l] = the transpose of matrix `kind` of layer l
__global__ void __launch_bounds__(NTS) transpose_kernel(Weights w, Scratch sc, int L) {
    const int kind = blockIdx.x / L, l = blockIdx.x % L;
    const float* src = w.at(matrix_of(kind), l);
    float* dst = sc.wt_of(kind, l, L);
    for (int e = threadIdx.x; e < D * D; e += NTS) dst[(e % D) * D + e / D] = src[e];
}

// out[r] += LN backward of dy[r] at the row x(r) (scale s), one warp a
// row; keeps each row's mean and 1 / std for ln_partials
template <class XRow>
__device__ void ln_bwd(const float* dy, XRow x, const float* __restrict__ s, float* out, int R, float* mu_s,
                       float* rs_s) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < R; r += NT / 32) {
        const float* xr = x(r);
        float xh[D / 32], g[D / 32];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
            xh[j] = xr[lane + 32 * j];
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
        for (int j = 0; j < D / 32; ++j) out[r * LDS + lane + 32 * j] += (g[j] - m1 - xh[j] * m2) * rs;
        if (lane == 0) {
            mu_s[r] = mu;
            rs_s[r] = rs;
        }
    }
}

// the LayerNorm's scale and bias gradients of the block's rows added to
// its slice: ds[c] += sum_r dy[r, c] xhat[r, c], db[c] += sum_r dy[r, c]
// (after ln_bwd and a barrier; one thread a column, rows in order)
template <class XRow>
__device__ void ln_partials(const float* dy, XRow x, const float* mu_s, const float* rs_s, int R, float* ds,
                            float* db) {
    if (threadIdx.x < D) {
        const int c = threadIdx.x;
        float a = 0.f, bb = 0.f;
        for (int r = 0; r < R; ++r) {
            const float d = dy[r * LDS + c];
            a += d * ((x(r)[c] - mu_s[r]) * rs_s[r]);
            bb += d;
        }
        ds[c] += a;
        db[c] += bb;
    }
}

// The attention backward of one layer: dcat (DC) -> dq (device memory, gq),
// dk and dv (over K and V, and to gk, gv); the weights recomputed from q, k
// and the forward's arithmetic. Pass 1, a thread a (head, row i), q_i and
// dcat_i in registers: the weights P_i, dA_ij = (dcat_i . v_j) M0_ij,
// rsum_i = sum_j dA_ij P_ij, dS_ij = P_ij (dA_ij - rsum_i), dq_i = sum_j
// dS_ij k_j / sqrt(dh); the row's max, sum and rsum kept. Pass 2, a thread a
// (head, key j), k_j and v_j in registers: the column's dS and P M0 from the
// statistics, dk_j = sum_i dS_ij q_i / sqrt(dh), dv_j = sum_i P_ij M0_ij
// dcat_i. d_head <= 32, a multiple of 4.
__device__ void attention_bwd(const float* Q, float* K, float* V, const float* DC, const Block& b, int H,
                              const Dropout& drop, int site, float* st_m, float* st_l, float* st_r, float* gq,
                              float* gk, float* gv) {
    const int dh = D / H, R = b.R;
    const float sqrt_dh = sqrtf((float)dh);
    for (int w = threadIdx.x; w < H * R; w += NT) {
        const int r = w % R, h = w / R;
        const int s = b.rseg[r], j0 = b.seg0[s], n = b.seg0[s + 1] - j0;
        float qv[32];
        load_head(Q + r * LDS + h * dh, qv, dh);
        float sc[MAXN], da[MAXN];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= n) break;
            sc[j] = dot_head(qv, K + (j0 + j) * LDS + h * dh, dh) / sqrt_dh;
            m = fmaxf(m, sc[j]);
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= n) break;
            sc[j] = expf(sc[j] - m);
            sum += sc[j];
        }
        const unsigned long long row = ((unsigned long long)b.spoly[s] * H + h) * b.N + b.rnode[r];
        int c4 = -1;
        float f[4] = {1.f, 1.f, 1.f, 1.f};
        float rsum = 0.f;
        float gv4[32];  // dcat_i, loaded once q_i is no longer needed
        load_head(DC + r * LDS + h * dh, gv4, dh);
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= n) break;
            sc[j] = sc[j] / sum;
            const int nj = b.rnode[j0 + j];
            if (nj / 4 != c4) {
                c4 = nj / 4;
                tb_philox::factors4(drop, site, row, (uint32_t)c4, f);
            }
            da[j] = dot_head(gv4, V + (j0 + j) * LDS + h * dh, dh) * pick4(f, nj % 4);
            rsum += da[j] * sc[j];
        }
#pragma unroll
        for (int d = 0; d < 32; ++d) qv[d] = 0.f;  // now dq
#pragma unroll
        for (int j = 0; j < MAXN; ++j) {
            if (j >= n) break;
            axpy_head(qv, sc[j] * (da[j] - rsum), K + (j0 + j) * LDS + h * dh, dh);
        }
#pragma unroll
        for (int d = 0; d < 32; ++d) qv[d] = qv[d] / sqrt_dh;
        store_head(gq + (long long)r * D + h * dh, qv, dh);
        st_m[h * ROWS + r] = m;
        st_l[h * ROWS + r] = sum;
        st_r[h * ROWS + r] = rsum;
    }
    __syncthreads();
    for (int w = threadIdx.x; w < H * R; w += NT) {
        const int j = w % R, h = w / R;
        const int s = b.rseg[j], i0 = b.seg0[s], n = b.seg0[s + 1] - i0;
        const int nj = b.rnode[j];
        // (the arrays live one or two at a time, so that 512 threads' 128 registers hold them)
        float hv[32], ds[MAXN], pm[MAXN];
        load_head(K + j * LDS + h * dh, hv, dh);  // k_j: the weights P_ij into pm
#pragma unroll
        for (int i = 0; i < MAXN; ++i) {
            if (i >= n) break;
            const int ri = i0 + i;
            const float t = dot_head(hv, Q + ri * LDS + h * dh, dh);
            pm[i] = expf(t / sqrt_dh - st_m[h * ROWS + ri]) / st_l[h * ROWS + ri];
        }
        load_head(V + j * LDS + h * dh, hv, dh);  // v_j: dS_ij and P_ij M0_ij
#pragma unroll
        for (int i = 0; i < MAXN; ++i) {
            if (i >= n) break;
            const int ri = i0 + i;
            const float u = dot_head(hv, DC + ri * LDS + h * dh, dh);
            float f[4];
            tb_philox::factors4(drop, site, ((unsigned long long)b.spoly[s] * H + h) * b.N + b.rnode[ri],
                                (uint32_t)(nj / 4), f);
            const float fj = pick4(f, nj % 4);
            ds[i] = pm[i] * (u * fj - st_r[h * ROWS + ri]);
            pm[i] = pm[i] * fj;
        }
        // k_j and v_j are this thread's alone (read into registers above): written in place
#pragma unroll
        for (int d = 0; d < 32; ++d) hv[d] = 0.f;  // dk_j
#pragma unroll
        for (int i = 0; i < MAXN; ++i) {
            if (i >= n) break;
            axpy_head(hv, ds[i], Q + (i0 + i) * LDS + h * dh, dh);
        }
#pragma unroll
        for (int d = 0; d < 32; ++d) hv[d] = hv[d] / sqrt_dh;
        store_head(K + j * LDS + h * dh, hv, dh);
        store_head(gk + (long long)j * D + h * dh, hv, dh);
#pragma unroll
        for (int d = 0; d < 32; ++d) hv[d] = 0.f;  // dv_j
#pragma unroll
        for (int i = 0; i < MAXN; ++i) {
            if (i >= n) break;
            axpy_head(hv, pm[i], DC + (i0 + i) * LDS + h * dh, dh);
        }
        store_head(V + j * LDS + h * dh, hv, dh);
        store_head(gv + (long long)j * D + h * dh, hv, dh);
    }
}

// dst rows (shared) = src rows (device memory, row stride D)
__device__ void load_saved(const float* __restrict__ src, float* dst, int R) {
    for (int e = threadIdx.x; e < R * (D / 4); e += NT) {
        const int r = e / (D / 4), c = 4 * (e % (D / 4));
        *reinterpret_cast<float4*>(dst + r * LDS + c) = *reinterpret_cast<const float4*>(src + (long long)r * D + c);
    }
}

// The forward once over a group of polylines a block (K4f's body, group_forward
// with SAVE), each layer's tensors saved to device memory (compacted rows),
// then the max-pool backward, the rows' cotangent g saved.
__global__ void __launch_bounds__(NT, 1)
save_kernel(const float* __restrict__ x_in, const uint8_t* __restrict__ valid, const float* __restrict__ g_pool,
            Shape sh, Weights w, Dropout drop, Scratch sc) {
    extern __shared__ float4 smem4[];
    float* X = reinterpret_cast<float*>(smem4);  // the layer's input
    float* A1 = X + ROWS * LDS;
    float* A2 = A1 + ROWS * LDS;
    float* A3 = A2 + ROWS * LDS;
    float* A4 = A3 + ROWS * LDS;
    float* wsm = A4 + ROWS * LDS;
    __shared__ Block blk;

    const int N = sh.N, L = sh.L, P = sh.P, g = blockIdx.x;
    const long long poly0 = (long long)g * P;
    load_block(valid, sh.BP, N, poly0, P, blk);
    const int R = blk.R;
    if (R == 0) return;
    TB_NODE_BEGIN(3);
    const long long row0 = sc.off[g];
    load_rows(x_in, blk, X);
    __syncthreads();
    TB_NODE_MARK(3, 1);
    group_forward<3, true>(x_in, blk, L, sh.H, w, drop, X, A1, A2, A3, A4, wsm,
                           [&](int l, int s) { return sc.t(l, s) + row0 * D; },
                           [&](int l) { return sc.xl(l, L) + row0 * D; });
    TB_NODE_RESTART();

    // max-pool backward: each column's cotangent split among its tied maxima
    for (int e = threadIdx.x; e < P * D; e += NT) {
        const int p = e / D, c = e % D;
        if (poly0 + p >= sh.BP) break;
        float m = NEG, cnt = 0.f;
        for (int n = 0; n < N; ++n) {
            const int r = blk.nrow[p * N + n];
            if (r >= 0) m = fmaxf(m, X[r * LDS + c]);
        }
        for (int n = 0; n < N; ++n) {
            const int r = blk.nrow[p * N + n];
            if (r >= 0) cnt += X[r * LDS + c] == m ? 1.f : 0.f;
        }
        const float gc = g_pool[(poly0 + p) * D + c] / fmaxf(cnt, 1.f);
        for (int n = 0; n < N; ++n) {
            const int r = blk.nrow[p * N + n];
            if (r >= 0) X[r * LDS + c] = X[r * LDS + c] == m ? gc : 0.f;
        }
    }
    float* gs = sc.g_rows(L) + row0 * D;
    __syncthreads();
    for (int e = threadIdx.x; e < R * (D / 4); e += NT)
        *reinterpret_cast<float4*>(gs + (long long)(e / (D / 4)) * D + 4 * (e % (D / 4))) =
            *reinterpret_cast<const float4*>(X + (e / (D / 4)) * LDS + 4 * (e % (D / 4)));
    TB_NODE_MARK(3, 5);
}

__global__ void __launch_bounds__(NT, 1)
walk_kernel(const float* __restrict__ x_in, const uint8_t* __restrict__ valid, float* __restrict__ dx_out, Shape sh,
            Weights w, Dropout drop, Scratch sc) {
    extern __shared__ float4 smem4[];
    float* X = reinterpret_cast<float*>(smem4);  // the cotangent g of the layer's output
    float* DX0 = X + ROWS * LDS;                  // the cotangent of x0 through the K/V side
    float* A1 = DX0 + ROWS * LDS;
    float* A2 = A1 + ROWS * LDS;
    float* A3 = A2 + ROWS * LDS;
    float* A4 = A3 + ROWS * LDS;
    float* wsm = A4 + ROWS * LDS;
    __shared__ Block blk;
    __shared__ float st_m[MAXH * ROWS], st_l[MAXH * ROWS], st_r[MAXH * ROWS], mu_s[ROWS], rs_s[ROWS];

    const int N = sh.N, L = sh.L, H = sh.H, P = sh.P;
    float* vp = sc.vpart + (long long)blockIdx.x * L * 6 * D;  // this block's slice, column c owned by thread c
    if (threadIdx.x < D)
        for (int i = 0; i < L * 6; ++i) vp[i * D + threadIdx.x] = 0.f;

    for (int g = blockIdx.x; g < sh.G; g += gridDim.x) {
        __syncthreads();  // the previous group's reads of blk are done
        const long long poly0 = (long long)g * P;
        load_block(valid, sh.BP, N, poly0, P, blk);
        const int R = blk.R;
        for (int e = threadIdx.x; e < P * N * (D / 4); e += NT) {  // padding nodes: dx = 0
            const int pn = e / (D / 4);
            if (poly0 + pn / N < sh.BP && blk.nrow[pn] < 0)
                store4(dx_out + (poly0 * N + pn) * D + 4 * (e % (D / 4)), 0.f, 0.f, 0.f, 0.f);
        }
        if (R == 0) continue;
        TB_NODE_BEGIN(2);
        const long long row0 = sc.off[g];
        auto saved = [&](int l, int s) { return sc.t(l, s) + row0 * D; };
        load_saved(sc.g_rows(L) + row0 * D, X, R);
        for (int e = threadIdx.x; e < R * D; e += NT) DX0[(e / D) * LDS + e % D] = 0.f;
        __syncthreads();
        TB_NODE_MARK(2, 1);

        for (int l = L - 1; l >= 0; --l) {
            float* lv = vp + l * 6 * D;
            auto x1_row = [&](int r) -> const float* { return saved(l, X1) + (long long)r * D; };
            auto xl_row = [&](int r) -> const float* {
                return l == 0 ? x_in + blk.grow[r] * D : sc.xl(l, L) + (row0 + r) * D;
            };
            auto x0_row = [&](int r) -> const float* { return x_in + blk.grow[r] * D; };
            // df = g M3 (saved)
            float* gdf = saved(l, DF);
            for (int e = threadIdx.x; e < R * (D / 4); e += NT) {
                const int r = e / (D / 4), c0 = 4 * (e % (D / 4));
                float f[4];
                tb_philox::factors4(drop, 4 * l + 3, blk.grow[r], (uint32_t)(c0 / 4), f);
                const float* gr = X + r * LDS + c0;
                const float4 v = make_float4(gr[0] * f[0], gr[1] * f[1], gr[2] * f[2], gr[3] * f[3]);
                *reinterpret_cast<float4*>(A1 + r * LDS + c0) = v;
                *reinterpret_cast<float4*>(gdf + (long long)r * D + c0) = v;
            }
            // dz1 = (df W2ᵀ) M2 where the ReLU passed (fdo > 0: where M2 is 0, so is dz1) (saved)
            const float* gf = saved(l, FDO);
            float* gdz = saved(l, DZ1);
            dense<NS_B>(A1, sc.wt_of(5, l, L), wsm, R, [&](int r, int c0, const float (&y)[4]) {
                float f[4];
                tb_philox::factors4(drop, 4 * l + 2, blk.grow[r], (uint32_t)(c0 / 4), f);
                const float4 fd = *reinterpret_cast<const float4*>(gf + (long long)r * D + c0);
                const float4 v = make_float4(fd.x > 0.f ? y[0] * f[0] : 0.f, fd.y > 0.f ? y[1] * f[1] : 0.f,
                                             fd.z > 0.f ? y[2] * f[2] : 0.f, fd.w > 0.f ? y[3] * f[3] : 0.f);
                *reinterpret_cast<float4*>(A2 + r * LDS + c0) = v;
                *reinterpret_cast<float4*>(gdz + (long long)r * D + c0) = v;
            });
            // dsrc2b = dz1 W1ᵀ
            dense<NS_B>(A2, sc.wt_of(4, l, L), wsm, R, [&](int r, int c0, const float (&y)[4]) {
                store4(A3 + r * LDS + c0, y[0], y[1], y[2], y[3]);
            });
            __syncthreads();
            TB_NODE_MARK(2, 2);
            // g += LN2 backward at x1; its vector gradients
            ln_bwd(A3, x1_row, w.at(LN2_S, l), X, R, mu_s, rs_s);
            __syncthreads();
            ln_partials(A3, x1_row, mu_s, rs_s, R, lv + LN2_S * D, lv + LN2_B * D);
            __syncthreads();
            TB_NODE_MARK(2, 3);
            // da = g M1 (saved over x1)
            float* gda = saved(l, X1);
            for (int e = threadIdx.x; e < R * (D / 4); e += NT) {
                const int r = e / (D / 4), c0 = 4 * (e % (D / 4));
                float f[4];
                tb_philox::factors4(drop, 4 * l + 1, blk.grow[r], (uint32_t)(c0 / 4), f);
                const float* gr = X + r * LDS + c0;
                const float4 v = make_float4(gr[0] * f[0], gr[1] * f[1], gr[2] * f[2], gr[3] * f[3]);
                *reinterpret_cast<float4*>(A1 + r * LDS + c0) = v;
                *reinterpret_cast<float4*>(gda + (long long)r * D + c0) = v;
            }
            // dcat = da Woᵀ
            dense<NS_B>(A1, sc.wt_of(3, l, L), wsm, R, [&](int r, int c0, const float (&y)[4]) {
                store4(A2 + r * LDS + c0, y[0], y[1], y[2], y[3]);
            });
            __syncthreads();
            TB_NODE_MARK(2, 2);
            load_saved(saved(l, QS), A1, R);
            load_saved(saved(l, KS), A3, R);
            load_saved(saved(l, VS), A4, R);
            __syncthreads();
            attention_bwd(A1, A3, A4, A2, blk, H, drop, 4 * l, st_m, st_l, st_r, saved(l, QS), saved(l, KS),
                          saved(l, VS));
            __syncthreads();
            load_saved(saved(l, QS), A1, R);  // dq
            TB_NODE_MARK(2, 4);
            // dsrc2 = dq Wqᵀ;  dtgtn = dk Wkᵀ + dv Wvᵀ
            dense<NS_B>(A1, sc.wt_of(0, l, L), wsm, R, [&](int r, int c0, const float (&y)[4]) {
                store4(A2 + r * LDS + c0, y[0], y[1], y[2], y[3]);
            });
            dense<NS_B>(A3, sc.wt_of(1, l, L), wsm, R, [&](int r, int c0, const float (&y)[4]) {
                store4(A1 + r * LDS + c0, y[0], y[1], y[2], y[3]);
            });
            dense<NS_B>(A4, sc.wt_of(2, l, L), wsm, R, [&](int r, int c0, const float (&y)[4]) {
                float* o = A1 + r * LDS + c0;
                store4(o, o[0] + y[0], o[1] + y[1], o[2] + y[2], o[3] + y[3]);
            });
            __syncthreads();
            TB_NODE_MARK(2, 2);
            // g += LN1 backward at x_l;  dx0 += LN_tgt backward at x0; their vector gradients
            ln_bwd(A2, xl_row, w.at(LN1_S, l), X, R, mu_s, rs_s);
            __syncthreads();
            ln_partials(A2, xl_row, mu_s, rs_s, R, lv + LN1_S * D, lv + LN1_B * D);
            __syncthreads();
            ln_bwd(A1, x0_row, w.at(LNT_S, l), DX0, R, mu_s, rs_s);
            __syncthreads();
            ln_partials(A1, x0_row, mu_s, rs_s, R, lv + LNT_S * D, lv + LNT * D);
            __syncthreads();
            TB_NODE_MARK(2, 3);
        }
        for (int e = threadIdx.x; e < R * (D / 4); e += NT) {
            const int r = e / (D / 4), c0 = 4 * (e % (D / 4));
            const float* gr = X + r * LDS + c0;
            const float* hr = DX0 + r * LDS + c0;
            store4(dx_out + blk.grow[r] * D + c0, gr[0] + hr[0], gr[1] + hr[1], gr[2] + hr[2], gr[3] + hr[3]);
        }
        TB_NODE_MARK(2, 5);
    }
}

// part[split][m] = the sum over the split's rows, in order, of A_rᵀ B_r
// for product m = l NKIND + kind; bpart[split][m] = the column sums of B
// there. Thread (ti, tj) owns rows {4 ti .., 64 + 4 ti ..} x columns
// {4 tj .., 64 + 4 tj ..}; the A and B rows stream through two stages.
__global__ void __launch_bounds__(NTS) dw_kernel(Scratch sc, Shape sh) {
    extern __shared__ float4 smem4[];
    float* stg = reinterpret_cast<float*>(smem4);  // [2 stages][A, B][RC][D]
    const int L = sh.L, m = blockIdx.x, split = blockIdx.y, l = m / NKIND, kind = m % NKIND;
    const long long total = sc.off[sh.G];
    const long long r0 = total * split / NSPLIT, r1 = total * (split + 1) / NSPLIT;
    const float* A = sc.t(l, A_OF[kind]);
    const float* B = sc.t(l, B_OF[kind]);
    const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
    auto stage = [&](long long c, int st) {
        const int n = (int)min((long long)RC, r1 - c);
        float* sa = stg + st * 2 * RC * D;
        float* sb = sa + RC * D;
        for (int e = threadIdx.x; e < n * (D / 4); e += NTS) {
            const int r = e / (D / 4), cc = 4 * (e % (D / 4));
            cp_async16(sa + r * D + cc, A + (c + r) * D + cc);
            cp_async16(sb + r * D + cc, B + (c + r) * D + cc);
        }
    };
    float acc[8][8], bs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        bs[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (r0 < r1) stage(r0, 0);
    cp_async_commit();
    int st = 0;
    for (long long c = r0; c < r1; c += RC, st ^= 1) {
        if (c + RC < r1) stage(c + RC, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // this stage landed for every thread
        const float* sa = stg + st * 2 * RC * D;
        const float* sb = sa + RC * D;
        const int n = (int)min((long long)RC, r1 - c);
        for (int r = 0; r < n; ++r) {
            const float4 a0 = *reinterpret_cast<const float4*>(sa + r * D + 4 * ti);
            const float4 a1 = *reinterpret_cast<const float4*>(sa + r * D + 64 + 4 * ti);
            const float4 b0 = *reinterpret_cast<const float4*>(sb + r * D + 4 * tj);
            const float4 b1 = *reinterpret_cast<const float4*>(sb + r * D + 64 + 4 * tj);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            if (ti == 0)
#pragma unroll
                for (int j = 0; j < 8; ++j) bs[j] += bv[j];
        }
        __syncthreads();  // this stage is free for the load after next
    }
    float* out = sc.part + ((long long)split * NKIND * L + m) * D * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = i < 4 ? 4 * ti + i : 64 + 4 * ti + i - 4;
        store4(out + row * D + 4 * tj, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        store4(out + row * D + 64 + 4 * tj, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    if (ti == 0) {
        float* bp = sc.bpart + ((long long)split * NKIND * L + m) * D;
        store4(bp + 4 * tj, bs[0], bs[1], bs[2], bs[3]);
        store4(bp + 64 + 4 * tj, bs[4], bs[5], bs[6], bs[7]);
    }
}

// dw (the flat gradient of the 18 arrays, W_NAMES order) = the partials
// (matrices, biases) and the walk blocks' slices (LayerNorms), each summed
// in a fixed order
__global__ void __launch_bounds__(NTS) reduce_kernel(Scratch sc, Shape sh, float* __restrict__ dw) {
    const int L = sh.L;
    const long long n = n_params(L);
    for (long long i = blockIdx.x * (long long)NTS + threadIdx.x; i < n; i += (long long)gridDim.x * NTS) {
        int name = 0;
        while (name + 1 < N_NAMES && grad_off(name + 1, 0, L) <= i) ++name;
        const long long size = is_matrix(name) ? (long long)D * D : D, in = i - grad_off(name, 0, L);
        const int l = (int)(in / size);
        const long long e = in % size;
        float s = 0.f;
        if (name >= WQ) {
            const int m = l * NKIND + (name - WQ) / 2;
            for (int sp = 0; sp < NSPLIT; ++sp)
                s += is_matrix(name) ? sc.part[((long long)sp * NKIND * L + m) * D * D + e]
                                     : sc.bpart[((long long)sp * NKIND * L + m) * D + e];
        } else {
            for (int b = 0; b < sh.nblocks; ++b) s += sc.vpart[(((long long)b * L + l) * 6 + name) * D + e];
        }
        dw[i] = s;
    }
}

}  // namespace k4b

TB_NODE_PHASES("1 fwd_kernel (a group of polylines): rows loaded|layer norms|dense products|attention|pool;"
               "2 walk_kernel (a group of polylines): rows loaded|cotangent products|LayerNorm backward|"
               "attention backward|dx written;"
               "3 save_kernel (a group of polylines): rows loaded|layer norms|dense products|attention|"
               "max-pool backward, g saved")

namespace {

k4::Weights weights(const void* const* w) {
    k4::Weights ws;
    for (int i = 0; i < k4::N_NAMES; ++i) ws.p[i] = static_cast<const float*>(w[i]);
    return ws;
}

constexpr int NBLOCKS = 132;  // the walk's fixed grid (one block an SM on an H100)

}  // namespace

// The walk's fixed grid: the slices of the LayerNorm gradients it sums.
extern "C" int tb_node_encoder_train_nblocks() { return NBLOCKS; }

// *n = the floats of the backward's scratch at this shape (nblocks walk blocks).
extern "C" int tb_node_encoder_train_scratch(int BP, int N, int L, int nblocks, long long* n) {
    long long parts[6];
    *n = k4b::scratch_floats(k4b::shape_of(BP, N, L, 1, nblocks), parts);
    return 0;
}

// x [BP, N, 128] fp32, valid [BP, N] bool bytes, out [BP, 128] fp32; w the
// 18 device pointers in W_NAMES order (stacked over layers, matrices
// [L, 128, 128] in x @ W layout). Returns the cudaError_t of the launch.
extern "C" int tb_node_encoder_train_fwd(const void* x, const void* valid, void* out, int BP, int N, int L, int H,
                                         const void* const* w, unsigned long long seed, unsigned int threshold,
                                         float scale, int on, void* stream) {
    using namespace k4;
    if (N < 1 || N > MAXN || L < 1 || !heads_ok(H)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int P = ROWS_F / N;
    fwd_kernel<<<(BP + P - 1) / P, NT, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(valid), static_cast<float*>(out), BP, N, L, H,
        weights(w), tb_philox::Dropout{seed, threshold, scale, on});
    return (int)cudaGetLastError();
}

// The backward: g [BP, 128] -> dx [BP, N, 128] and dw, the flat gradient of
// the 18 arrays (n_params(L) floats, W_NAMES order). scratch holds
// tb_node_encoder_train_scratch(BP, N, L, nblocks) floats, uninitialised.
// Seven launches: count, scan, transpose, save, walk, dw, reduce.
extern "C" int tb_node_encoder_train_bwd(const void* x, const void* valid, const void* g, void* dx, void* scratch,
                                         void* dw, int BP, int N, int L, int H, const void* const* w,
                                         unsigned long long seed, unsigned int threshold, float scale, int on,
                                         int nblocks, void* stream) {
    using namespace k4b;
    if (N < 1 || N > MAXN || L < 1 || !heads_ok(H) || H > MAXH || nblocks < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Shape sh = shape_of(BP, N, L, H, nblocks);
    const Scratch sc = carve(static_cast<float*>(scratch), sh);
    const k4::Weights ws = weights(w);
    count_kernel<<<(sh.G + 7) / 8, NTS, 0, st>>>(static_cast<const uint8_t*>(valid), sh, sc.off);
    scan_kernel<<<1, NTS, 0, st>>>(sh.G, sc.off);
    transpose_kernel<<<NKIND * L, NTS, 0, st>>>(ws, sc, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(save_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SAVE_SMEM);
    if (err != cudaSuccess) return (int)err;
    save_kernel<<<sh.G, NT, SAVE_SMEM, st>>>(static_cast<const float*>(x), static_cast<const uint8_t*>(valid),
                                               static_cast<const float*>(g), sh, ws,
                                               tb_philox::Dropout{seed, threshold, scale, on}, sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WALK_SMEM);
    if (err != cudaSuccess) return (int)err;
    walk_kernel<<<nblocks, NT, WALK_SMEM, st>>>(static_cast<const float*>(x), static_cast<const uint8_t*>(valid),
                                                static_cast<float*>(dx), sh, ws,
                                                tb_philox::Dropout{seed, threshold, scale, on}, sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DW_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_dw(NKIND * L, NSPLIT);
    dw_kernel<<<grid_dw, NTS, DW_SMEM, st>>>(sc, sh);
    reduce_kernel<<<(int)((n_params(L) + NTS - 1) / NTS), NTS, 0, st>>>(sc, sh, static_cast<float*>(dw));
    return (int)cudaGetLastError();
}

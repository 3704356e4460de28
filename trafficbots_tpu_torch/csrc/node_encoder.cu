// DenseTNT polyline-node encoder + masked max-pool for Hopper (sm_90a),
// plain C interface.
//
// Replaces: trafficbots_tpu/ops/node_encoder.py,
// FusedNodeEncoder.encode_pooled -> _node_kernel / _node_kernel_body (the
// Pallas TPU kernel). Same function, per polyline of N <= 32 nodes and
// n_layer pre-norm layers with d_model = d_ff = 128:
//   q = LN1(x) Wq + bq;  k, v = LN_tgt(x0) Wk|Wv + b   (x0 = layer-0 input)
//   a = softmax(q_h k_hᵀ / sqrt(dh), padded nodes masked) v_h per head;
//       a polyline without a valid node runs unmasked and a is zeroed
//   x += a Wo + bo;  x += relu(LN2(x) W1 + b1) W2 + b2;  invalid rows = 0
// then the max over valid nodes (-1e30 for a polyline without one). All
// arithmetic is fp32; LayerNorm uses eps 1e-5 and the two-pass variance.
//
// What bounds it on the card: the fp32 operations, 6 dense 128 x 128
// products a valid node a layer (2 x 6 x 128 x 128 = 197 kFLOP) plus the
// small per-polyline attention: ~47 GFLOP at 8 scenes x 1024 polylines x 20
// nodes (6,143 valid polylines, ~80k valid nodes) x 3 layers, against
// ~85 MB read, far on the operations side of the CUDA cores' 20 FLOP/B.
//
// Design (csrc/node_layer.cuh; the phase trace of the first design, 2
// polylines a block with every product's weights read from L2 by
// latency-bound loads, gave the dense products 71% of a block's cycles and
// the attention 25%): a block takes a group of ROWS / N polylines (3 at
// N = 20) and holds only their valid nodes, so padding costs nothing and an
// all-padding polyline only its -1e30; the weights stream through shared
// memory by cp.async, 32-row k-tiles three in flight, into the register
// tiles of 512 threads (4 rows x 4 columns each); the attention holds a
// row's q and output in registers and reads K and V rows by float4. Five
// [64, 132] buffers (x, LN output, q / attention output / FFN hidden, k,
// v) and the weight ring take 213 KB: one 16-warp block an SM. x0 is read
// from device memory (L2) at each layer's LN_tgt. Only the pooled [128]
// row of each polyline is written. Every sum runs in the first design's
// order, so the output is the first design's to the bit. No tensor cores:
// fp32 products on the CUDA cores, as the closed loop's ulp sensitivity
// needs. On an H100 at 700 W: 3.21-3.22 ms at the main path's 8 scenes
// (the first design 8.43-8.44 in the same run), 4.6x its bound (PERF.md).
//
// K2-bf16 (tb_node_encoder_bf16, map_encoder.kernel_matmul_bf16): the same
// blocks and order, with every dense product on the tensor cores
// (node_layer.cuh dense_mma: the rows rounded once into a bf16 buffer, the
// weights read once a block from L2 and rounded into a bf16 copy, bf16 MMAs
// with fp32 accumulation) and the attention's products on bf16 values on
// the CUDA cores (q, k and v rounded as their projections store them). Its
// bound is the products at 989 TFLOP/s bf16 (0.0475 ms at the main path's
// shape); what is left is the LayerNorms, the small attention, the pool and
// each block's read of the fp32 weights from L2: 1.18 ms on an H100
// (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "node_layer.cuh"

namespace {

using namespace tb_node;

constexpr int ROWS = 64;      // rows (valid nodes) a block holds
constexpr int NBUF = 5;       // x, t, q/a, k, v
// the row buffers, then the weight ring (K2) or dense_mma's bf16 rows and weight (K2-bf16)
template <bool BF>
constexpr size_t smem_bytes() {
    return sizeof(float) * NBUF * ROWS * LDS + (BF ? MMA_BYTES : sizeof(float) * ring_floats<3>());
}
static_assert(ROWS <= RCAP && smem_bytes<false>() + sizeof(Block) <= SMEM_OPTIN &&
                  smem_bytes<true>() + sizeof(Block) <= SMEM_OPTIN,
              "the buffers must fit one block's shared memory");

// in @ W through epi: on the tensor cores for K2-bf16 (dense_mma), else
// the fp32 CUDA-core products with three weight k-tiles in flight
template <bool BF, class Epi>
__device__ __forceinline__ void project(const float* in, const float* __restrict__ W, float* wsm, int R, Epi epi) {
    if constexpr (BF)
        dense_mma(in, W, wsm, R, epi);
    else
        dense<3>(in, W, wsm, R, epi);
}

struct NodeWeights {
    const float *ln1_s, *ln1_b, *lnt_s, *lnt_b, *ln2_s, *ln2_b;
    const float *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo, *w1, *b1, *w2, *b2;
};

template <bool BF>
__global__ void __launch_bounds__(NT, 1)
node_kernel(const float* __restrict__ x_in, const uint8_t* __restrict__ valid, float* __restrict__ out,
            long long BP, int N, int n_layer, int n_head, NodeWeights w) {
    extern __shared__ float4 smem4[];  // 16-byte aligned for the float4 row loads
    float* x = reinterpret_cast<float*>(smem4);
    float* t = x + ROWS * LDS;
    float* q = t + ROWS * LDS;  // q, then the attention output, then the FFN hidden
    float* k = q + ROWS * LDS;
    float* v = k + ROWS * LDS;
    float* wsm = v + ROWS * LDS;
    __shared__ Block blk;

    const int P = ROWS / N;
    const long long poly0 = (long long)blockIdx.x * P;
    load_block(valid, BP, N, poly0, P, blk);
    const int R = blk.R;
    if (R == 0) {  // all padding: the pool identity, as the TPU kernel's skip writes
        for (int e = threadIdx.x; e < P * D; e += NT)
            if (poly0 + e / D < BP) out[(poly0 + e / D) * D + e % D] = NEG;
        return;
    }
    TB_NODE_BEGIN(0);
    load_rows(x_in, blk, x);
    __syncthreads();
    TB_NODE_MARK(0, 1);

    const Dropout none{0, 0, 1.f, 0};
    // q, k and v as the attention takes them: rounded to bf16 for K2-bf16
    auto op = [](float x) { return BF ? round_bf16(x) : x; };
    for (int l = 0; l < n_layer; ++l) {
        const int lv = l * D, lm = l * D * D;
        layer_norm_x0(x_in, blk, t, w.lnt_s + lv, w.lnt_b + lv);
        TB_NODE_MARK(0, 2);
        const float* bk = w.bk + lv;
        project<BF>(t, w.wk + lm, wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(bk, c0);
            store4(k + r * LDS + c0, op(y[0] + b.x), op(y[1] + b.y), op(y[2] + b.z), op(y[3] + b.w));
        });
        const float* bv = w.bv + lv;
        project<BF>(t, w.wv + lm, wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(bv, c0);
            store4(v + r * LDS + c0, op(y[0] + b.x), op(y[1] + b.y), op(y[2] + b.z), op(y[3] + b.w));
        });
        __syncthreads();
        TB_NODE_MARK(0, 3);
        layer_norm(x, t, w.ln1_s + lv, w.ln1_b + lv, R);
        TB_NODE_MARK(0, 2);
        const float* bq = w.bq + lv;
        project<BF>(t, w.wq + lm, wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(bq, c0);
            store4(q + r * LDS + c0, op(y[0] + b.x), op(y[1] + b.y), op(y[2] + b.z), op(y[3] + b.w));
        });
        __syncthreads();
        TB_NODE_MARK(0, 3);
        attention<false, BF>(q, k, v, q, blk, n_head, none, 0);
        __syncthreads();
        TB_NODE_MARK(0, 4);
        const float* bo = w.bo + lv;
        project<BF>(q, w.wo + lm, wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(bo, c0);
            float* o = x + r * LDS + c0;
            store4(o, o[0] + (y[0] + b.x), o[1] + (y[1] + b.y), o[2] + (y[2] + b.z), o[3] + (y[3] + b.w));
        });
        __syncthreads();
        TB_NODE_MARK(0, 3);
        layer_norm(x, t, w.ln2_s + lv, w.ln2_b + lv, R);
        TB_NODE_MARK(0, 2);
        const float* b1 = w.b1 + lv;
        project<BF>(t, w.w1 + lm, wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(b1, c0);
            store4(q + r * LDS + c0, fmaxf(y[0] + b.x, 0.f), fmaxf(y[1] + b.y, 0.f), fmaxf(y[2] + b.z, 0.f),
                   fmaxf(y[3] + b.w, 0.f));
        });
        const float* b2 = w.b2 + lv;
        project<BF>(q, w.w2 + lm, wsm, R, [&](int r, int c0, const float (&y)[4]) {
            const float4 b = bias4(b2, c0);
            float* o = x + r * LDS + c0;
            store4(o, o[0] + (y[0] + b.x), o[1] + (y[1] + b.y), o[2] + (y[2] + b.z), o[3] + (y[3] + b.w));
        });
        __syncthreads();
        TB_NODE_MARK(0, 3);
    }

    // the max over each polyline's valid nodes (-1e30 for one without)
    for (int e = threadIdx.x; e < P * D; e += NT) {
        const int p = e / D, c = e % D;
        if (poly0 + p >= BP) break;
        float m = NEG;
        for (int n = 0; n < N; ++n) {
            const int r = blk.nrow[p * N + n];
            if (r >= 0) m = fmaxf(m, x[r * LDS + c]);
        }
        out[(poly0 + p) * D + c] = m;
    }
    TB_NODE_MARK(0, 5);
}

template <bool BF>
int launch(const void* x, const void* valid, void* out, int BP, int N, int n_layer, int n_head, const void* const* w,
           void* stream) {
    if (N < 1 || N > MAXN || !heads_ok(n_head)) return (int)cudaErrorInvalidValue;
    const float* const* f = reinterpret_cast<const float* const*>(w);
    NodeWeights nw{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                   f[9], f[10], f[11], f[12], f[13], f[14], f[15], f[16], f[17]};
    constexpr size_t SMEM = smem_bytes<BF>();
    cudaError_t err = cudaFuncSetAttribute(node_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    const int P = ROWS / N;
    const int grid = (BP + P - 1) / P;
    node_kernel<BF><<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(valid), static_cast<float*>(out), BP, N, n_layer,
        n_head, nw);
    return (int)cudaGetLastError();
}

}  // namespace

TB_NODE_PHASES("0 node_kernel (a group of polylines): rows loaded|layer norms|dense products|attention|pool")

// x [BP, N, 128] fp32, valid [BP, N] bool bytes, out [BP, 128] fp32; w is a
// host array of the 18 device pointers in the order ln1_s, ln1_b, lnt_s,
// lnt_b, ln2_s, ln2_b, wq, bq, wk, bk, wv, bv, wo, bo, w1, b1, w2, b2 (each
// stacked over layers, matrices [L, 128, 128] in x @ W layout). Returns the
// cudaError_t of the launch.
extern "C" int tb_node_encoder(const void* x, const void* valid, void* out, int BP, int N, int n_layer, int n_head,
                               const void* const* w, void* stream) {
    return launch<false>(x, valid, out, BP, N, n_layer, n_head, w, stream);
}

// K2's bf16 variant (map_encoder.kernel_matmul_bf16): the same arguments;
// every product on operands rounded to bf16 (BF in node_layer.cuh).
extern "C" int tb_node_encoder_bf16(const void* x, const void* valid, void* out, int BP, int N, int n_layer,
                                    int n_head, const void* const* w, void* stream) {
    return launch<true>(x, valid, out, BP, N, n_layer, n_head, w, stream);
}

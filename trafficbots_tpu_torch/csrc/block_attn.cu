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
// fp32): 5 FLOP a byte, so the bytes bound it.
//
// The first design (one polyline a 128-thread block, 4-byte loads, thread 0
// scanning the validity, load, logits, softmax and AV one after another
// behind barriers; 37 KB of shared memory, six blocks an SM) ran at 0.346 ms,
// about 29% of the HBM rate. This design keeps HBM busy:
//   - a persistent grid (as many 160-thread blocks as fit the SMs, three on
//     an H100) walks the polylines with a stride; each block double-buffers
//     them in shared memory: polyline i + 1's q, k, v (three contiguous
//     N x D tiles) are in flight by cp.async 16-byte copies while polyline i
//     computes, and the block then writes polyline i's output rows by float4,
//     each row contiguous;
//   - the validity of polyline i + 1 is read into a register beside its
//     copies, and a warp ballot turns it into the node mask;
//   - two neighbouring lanes a (head, query) row: each the scores of half of
//     the nodes (q and the K rows read by float4; a head's columns padded so
//     that the heads a warp reads lie in other banks), exchanged by a
//     shuffle; the same softmax in both; each half of the output columns
//     (V rows by float4), written over the row's own q slice. The split
//     doubles the lanes at work, and the latency-bound rows need them: with
//     one lane a row (80 of a 128-thread block's lanes at work) the call
//     took 0.184 ms, with one lane for two rows 0.268 (PERF.md).
// The kernel is instantiated for NB = N rounded up to 4 nodes; the rows past
// N are zero, their scores masked to -inf (exp gives exactly 0), so no loop
// over nodes tests N. The arithmetic per element is the first design's: the
// logits (sum_d fmaf(q, k)) * scale + mask with the sum in d order, the exact
// row max, expf, the sum and the division in t order, the AV sum by fmaf in
// t order; the padding terms add exact zeros, so the output is the first
// design's to the bit. On an H100 80GB HBM3 at a 700.00 W power limit, at
// the main path's 8 scenes (BP = 8192): 0.159 ms on the device (the first
// design 0.347-0.348 in the same run), 1.6x its bound, about 63% of the HBM
// rate (PERF.md).
//
// K6-bf16 (tb_block_attn_bf16, map_encoder.kernel_matmul_bf16; the TPU
// kernel's bf16=True) runs both products on the tensor cores: mma.sync
// m16n8k16 on bf16 operands with fp32 accumulation (mma.cuh), the TPU
// kernel's function: logits = (q_h in bf16) (k_h in bf16)^T summed in fp32,
// then * scale + mask in fp32 (the scale not folded into q), the exact row
// max over the whole row, the fp32 softmax, each weight rounded to bf16
// (to nearest even) times v_h in bf16, summed in fp32; an fp32 output.
// block_attn_mma keeps the fp32 kernel's persistent grid, its
// double-buffered cp.async staging of the three fp32 tiles and its ballot,
// and rounds at the fragment loads (cvt.rn.bf16x2 of fp32 pairs for q and
// the K rows, two scalar loads a register for the V rows): no rounding pass
// and no barrier between a polyline's landing and its compute. A warp owns
// a (polyline, head) (four warps a block, three blocks an SM): its logits
// stay in C fragments (rows padded to 16, keys to 8, d_head to 16 with
// zeros at the loads), the row max and sum go over the n-tiles and the lane
// quad, exp and the division (div_rn) are made in place, two n-tiles' C
// fragments become a P V k-step's A fragment, and the output goes over the
// head's q columns to the fp32 kernel's float4 stores. At the main shape (4
// heads of 32) a head's fragment reads are 16 + 12 float2 pairs and 32
// scalars a lane, conflict-free (the q and k rows 8 mod 16 floats apart,
// the v rows an odd multiple of 4): ~44 KB a polyline against the fp32
// design's ~430 KB of float4 reads. On an H100 80GB HBM3 at a 700.00 W
// power limit, at the main path's 8 scenes: 0.121 ms on the device, 83% of
// the HBM bound; the same staging and stores without the compute take
// 0.113 ms (a third stage, at two blocks an SM, gains nothing), the fp32
// kernel 0.159 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "mma.cuh"
#include "node_trace.cuh"

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

namespace {

constexpr int MAXN = 32;    // KERNEL_MAX_NODES in the wrapper
constexpr int MAXD = 256;   // KERNEL_MAX_D in the wrapper
constexpr int NT = 160;     // threads a block (the fp32 kernel)
constexpr int NT_MMA = 128;  // threads a block (the bf16 kernel): a warp a head at a time
constexpr int SMEM_OPTIN = 232448;  // bytes of shared memory a block may opt in to on sm_90

// The shared layout of one stage: q, k, v of one polyline, NB rows of RS
// floats each; column c of row s at s RS + (c / dh) HS + c % dh. A head's
// columns are rounded up to 4 (float4 reads; the rounding is zero) and, where
// that is a multiple of 32 floats, padded by 4, so that the two heads a warp
// reads lie in other banks; the row stride is an odd multiple of 4 floats, so
// that eight rows read by float4 cover the 32 banks.
__host__ __device__ inline int head_stride(int dh) {
    const int d4 = (dh + 3) / 4 * 4;
    return d4 % 32 == 0 ? d4 + 4 : d4;
}
__host__ __device__ inline int row_stride(int H, int dh) {
    const int rs = H * head_stride(dh);
    return (rs / 4) % 2 ? rs : rs + 4;
}
inline size_t smem_bytes(int N, int D, int H) {  // two stages; smem_bytes in the wrapper
    return sizeof(float) * 2 * 3 * (size_t)((N + 3) / 4 * 4) * row_stride(H, D / H);
}

// One thread's share of the copies of an N x D tile between device memory and
// a stage: column c (4 at a time where dh % 4 == 0, else 1) of rows
// r0, r0 + rpp, ...; off its offset in a stage row.
struct Lane {
    int vec, c, r0, rpp, off;
};

__device__ inline Lane copy_lane(int D, int dh, int HS, int nt = NT) {
    Lane ln;
    ln.vec = dh % 4 == 0;
    const int per_row = ln.vec ? D / 4 : D;  // chunks a row
    ln.rpp = nt / per_row;
    ln.r0 = threadIdx.x < ln.rpp * per_row ? threadIdx.x / per_row : MAXN;  // idle past the last whole row
    ln.c = (ln.vec ? 4 : 1) * (threadIdx.x % per_row);
    ln.off = (ln.c / dh) * HS + ln.c % dh;
    return ln;
}

// sc[t] = softmax_t(sc[t] * scale + mask[t]) over a row's NB scores: the
// mask -1e30 at a padded node of a polyline with a valid node (bits: the
// valid ones), -inf past N; the exact max, expf, the sum and the division
// in t order
template <int NB>
__device__ __forceinline__ void softmax(float (&sc)[NB], float scale, int N, unsigned bits, bool any) {
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < NB; ++t) {
        const float mask = t >= N ? -INFINITY : (any && !((bits >> t) & 1u)) ? -1e30f : 0.f;
        sc[t] = sc[t] * scale + mask;
        m = fmaxf(m, sc[t]);
    }
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < NB; ++t) {
        sc[t] = expf(sc[t] - m);
        sum += sc[t];
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) sc[t] = sc[t] / sum;
}

// the output columns 4 c0 .. of a row, up to 4 end, over its q slice (a
// head's columns stop at dh: where dh % 4 != 0 its q pad stays 0)
__device__ __forceinline__ void store_out(float* Q, const float (&acc)[16], int c0, int end, int dh, int vec) {
#pragma unroll
    for (int d4 = 0; d4 < 4; ++d4) {
        const int d = 4 * (c0 + d4);
        if (vec && c0 + d4 < end) {
            *reinterpret_cast<float4*>(Q + d) = make_float4(acc[4 * d4], acc[4 * d4 + 1], acc[4 * d4 + 2], acc[4 * d4 + 3]);
        } else if (!vec && c0 + d4 < end) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (d + u < dh) Q[d + u] = acc[4 * d4 + u];
        }
    }
}

template <int NB>
__global__ void __launch_bounds__(NT)
block_attn_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const uint8_t* __restrict__ valid, float* __restrict__ out, long long BP, int N, int D, int H,
                  float scale) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int dh = D / H, HS = head_stride(dh), RS = row_stride(H, dh), HS4 = (dh + 3) / 4;
    const int tile = NB * RS, stage_floats = 3 * tile;
    const int lane = threadIdx.x % 32;
    const Lane cp = copy_lane(D, dh, HS);

    // the pads (rows N .. NB - 1, a head's columns past dh) are never
    // written: zero in both stages
    for (int i = threadIdx.x; i < 2 * stage_floats; i += NT) smem[i] = 0.f;
    __syncthreads();

    auto stage = [&](long long p, float* dst) {
        const float* src[3] = {q, k, v};
#pragma unroll
        for (int t = 0; t < 3; ++t) {
            const float* s0 = src[t] + p * N * D + cp.c;
            float* d0 = dst + t * tile + cp.off;
            for (int s = cp.r0; s < N; s += cp.rpp) {
                if (cp.vec)
                    cp_async16(d0 + s * RS, s0 + (long long)s * D);
                else
                    d0[s * RS] = __ldg(s0 + (long long)s * D);
            }
        }
    };

    long long p = blockIdx.x;
    uint8_t flag = lane < N ? valid[p * N + lane] : 0;  // node `lane` of polyline p
    stage(p, smem);
    cp_async_commit();
    for (int it = 0; p < BP; ++it, p += gridDim.x) {
        TB_NODE_BEGIN(0);
        float* cur = smem + (it & 1) * stage_floats;
        const unsigned bits = __ballot_sync(0xffffffffu, flag != 0);  // bit t: node t valid
        const bool any = bits != 0u;
        cp_async_wait<0>();
        __syncthreads();  // polyline p landed; the last polyline's output rows (the other stage) are written
        TB_NODE_MARK(0, 1);
        const long long pn = p + gridDim.x;
        if (pn < BP) {
            flag = lane < N ? valid[pn * N + lane] : 0;
            stage(pn, smem + ((it + 1) & 1) * stage_floats);
        }
        cp_async_commit();
        TB_NODE_MARK(0, 2);

        // two threads a (head, query) row, lanes 2 i and 2 i + 1: the scores of
        // the first and the second half of the nodes, exchanged; the same
        // softmax in both; the first and the second half of the output columns
        const int n_task = 2 * H * N;
        for (int w0 = threadIdx.x - lane; w0 < n_task; w0 += NT) {  // whole warps: every lane takes the shuffles
            const int w = min(w0 + lane, n_task - 2 + (lane & 1));   // past the last row: the last row again, not stored
            const bool act = w0 + lane < n_task;
            const int half = w & 1, r = w >> 1, h = r / N, s = r % N;
            constexpr int NH = NB / 2;
            float* Q = cur + s * RS + h * HS;  // q, then the output
            const float* K = cur + tile + h * HS + half * NH * RS;
            const float* V = cur + 2 * tile + h * HS;
            float own[NH];
#pragma unroll
            for (int t = 0; t < NH; ++t) own[t] = 0.f;
            for (int d4 = 0; d4 < HS4; ++d4) {
                const float4 a = *reinterpret_cast<const float4*>(Q + 4 * d4);
#pragma unroll
                for (int t = 0; t < NH; ++t) {
                    const float4 b = *reinterpret_cast<const float4*>(K + t * RS + 4 * d4);
                    own[t] = fmaf(a.x, b.x, own[t]);
                    own[t] = fmaf(a.y, b.y, own[t]);
                    own[t] = fmaf(a.z, b.z, own[t]);
                    own[t] = fmaf(a.w, b.w, own[t]);
                }
            }
            float sc[NB];
#pragma unroll
            for (int t = 0; t < NH; ++t) {
                const float other = __shfl_xor_sync(0xffffffffu, own[t], 1);
                sc[t] = half ? other : own[t];
                sc[NH + t] = half ? own[t] : other;
            }
            softmax<NB>(sc, scale, N, bits, any);
            const int mid = (HS4 + 1) / 2, lo = half ? mid : 0, hi = half ? HS4 : mid;
            for (int c0 = lo; c0 < hi; c0 += 4) {
                float acc[16];
#pragma unroll
                for (int d = 0; d < 16; ++d) acc[d] = 0.f;
#pragma unroll
                for (int t = 0; t < NB; ++t) {
#pragma unroll
                    for (int d4 = 0; d4 < 4; ++d4) {
                        if (c0 + d4 < hi) {
                            const float4 b = *reinterpret_cast<const float4*>(V + t * RS + 4 * (c0 + d4));
                            acc[4 * d4] = fmaf(sc[t], b.x, acc[4 * d4]);
                            acc[4 * d4 + 1] = fmaf(sc[t], b.y, acc[4 * d4 + 1]);
                            acc[4 * d4 + 2] = fmaf(sc[t], b.z, acc[4 * d4 + 2]);
                            acc[4 * d4 + 3] = fmaf(sc[t], b.w, acc[4 * d4 + 3]);
                        }
                    }
                }
                if (act) store_out(Q, acc, c0, hi, dh, cp.vec);
            }
        }
        TB_NODE_MARK(0, 3);
        __syncthreads();  // the output rows are in the q tile
        TB_NODE_MARK(0, 4);

        float* o0 = out + p * N * D + cp.c;
        const float* q0 = cur + cp.off;
        for (int s = cp.r0; s < N; s += cp.rpp) {
            if (cp.vec)
                *reinterpret_cast<float4*>(o0 + (long long)s * D) = *reinterpret_cast<const float4*>(q0 + s * RS);
            else
                o0[(long long)s * D] = q0[s * RS];
        }
        TB_NODE_MARK(0, 5);
    }
}

// ---- K6-bf16 on the tensor cores

// The bf16 kernel's stage: q, k and v of one polyline, N rows each (no row
// padding: the fragment loads give 0 past row N); column c of a row at
// (c / dh) HS + c % dh, HS = dh rounded up to 4 (the rounding zero, never
// written). The q and k rows are RQ = 8 mod 16 floats apart, so that a
// fragment's float2 reads (rows g, columns 2t: 4 rows by 4 lanes a half
// warp) cover the 32 banks; the v rows RV, an odd multiple of 4 floats, so
// that its scalar reads (rows 2t, columns g: 4 rows by 8 lanes) do. Where
// that padding would not fit (a few shapes at d_head 1), the rows are H HS
// apart: never more than the fp32 kernel's stage, which the caller checked.
struct MmaLayout {
    int HS, RQ, RV;
};
__host__ __device__ inline MmaLayout mma_layout(int N, int H, int dh) {
    const int HS = (dh + 3) / 4 * 4, X = H * HS;
    const MmaLayout padded = {HS, X + (24 - X % 16) % 16, X % 8 ? X : X + 4};
    return sizeof(float) * 2 * N * (2 * padded.RQ + padded.RV) <= SMEM_OPTIN ? padded : MmaLayout{HS, X, X};
}
inline size_t mma_smem_bytes(int N, int D, int H) {  // two stages
    const MmaLayout L = mma_layout(N, H, D / H);
    return sizeof(float) * 2 * (size_t)N * (2 * L.RQ + L.RV);
}

// fp32 (r, c) and (r, c + 1) of a staged tile (row stride ld) as a bf16x2
// register, rounded to nearest even; 0 at row n or past, or column dh or
// past (column dh itself, for an odd dh, is a head's zero rounding)
__device__ __forceinline__ uint32_t pair_bf16(const float* m, int ld, int r, int c, int n, int dh) {
    if (r >= n || c >= dh) return 0u;
    const float2 x = *reinterpret_cast<const float2*>(m + r * ld + c);
    return pack_bf16(x.x, x.y);
}
__device__ __forceinline__ float at(const float* m, int ld, int r, int c, int n, int dh) {
    return r < n && c < dh ? m[r * ld + c] : 0.f;
}

// The fragments (mma.cuh's layout) of a staged fp32 tile, rounded: A of
// the 16 x 16 tile at rows r0.., columns k0..; B n-major (K rows: B[k][n]
// at row n, column k) of the 16 x 8 tile at (k0, n0); B k-major (V rows:
// B[k][n] at row k, column n).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float* m, int ld, int r0, int k0, int n, int dh) {
    const int r = r0 + ((threadIdx.x & 31) >> 2), c = k0 + 2 * (threadIdx.x & 3);
    a[0] = pair_bf16(m, ld, r, c, n, dh);
    a[1] = pair_bf16(m, ld, r + 8, c, n, dh);
    a[2] = pair_bf16(m, ld, r, c + 8, n, dh);
    a[3] = pair_bf16(m, ld, r + 8, c + 8, n, dh);
}
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[2], const float* m, int ld, int k0, int n0, int n, int dh) {
    const int r = n0 + ((threadIdx.x & 31) >> 2), c = k0 + 2 * (threadIdx.x & 3);
    b[0] = pair_bf16(m, ld, r, c, n, dh);
    b[1] = pair_bf16(m, ld, r, c + 8, n, dh);
}
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[2], const float* m, int ld, int k0, int n0, int n, int dh) {
    const int r = k0 + 2 * (threadIdx.x & 3), c = n0 + ((threadIdx.x & 31) >> 2);
    b[0] = pack_bf16(at(m, ld, r, c, n, dh), at(m, ld, r + 1, c, n, dh));
    b[1] = pack_bf16(at(m, ld, r + 8, c, n, dh), at(m, ld, r + 9, c, n, dh));
}

// x / d rounded to nearest, for d > 0 given r = 1 / d: attn_fwd.cuh's
// div_rn (the product by the reciprocal and one FMA correction, the IEEE
// quotient bit for bit for normal x; tests/test_torch_cuda_emu.py holds it
// to x / d). With the IEEE division the softmax phase took 6.0K cycles a
// polyline at the main shape, with div_rn 1.5K (phase trace, PERF.md).
__device__ __forceinline__ float div_rn(float x, float d, float r) {
    const float q = x * r;
    return fmaf(fmaf(-q, d, x), r, q);
}

// One warp's head of one polyline: Q, K, V the head's columns of the staged
// tiles, mk[j][e] the mask of the lane's key 8 j + 2t + e (-inf at N or
// past). The logits of the MW m-tiles of 16 query rows over NJ n-tiles of 8
// keys stay in C fragments z (lane (g, t): rows g, g + 8, keys 2t, 2t + 1);
// the output goes over Q's rows below N.
template <int NJ>
__device__ __forceinline__ void head_mma(float* Q, const float* K, const float* V, int RQ, int RV, int N, int dh,
                                         float scale, const float (&mk)[NJ][2]) {
    constexpr int KS = (NJ + 1) / 2, MW = KS;  // k-steps of 16 keys in P V; m-tiles of 16 rows
    const int g = (threadIdx.x & 31) >> 2, t2 = 2 * (threadIdx.x & 3);
    TB_NODE_RESUME();
    float z[MW][NJ][4];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j) z[mt][j][0] = z[mt][j][1] = z[mt][j][2] = z[mt][j][3] = 0.f;
    for (int k0 = 0; k0 < dh; k0 += 16) {
        uint32_t fa[MW][4];
#pragma unroll
        for (int mt = 0; mt < MW; ++mt) frag_a(fa[mt], Q, RQ, 16 * mt, k0, N, dh);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            uint32_t fb[2];
            frag_b_nk(fb, K, RQ, k0, 8 * j, N, dh);
#pragma unroll
            for (int mt = 0; mt < MW; ++mt) mma_bf16_16816(z[mt][j], fa[mt], fb);
        }
    }
    TB_NODE_MARK(1, 3);
    // logits * scale + mask, the exact row max (the lane's keys, then its quad)
    float mx[MW][2], sm[MW][2];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
        mx[mt][0] = mx[mt][1] = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                z[mt][j][i] = z[mt][j][i] * scale + mk[j][i & 1];
                mx[mt][i >> 1] = fmaxf(mx[mt][i >> 1], z[mt][j][i]);
            }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            mx[mt][hf] = fmaxf(mx[mt][hf], __shfl_xor_sync(0xffffffffu, mx[mt][hf], 1));
            mx[mt][hf] = fmaxf(mx[mt][hf], __shfl_xor_sync(0xffffffffu, mx[mt][hf], 2));
            sm[mt][hf] = 0.f;
        }
        // exp in place and the row sums (the lane's keys in order, then its quad)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                z[mt][j][i] = expf(z[mt][j][i] - mx[mt][i >> 1]);
                sm[mt][i >> 1] += z[mt][j][i];
            }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            sm[mt][hf] += __shfl_xor_sync(0xffffffffu, sm[mt][hf], 1);
            sm[mt][hf] += __shfl_xor_sync(0xffffffffu, sm[mt][hf], 2);
        }
    }
    // the weights, divided (a zero one not) and rounded as two n-tiles' C
    // fragments are packed into a P V k-step's A fragment (keys past the last
    // n-tile: 0)
    uint32_t pa[MW][KS][4];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
        const float rs[2] = {1.f / sm[mt][0], 1.f / sm[mt][1]};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            float w[2][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * kk + jj;  // j % NJ: in bounds where j < NJ does not hold
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float e = z[mt][j % NJ][i];
                    w[jj][i] = j < NJ && e != 0.f ? div_rn(e, sm[mt][i >> 1], rs[i >> 1]) : 0.f;
                }
            }
            pa[mt][kk][0] = pack_bf16(w[0][0], w[0][1]);
            pa[mt][kk][1] = pack_bf16(w[0][2], w[0][3]);
            pa[mt][kk][2] = pack_bf16(w[1][0], w[1][1]);
            pa[mt][kk][3] = pack_bf16(w[1][2], w[1][3]);
        }
    }
    TB_NODE_MARK(1, 4);
    __syncwarp();  // every lane's reads of its rows of Q are done: the output goes over them
    for (int d0 = 0; d0 < dh; d0 += 8) {
        float o[MW][4];
#pragma unroll
        for (int mt = 0; mt < MW; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            uint32_t fb[2];
            frag_b_kn(fb, V, RV, 16 * kk, d0, N, dh);
#pragma unroll
            for (int mt = 0; mt < MW; ++mt) mma_bf16_16816(o[mt], pa[mt][kk], fb);
        }
        const int c = d0 + t2;
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int r = 16 * mt + g + 8 * hf;
                float* dst = Q + r * RQ + c;
                if (r < N && c + 1 < dh)
                    *reinterpret_cast<float2*>(dst) = make_float2(o[mt][2 * hf], o[mt][2 * hf + 1]);
                else if (r < N && c < dh)
                    *dst = o[mt][2 * hf];
            }
    }
    TB_NODE_MARK(1, 5);
}

template <int NJ>
__global__ void __launch_bounds__(NT_MMA, 3)
block_attn_mma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const uint8_t* __restrict__ valid, float* __restrict__ out, long long BP, int N, int D, int H,
               float scale) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int dh = D / H;
    const MmaLayout L = mma_layout(N, H, dh);
    const int tq = N * L.RQ, stage_floats = 2 * tq + N * L.RV;
    const int lane = threadIdx.x % 32, t2 = 2 * (lane & 3);
    const Lane cp = copy_lane(D, dh, L.HS, NT_MMA);

    // a head's rounding columns are never written: zero in both stages
    for (int i = threadIdx.x; i < 2 * stage_floats; i += NT_MMA) smem[i] = 0.f;
    __syncthreads();

    auto stage = [&](long long p, float* dst) {
        const float* src[3] = {q, k, v};
        const int off[3] = {0, tq, 2 * tq}, rs[3] = {L.RQ, L.RQ, L.RV};
#pragma unroll
        for (int t = 0; t < 3; ++t) {
            const float* s0 = src[t] + p * N * D + cp.c;
            float* d0 = dst + off[t] + cp.off;
            for (int s = cp.r0; s < N; s += cp.rpp) {
                if (cp.vec)
                    cp_async16(d0 + s * rs[t], s0 + (long long)s * D);
                else
                    d0[s * rs[t]] = __ldg(s0 + (long long)s * D);
            }
        }
    };

    long long p = blockIdx.x;
    uint8_t flag = lane < N ? valid[p * N + lane] : 0;  // node `lane` of polyline p
    stage(p, smem);
    cp_async_commit();
    for (int it = 0; p < BP; ++it, p += gridDim.x) {
        TB_NODE_BEGIN(1);
        float* cur = smem + (it & 1) * stage_floats;
        const unsigned bits = __ballot_sync(0xffffffffu, flag != 0);  // bit t: node t valid
        const bool any = bits != 0u;
        float mk[NJ][2];  // the mask of the lane's keys 8 j + 2t + e: -1e30 at a padded node, -inf at N or past
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int t = 8 * j + t2 + e;
                mk[j][e] = t >= N ? -INFINITY : (any && !((bits >> t) & 1u)) ? -1e30f : 0.f;
            }
        cp_async_wait<0>();
        __syncthreads();  // polyline p landed; the last polyline's output rows (the other stage) are written
        TB_NODE_MARK(1, 1);
        const long long pn = p + gridDim.x;
        if (pn < BP) {
            flag = lane < N ? valid[pn * N + lane] : 0;
            stage(pn, smem + ((it + 1) & 1) * stage_floats);
        }
        cp_async_commit();
        TB_NODE_MARK(1, 2);

        for (int h = threadIdx.x / 32; h < H; h += NT_MMA / 32)  // warp w: heads w, w + 4, ...
            head_mma<NJ>(cur + h * L.HS, cur + tq + h * L.HS, cur + 2 * tq + h * L.HS, L.RQ, L.RV, N, dh, scale, mk);
        TB_NODE_RESTART();
        __syncthreads();  // the output rows are in the q tile
        TB_NODE_MARK(1, 6);

        float* o0 = out + p * N * D + cp.c;
        const float* q0 = cur + cp.off;
        for (int s = cp.r0; s < N; s += cp.rpp) {
            if (cp.vec)
                *reinterpret_cast<float4*>(o0 + (long long)s * D) = *reinterpret_cast<const float4*>(q0 + s * L.RQ);
            else
                o0[(long long)s * D] = q0[s * L.RQ];
        }
        TB_NODE_MARK(1, 7);
    }
}

using Kernel = void (*)(const float*, const float*, const float*, const uint8_t*, float*, long long, int, int, int,
                       float);

int launch(Kernel kernel, int nt, const void* q, const void* k, const void* v, const void* valid, void* out, int BP,
           int N, int D, int n_head, float scale, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem)) != cudaSuccess)
        return (int)err;
    const int grid = (int)std::min<long long>(BP, (long long)std::max(per_sm, 1) * sms);
    kernel<<<grid, nt, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<const uint8_t*>(valid),
                                       static_cast<float*>(out), BP, N, D, n_head, scale);
    return (int)cudaGetLastError();
}

// a row's copies (D / 4 float4s, or D floats where d_head % 4 != 0) must
// fit one pass of a block's threads (copy_lane)
bool takes(int BP, int N, int D, int n_head) {
    return BP > 0 && N >= 1 && N <= MAXN && D >= 1 && D <= MAXD && n_head >= 1 && D % n_head == 0 &&
           ((D / n_head) % 4 == 0 || D <= NT_MMA) && smem_bytes(N, D, n_head) <= (size_t)SMEM_OPTIN;
}

}  // namespace

// q, k, v, out [BP, N, D] fp32 contiguous, valid [BP, N] bool bytes, scale =
// 1 / sqrt(D / n_head) as the caller rounds it to fp32. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for shapes the kernel does
// not take).
extern "C" int tb_block_attn(const void* q, const void* k, const void* v, const void* valid, void* out,
                             int BP, int N, int D, int n_head, float scale, void* stream) {
    if (!takes(BP, N, D, n_head)) return (int)cudaErrorInvalidValue;
    static const Kernel by_nb[8] = {block_attn_kernel<4>,  block_attn_kernel<8>,  block_attn_kernel<12>,
                                    block_attn_kernel<16>, block_attn_kernel<20>, block_attn_kernel<24>,
                                    block_attn_kernel<28>, block_attn_kernel<32>};
    return launch(by_nb[(N + 3) / 4 - 1], NT, q, k, v, valid, out, BP, N, D, n_head, scale, smem_bytes(N, D, n_head),
                  static_cast<cudaStream_t>(stream));
}

// K6-bf16: the same arguments and layouts, every shape tb_block_attn takes.
extern "C" int tb_block_attn_bf16(const void* q, const void* k, const void* v, const void* valid, void* out,
                                  int BP, int N, int D, int n_head, float scale, void* stream) {
    if (!takes(BP, N, D, n_head)) return (int)cudaErrorInvalidValue;
    static const Kernel by_nj[4] = {block_attn_mma<1>, block_attn_mma<2>, block_attn_mma<3>, block_attn_mma<4>};
    return launch(by_nj[(N + 7) / 8 - 1], NT_MMA, q, k, v, valid, out, BP, N, D, n_head, scale,
                  mma_smem_bytes(N, D, n_head), static_cast<cudaStream_t>(stream));
}

TB_NODE_PHASES("0 block_attn_kernel: land|stage|compute|sync|store;"
               "1 block_attn_mma: land|stage|logits|softmax|weighted sum|sync|store")

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
// BF, K6's bf16 variant (tb_block_attn_bf16, map_encoder.kernel_matmul_bf16;
// the TPU kernel's bf16=True): a polyline's q, k and v are rounded to bf16
// in shared memory once they land (one pass and a barrier), and each
// weight after the softmax; the fp32 FMA sums then add exact products of
// bf16 values, so this is the bf16 MMA with fp32 accumulation of the TPU
// kernel; the output stays fp32. BF = false compiles to the fp32 kernel
// unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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
constexpr int MAXD = 128;   // KERNEL_MAX_D in the wrapper
constexpr int NT = 160;     // threads a block
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

__device__ inline Lane copy_lane(int D, int dh, int HS) {
    Lane ln;
    ln.vec = dh % 4 == 0;
    const int per_row = ln.vec ? D / 4 : D;  // chunks a row
    ln.rpp = NT / per_row;
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

__device__ __forceinline__ float4 round_bf16(float4 v) {
    return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)), __bfloat162float(__float2bfloat16_rn(v.y)),
                       __bfloat162float(__float2bfloat16_rn(v.z)), __bfloat162float(__float2bfloat16_rn(v.w)));
}

template <int NB, bool BF>
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
        float* cur = smem + (it & 1) * stage_floats;
        const unsigned bits = __ballot_sync(0xffffffffu, flag != 0);  // bit t: node t valid
        const bool any = bits != 0u;
        cp_async_wait<0>();
        __syncthreads();  // polyline p landed; the last polyline's output rows (the other stage) are written
        const long long pn = p + gridDim.x;
        if (pn < BP) {
            flag = lane < N ? valid[pn * N + lane] : 0;
            stage(pn, smem + ((it + 1) & 1) * stage_floats);
        }
        cp_async_commit();
        if (BF) {  // q, k and v rounded to bf16 once, in place, as the polyline lands
            for (int i = threadIdx.x; i < stage_floats / 4; i += NT) {
                float4* e = reinterpret_cast<float4*>(cur) + i;
                *e = round_bf16(*e);
            }
            __syncthreads();
        }

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
            if (BF) {
#pragma unroll
                for (int t = 0; t < NB; ++t) sc[t] = __bfloat162float(__float2bfloat16_rn(sc[t]));
            }
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
        __syncthreads();  // the output rows are in the q tile

        float* o0 = out + p * N * D + cp.c;
        const float* q0 = cur + cp.off;
        for (int s = cp.r0; s < N; s += cp.rpp) {
            if (cp.vec)
                *reinterpret_cast<float4*>(o0 + (long long)s * D) = *reinterpret_cast<const float4*>(q0 + s * RS);
            else
                o0[(long long)s * D] = q0[s * RS];
        }
    }
}

template <int NB, bool BF>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int BP, int N, int D,
           int n_head, float scale, size_t smem, cudaStream_t stream) {
    void (*kernel)(const float*, const float*, const float*, const uint8_t*, float*, long long, int, int, int,
                   float) = block_attn_kernel<NB, BF>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) != cudaSuccess)
        return (int)err;
    const int grid = (int)std::min<long long>(BP, (long long)std::max(per_sm, 1) * sms);
    kernel<<<grid, NT, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<const uint8_t*>(valid),
                                       static_cast<float*>(out), BP, N, D, n_head, scale);
    return (int)cudaGetLastError();
}

template <bool BF>
int launch_nb(const void* q, const void* k, const void* v, const void* valid, void* out, int BP, int N, int D,
              int n_head, float scale, void* stream) {
    if (BP <= 0 || N < 1 || N > MAXN || D < 1 || D > MAXD || n_head < 1 || D % n_head) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = smem_bytes(N, D, n_head);
    if (smem > (size_t)SMEM_OPTIN) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch ((N + 3) / 4) {
        case 1: return launch<4, BF>(q, k, v, valid, out, BP, N, D, n_head, scale, smem, st);
        case 2: return launch<8, BF>(q, k, v, valid, out, BP, N, D, n_head, scale, smem, st);
        case 3: return launch<12, BF>(q, k, v, valid, out, BP, N, D, n_head, scale, smem, st);
        case 4: return launch<16, BF>(q, k, v, valid, out, BP, N, D, n_head, scale, smem, st);
        case 5: return launch<20, BF>(q, k, v, valid, out, BP, N, D, n_head, scale, smem, st);
        case 6: return launch<24, BF>(q, k, v, valid, out, BP, N, D, n_head, scale, smem, st);
        case 7: return launch<28, BF>(q, k, v, valid, out, BP, N, D, n_head, scale, smem, st);
        default: return launch<32, BF>(q, k, v, valid, out, BP, N, D, n_head, scale, smem, st);
    }
}

}  // namespace

// q, k, v, out [BP, N, D] fp32 contiguous, valid [BP, N] bool bytes, scale =
// 1 / sqrt(D / n_head) as the caller rounds it to fp32. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for shapes the kernel does
// not take).
extern "C" int tb_block_attn(const void* q, const void* k, const void* v, const void* valid, void* out,
                             int BP, int N, int D, int n_head, float scale, void* stream) {
    return launch_nb<false>(q, k, v, valid, out, BP, N, D, n_head, scale, stream);
}

// K6's bf16 variant: the same arguments and layouts (see BF above).
extern "C" int tb_block_attn_bf16(const void* q, const void* k, const void* v, const void* valid, void* out,
                                  int BP, int N, int D, int n_head, float scale, void* stream) {
    return launch_nb<true>(q, k, v, valid, out, BP, N, D, n_head, scale, stream);
}

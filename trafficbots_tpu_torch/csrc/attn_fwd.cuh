// The masked multi-head attention forward for Hopper (sm_90a), one source
// for two kernels: K1 (csrc/fused_attention.cu, eval) and K3f
// (csrc/attention_train.cu, training, with attention-weight dropout and the
// row statistics that K3b reads).
//
// Replaces: trafficbots_tpu/ops/fused_attention.py `_attn_kernel` (K1) and
// trafficbots_tpu/ops/attention_train.py `_fwd_kernel` / `_fwd_kernel_qb`
// (K3f). Per head h of q [B, S, D], k/v [B, T, D]:
//   A = softmax(q_h k_hᵀ / sqrt(dh), masked);  out_h = (A ⊙ M) v_h
// with invalid[b, s, t] != 0 a disallowed target and M the inverted-dropout
// factors of philox.cuh at (row (b H + h) S + s, column t) (K3f; K1 has
// none). A row whose targets are all disallowed comes out exactly 0; K3f
// writes rmax = -inf and rsum = 0 for it.
//
// Dead query rows (the dead-query-row skip; trafficbots_tpu/ops/
// fused_attention.py `_attn_kernel`'s `_skip` and attention_train.py's,
// fed by kernel_common.row_live): with src_inv (one byte a query row,
// [B, S]; null: no row is dead) a row marked there comes out as a row with
// no allowed key: 0, and for K3f rmax = -inf and rsum = 0, which K3b
// already reads as a row that takes no part. The TPU kernels zero whole
// dead blocks of their grid and compute the dead rows of a partly live
// block (the callers zero those); here every dead row is 0. A block (path
// L) or a cluster (path S) whose rows are all dead writes its zeros and
// leaves before it stages anything; a partly live one marks its dead rows
// at the row max (a stride-0 padding mask keeps one bit row for every
// query, so a row cannot be cleared through the mask bits) and computes
// the rest as before: a live row's arithmetic, its path and its dropout
// counters do not change.
//
// The numerical contract (both paths): the logits are fp32 FMA sums over d
// in order, divided by sqrt(dh); the row max is taken exactly over the whole
// allowed row before any exp (no running softmax: one drifted 15.4 m over
// the 91-step closed loop); each weight is expf(z - max) / sum, times its
// dropout factor; the weighted sum is fp32 FMA. bf16 K/V are widened at the
// load from shared memory. No tensor cores (TF32 rounds the operands), no
// float atomics: every output is summed in a fixed order, so the kernels
// are bitwise the same run to run. Only the order of the sums differs from
// the plain version's.
//
// What bounds it on the card, and the two paths the C entry picks between.
// Both are fp32 CUDA-core work, 4 D FLOP per allowed (query, key) pair
// against a few MB of bytes: the operations bound them (67 TFLOP/s).
//
// Path S, the small grid (S <= 64, T <= 8 x 128, fewer than LARGE_GRID row
// blocks; the rollout's as2pl: S = 64 agents, T = 1024 map tokens, bf16 K/V,
// B = 8 or 48). The first design gave it one 256-thread block per (16 rows,
// head, scene), 128 blocks at B = 8, each walking T in 32 serial
// load -> barrier -> compute rounds: latency-bound at 19x its bound. Here a
// thread-block cluster takes one (scene, head), each of its ranks a 128-key
// slice of T with every query row of the head in one 256-thread block, three
// blocks an SM. A rank issues q and its whole K and V slice at once with
// cp.async (V stays in flight through the logits and the softmax), the
// ranks exchange each row's max and then its sum through distributed
// shared memory (the max stays exact, the sum is added in rank order), and
// the partial weighted sums are added in rank order through distributed
// shared memory as well. What is left is a chain of eight phases, three of
// them cluster barriers, each a few thousand cycles (expf and the division
// of every weight, the two products at 32 FMA a thread a key row).
//
// Path L, the large sites (the map self-attention S = T = 1024, the latent
// as2pl S = 1216): one 512-thread block per (32 query rows, head, scene)
// holds the [32, T] logits in shared memory (the exact max needs the whole
// row; the other choice, a max pass that recomputes the logits, costs 6 D
// FLOP a pair where this costs 4 D), one block an SM. The first design issued
// 5 shared-memory loads per 4 FMA in the logits and 3 per 2 in the weighted
// sum, read the mask byte by byte for every (row, key) and took a second
// pass for the row max: 10.5x its bound. Here the products run on register
// micro-tiles from float4 loads (4 x 2 in the logits, 5.3 FMA a load; 4 x 4
// in the weighted sum, 8), K and V tiles of 128 keys are double-buffered
// with cp.async, the row max is kept in registers as the logits are made,
// the mask is read once into a bit array (once per key for a stride-0
// padding mask), from which key tiles that no row may use are skipped (no
// load, no product), and the two softmax passes run on every thread in
// float4 chunks. The logits still make ~31 FMA a cycle of an SM's 128
// (ops/attn_fwd_trace.py): shared-memory wavefronts, not the FMA pipe,
// set the products' pace.
//
// Both paths divide with div_rn (a reciprocal and an FMA correction, the
// IEEE quotient bit for bit) and skip the division of a zero weight.
//
// K1-bf16, K1's bf16 variant (the model under precision="bf16"): q, k and
// v are bf16, and fwd_rows_mma / fwd_cluster_mma compute the Pallas
// `_attn_kernel`'s function on them on the tensor cores (mma.cuh's bf16
// mma.sync with fp32 accumulation; a product of bf16 values is exact in
// fp32, so only the order and rounding of the sums differ): q, K and V are
// staged as bf16 by cp.async, the logits q kᵀ come from MMAs and are
// scaled by multiplying with the fp32 1 / sqrt(dh) as that kernel does,
// the exact row max is taken over the whole allowed row before any exp and
// the softmax stays fp32, each weight is rounded to bf16 after its division
// (the kernel's `attn.astype(v.dtype)`), the weighted sum P V comes from
// MMAs with k over the keys, and the output is rounded to bf16 once, as it
// is written. The logits and weights stay in registers (the section below
// says how); the paths, the skip of dead rows and clusters, and the
// rank-ordered sums are the fp32 kernels', except that path S gives way to
// path L where path L's blocks fill the card (takes_cluster_bf16). Path L
// holds a key tile a warp column, so T <= 1024 there; past it
// fwd_rows_mma_long walks the key tiles in rounds, recomputing the logits
// in each of its passes. The fp32 kernels (K1, K3f) have no tensor-core
// code.
//
// Past the T whose [32, T] logits fit a path-L block (1,408 keys at d_head
// 16 and 32, 1,024-1,280 at 64 and 128), the fp32 forward takes path G:
// path L's arithmetic with the logits in a global workspace (below).
//
// d_head 16, 32, 64 and 128 are instantiated. At 128 (hidden 256 with 2
// heads, hidden 128 with 1) the layouts that fit the smaller widths do not
// all fit: path S runs its weighted sum in two passes of 64 columns (its
// grouping would take 512 threads), path L with fp32 K/V stages one K/V
// tile at a time (two beside T = 1024 keys' logits take 290 KB), and
// K1-bf16's path L stages K and V in 64-column slabs (fwd_rows_mma_slab:
// the whole K is 278 KB). Each is new code beside the smaller widths'.
//
// d_head 8 and 4 (hidden 128 with 16 or 32 heads) are instantiated too,
// each in `if constexpr` branches beside the wider heads' code, which they
// leave as it was: a bf16 K/V row of 4 is 8 bytes, staged by an 8-byte
// cp.async (stage_rows); path L's weighted sum at d_head 4 has 64 groups
// of 8 threads for 128 keys, so only the first 32 take part, 4 keys each
// (av_groups); K1-bf16's logits take one m16n8k8 k-step (mma.cuh; at
// d_head 4 the lanes of columns 4-7 give zeros), its P V one n-tile of 8
// columns whose last 4 (V's columns past d_head 4) are zeros and are not
// stored, and its rounds past 1,024 keys stage the whole head (long_cols).
// The scale stays 1 / sqrt(d_head) of the true width.
//
// fp32 K1 on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md section 6): path S
// 0.0263 ms for K1 at B = 8 (8.8x its bound), 0.111 ms at B = 48; path L
// 0.227 and 0.283 ms for K1 at the map self-attention and the latent
// as2pl (4.7x and 5.0x), below SDPA's forward (0.369, 0.392).
//
// The Hopper primitives (cp.async, the cluster's rank, barrier and shared
// memory map) sit behind the small functions below, so that
// tests/cuda_emu/cuda_runtime.h can give each a plain C++ body.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef TB_CUDA_EMU
#include <cooperative_groups.h>
#endif

#include "mma.cuh"
#include "philox.cuh"

#ifndef TB_CUDA_EMU
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ unsigned cluster_rank() { return cooperative_groups::this_cluster().block_rank(); }
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
    return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}
#endif

// The phase trace, in a build with -DTB_ATTN_TRACE only
// (ops/attn_fwd_trace.py): thread 0 of each block adds the clock64 cycles
// since its last mark to tb_attn_trace[path][phase]; slot 15 counts blocks.
#ifdef TB_ATTN_TRACE
__device__ unsigned long long tb_attn_trace[2][16];
#define TB_TRACE_BEGIN(P)              \
    unsigned long long tb_trace_t_ = clock64(); \
    if (threadIdx.x == 0) atomicAdd(&tb_attn_trace[P][15], 1ull)
#define TB_TRACE(P, K)                                                  \
    if (threadIdx.x == 0) {                                             \
        const unsigned long long now_ = clock64();                      \
        atomicAdd(&tb_attn_trace[P][K], now_ - tb_trace_t_);            \
        tb_trace_t_ = now_;                                             \
    }
#else
#define TB_TRACE_BEGIN(P)
#define TB_TRACE(P, K)
#endif

namespace tb_attn {

constexpr int TK = 128;               // keys of a path-L tile and of a path-S rank's slice
constexpr int ROWS_L = 32;            // query rows of a path-L block
constexpr int THREADS_L = 512;        // threads of a path-L block (one block an SM: 16 warps)
constexpr int ROWS_S = 64;            // query rows of a path-S block: every row of the head
constexpr int THREADS_S = 256;        // threads of a path-S block
constexpr int MAX_CLUSTER = 8;        // ranks of a path-S cluster (the portable limit): T <= 1024
constexpr int LARGE_GRID = 4 * 132;   // path-L blocks (four waves of 132 SMs) from which path S is not taken
constexpr int SMEM_OPTIN = 232448;    // dynamic shared memory a block may opt in to on sm_90
constexpr int WS_BLOCKS_PER_SM = 1;   // path-G blocks an SM (104-128 registers a thread), a logits slot each

struct Args {
    const float* q;  // bf16 in K1-bf16
    const void* k;
    const void* v;
    const uint8_t* inv;
    float* out;  // bf16 in K1-bf16
    float* rmax;  // [B, H, S] (STATS)
    float* rsum;
    int B, S, T, D, H;
    long long inv_sb, inv_ss;
    tb_philox::Dropout drop;  // (DROP)
    uint32_t site;
    int aligned;  // q, k, v and every head's row slice 16-byte aligned: cp.async, else plain copies
    const uint8_t* src_inv;  // [B, S] nonzero: a dead query row; null: none
    float* ws;               // path G's logits workspace (ws_slots blocks x [ROWS_L][rows_ldl(T)]), or null
    long long ws_floats;     // its size in floats
};

// Query row s of scene b is dead (src_inv).
__device__ __forceinline__ bool dead_row(const Args& a, int b, int s) {
    return a.src_inv != nullptr && a.src_inv[(long long)b * a.S + s] != 0;
}

// max and sum over the W consecutive lanes that share lane / W
template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Four consecutive elements of a shared-memory row as fp32 (bf16 widened).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
}

// Row stride (elements) of a staged K/V tile: 16 bytes of padding, so that
// the float4 (or 4 x bf16) loads of 8 consecutive rows hit distinct banks.
template <int DH, class KV>
__host__ __device__ constexpr int kv_ld() { return DH + 16 / (int)sizeof(KV); }

// x / d rounded to nearest, for d > 0 given r = 1 / d: the product by the
// reciprocal and one FMA correction (Markstein), the IEEE quotient bit for
// bit for normal x (tests/test_torch_cuda_emu.py checks it against x / d),
// in 3 instructions where a division takes ~8 and a check.
__device__ __forceinline__ float div_rn(float x, float d, float r) {
    const float q = x * r;
    return fmaf(fmaf(-q, d, x), r, q);
}

// Rows t0 .. t0 + n - 1 of one head's DH columns of src ([B, T, D] from
// `base`) into tile[n][LD], with cp.async when aligned; zeros past T. A
// row of 8 bytes (bf16 at d_head 4) is one 8-byte copy.
template <int DH, class KV, int NT>
__device__ __forceinline__ void stage_rows(KV* tile, const KV* __restrict__ src, long long base, int t0, int n, int T,
                                           int D, int aligned) {
    if constexpr (DH * (int)sizeof(KV) == 8) {
        constexpr int LD = kv_ld<DH, KV>();
        for (int r = threadIdx.x; r < n; r += NT) {
            const int t = t0 + r;
            KV* dst = tile + r * LD;
            if (t < T) {
                const KV* s = src + base + (long long)t * D;
                if (aligned) {
                    cp_async8(dst, s);
                } else {
                    for (int e = 0; e < DH; ++e) dst[e] = s[e];
                }
            } else {
                *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
            }
        }
    } else {
        constexpr int LD = kv_ld<DH, KV>(), E = 16 / (int)sizeof(KV), CH = DH / E;
        for (int i = threadIdx.x; i < n * CH; i += NT) {
            const int r = i / CH, c = i % CH, t = t0 + r;
            KV* dst = tile + r * LD + c * E;
            if (t < T) {
                const KV* s = src + base + (long long)t * D + c * E;
                if (aligned) {
                    cp_async16(dst, s);
                } else {
                    for (int e = 0; e < E; ++e) dst[e] = s[e];
                }
            } else {
                *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
            }
        }
    }
}

// out[i] = x: fp32, or rounded to bf16 in K1-bf16 (QB).
template <bool QB>
__device__ __forceinline__ void store_out(const Args& a, long long i, float x) {
    if (QB)
        reinterpret_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(x);
    else
        a.out[i] = x;
}

// Bit j: byte j of the 16 in u is 0 (an allowed key).
__device__ __forceinline__ uint32_t zero_bytes(uint4 u) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) bits |= (uint32_t)(((w[i >> 2] >> (8 * (i & 3))) & 0xffu) == 0u) << i;
    return bits;
}

// bits[r * nw + w], bit i: row s0 + r may use key key0 + 32 w + i (zero past
// T and for rows past S). A stride-0 padding mask is read once per key into
// row 0 alone (n_rows = 1; callers index it with a row stride of 0). A word
// of 32 whole, aligned keys is read as two 16-byte loads.
template <int NT>
__device__ __forceinline__ void load_bits(uint32_t* bits, int n_rows, int nw, const Args& a, int b, int s0,
                                          int key0) {
    for (int i = threadIdx.x; i < n_rows * nw; i += NT) {
        const int r = i / nw, w = i % nw, s = s0 + r;
        uint32_t word = 0;
        if (s < a.S) {
            const int t0 = key0 + 32 * w;
            const uint8_t* p = a.inv + b * a.inv_sb + (long long)s * a.inv_ss + t0;
            if (t0 + 32 <= a.T && ((uintptr_t)p & 15u) == 0) {
                word = zero_bytes(*reinterpret_cast<const uint4*>(p)) |
                       zero_bytes(*reinterpret_cast<const uint4*>(p + 16)) << 16;
            } else {
#pragma unroll 8
                for (int j = 0; j < 32; ++j)
                    if (t0 + j < a.T && !p[j]) word |= 1u << j;
            }
        }
        bits[i] = word;
    }
}

// The warp-grid of a ROWS x NK logits block on NT threads: each thread owns
// 4 rows (ty + NTY i) x MK keys (tx + NTX j); a warp holds 4 ty x 8 tx.
template <int ROWS, int NK, int NT>
struct Grid {
    static constexpr int NTY = ROWS / 4, MK = ROWS * NK / (NT * 4), NTX = NK / MK, NWX = NTX / 8;
    static_assert(NTY % 4 == 0 && NTX == 8 * (NT / 32) / (NTY / 4), "micro-tile layout");
};

// The logits of a ROWS x NK block: lg[r][l0 + j] = (q_r . k_j) / sqrt(dh)
// for the tile's keys j (global key tg0 + j), -inf where the pair is not
// allowed; nothing is written for keys at or past T. One float4 of q and of
// each key per 4 d: 4 MK FMA per 4 + MK loads. The key loads of a warp
// cover 8 consecutive tile rows (distinct banks through the padding), the
// q loads 4 rows (broadcast within each 8 threads). The sum over d runs in
// order, as the plain version and K3b's rebuild of the logits do. mx
// keeps the running max of the thread's 4 rows over their allowed keys
// (store_row_max hands it on once all tiles are done).
template <int DH, class KV, int ROWS, int NK, int NT>
__device__ __forceinline__ void tile_logits(float* lg, int ldl, int l0, const float* qs, const KV* kt, int tg0,
                                            const uint32_t* bits, int bstride, int bkey0, int T,
                                            float (&mx)[4]) {
    using G = Grid<ROWS, NK, NT>;
    constexpr int NTY = G::NTY, MK = G::MK, NTX = G::NTX;
    constexpr int LQ = DH + 4, LD = kv_ld<DH, KV>();
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ty = (w % (NTY / 4)) * 4 + (lane >> 3), tx = (w / (NTY / 4)) * 8 + (lane & 7);
    float acc[4][MK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < MK; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
        float4 a[4], k[MK];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = load4(qs + (ty + NTY * i) * LQ + d);
#pragma unroll
        for (int j = 0; j < MK; ++j) k[j] = load4(kt + (tx + NTX * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < MK; ++j) {
                float s = acc[i][j];
                s = fmaf(a[i].x, k[j].x, s);
                s = fmaf(a[i].y, k[j].y, s);
                s = fmaf(a[i].z, k[j].z, s);
                s = fmaf(a[i].w, k[j].w, s);
                acc[i][j] = s;
            }
    }
    const float sqrt_dh = sqrtf((float)DH), rs = 1.f / sqrt_dh;
    uint32_t kw[MK];  // a padding mask's words of the thread's keys (shared by every row)
#pragma unroll
    for (int j = 0; j < MK; ++j) {
        const int t = tg0 + tx + NTX * j;
        kw[j] = bstride == 0 && t < T ? bits[(t - bkey0) >> 5] : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + NTY * i;
#pragma unroll
        for (int j = 0; j < MK; ++j) {
            const int tl = tx + NTX * j, t = tg0 + tl;
            if (t < T) {
                const int tb = t - bkey0;
                const uint32_t word = bstride == 0 ? kw[j] : bits[r * bstride + (tb >> 5)];
                const float y = div_rn(acc[i][j], sqrt_dh, rs);
                const float z = (word >> (tb & 31)) & 1u ? y : -INFINITY;
                lg[r * ldl + l0 + tl] = z;
                mx[i] = fmaxf(mx[i], z);
            }
        }
    }
}

// The thread's running row maxima mx (tile_logits') reduced over the 8
// threads of a warp that share its rows, into rm[wx * ROWS + r] for its
// warp column wx: every slot has one writer.
template <int ROWS, int NK, int NT>
__device__ __forceinline__ void store_row_max(float* rm, const float (&mx)[4]) {
    constexpr int NTY = Grid<ROWS, NK, NT>::NTY;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ty = (w % (NTY / 4)) * 4 + (lane >> 3), wx = w / (NTY / 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float m = group_max<8>(mx[i]);
        if ((lane & 7) == 0) rm[wx * ROWS + ty + NTY * i] = m;
    }
}

// Columns of one pass of the weighted sum: DH, or where ROWS / 4 row groups
// x DH / 4 column groups would pass the block's NT threads (path S at
// d_head 128), the most that fit; the passes then run one after another
// over the same weights, each thread keeping every pass's sums.
template <int DH, int ROWS, int NT>
__host__ __device__ constexpr int av_cols() { return ROWS / 4 * (DH / 4) <= NT ? DH : NT / (ROWS / 4) * 4; }

// Threads of one group of the weighted sum: ROWS / 4 row groups x CW / 4
// column groups (CW the columns of a pass, av_cols); the block's groups
// take disjoint keys of a tile and their partials are added in group order
// at the end.
template <int CW, int ROWS>
__host__ __device__ constexpr int av_group() { return ROWS / 4 * (CW / 4); }

// Groups of NT threads' weighted sum over a tile of TK keys: NT / GT, or
// where that would leave a group fewer than 4 keys (path L at d_head 4:
// 64 groups of 8 threads), TK / 4 groups, and the other threads take no
// part in it.
template <int NT, int GT>
__host__ __device__ constexpr int av_groups() { return NT / GT * 4 <= TK ? NT / GT : TK / 4; }

// acc[i][c] += sum over n keys (n % 4 == 0) of w[ry + RY i][l0 + t] v[v0 + t][c0 + 4 cx + c]
// (columns c0 .. c0 + CW - 1 of a pass), t in order: 4 float4 weight loads
// (rows RY apart, distinct banks through the logits' row stride of 8 mod
// 32) and 4 of V (one row, 4 consecutive columns a thread) per 64 FMA.
template <int DH, class KV, int ROWS, int CW = DH>
__device__ __forceinline__ void tile_av(float (&acc)[4][4], const float* lg, int ldl, int l0, const KV* vt, int v0,
                                        int n, int lid, int c0 = 0) {
    constexpr int RY = ROWS / 4, NCX = CW / 4, LD = kv_ld<DH, KV>();
    const int ry = lid / NCX, cx = lid % NCX;
    for (int t = 0; t < n; t += 4) {
        float4 wv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = load4(lg + (ry + RY * i) * ldl + l0 + t);
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = load4(vt + (v0 + t + j) * LD + c0 + 4 * cx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float wt[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[i][0] = fmaf(wt[j], vv[j].x, acc[i][0]);
                acc[i][1] = fmaf(wt[j], vv[j].y, acc[i][1]);
                acc[i][2] = fmaf(wt[j], vv[j].z, acc[i][2]);
                acc[i][3] = fmaf(wt[j], vv[j].w, acc[i][3]);
            }
        }
    }
}

// The group partials acc of rows (ry + RY i), columns c0 + 4 cx + c into
// part[grp][ROWS][DH] (the caller synchronises before and after).
template <int DH, int ROWS, int CW = DH>
__device__ __forceinline__ void store_partials(float* part, const float (&acc)[4][4], int grp, int lid, int c0 = 0) {
    constexpr int RY = ROWS / 4, NCX = CW / 4;
    const int ry = lid / NCX, cx = lid % NCX;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(part + (grp * ROWS + ry + RY * i) * DH + c0 + 4 * cx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The softmax's two passes over rows of lg in place, NT / ROWS threads a
// row in float4 chunks of its first n columns (rows r < rows whose exact
// max m[r] is finite; the others are left as they are):
//   exp_rows: e = expf(z - m), the row's sum of e into sum[r] (0 for the
//     other rows): each thread's sum in column order, then the row's
//     threads' sums by a butterfly;
//   weights_rows: w = e / sum (div_rn; a zero e gives 0 without it), times the dropout
//     factor of (row stat0 + r, column col0 + t) when DROP is on, four a
//     Philox call, skipped for four zero weights.
template <int ROWS, int NT>
__device__ __forceinline__ void exp_rows(float* lg, int ldl, int n, int rows, const float* m, float* sum) {
    constexpr int TPR = NT / ROWS;
    static_assert(TPR <= 32 && 32 % TPR == 0, "threads a row");
    const int r = threadIdx.x / TPR, k = threadIdx.x % TPR;
    const float mr = m[r];
    const bool live = r < rows && mr != -INFINITY;
    float s = 0.f;
    if (live) {
        float* row = lg + r * ldl;
        for (int t = 4 * k; t < n; t += 4 * TPR) {
            const float4 z = load4(row + t);
            const float e0 = expf(z.x - mr);
            const float e1 = t + 1 < n ? expf(z.y - mr) : 0.f;
            const float e2 = t + 2 < n ? expf(z.z - mr) : 0.f;
            const float e3 = t + 3 < n ? expf(z.w - mr) : 0.f;
            s += e0;
            s += e1;
            s += e2;
            s += e3;
            *reinterpret_cast<float4*>(row + t) = make_float4(e0, e1, e2, e3);
        }
    }
    s = group_sum<TPR>(s);
    if (k == 0) sum[r] = live ? s : 0.f;
}

template <int ROWS, int NT, bool DROP>
__device__ __forceinline__ void weights_rows(float* lg, int ldl, int n, int rows, const float* m, const float* sum,
                                             const Args& a, long long stat0, int col0) {
    constexpr int TPR = NT / ROWS;
    const int r = threadIdx.x / TPR, k = threadIdx.x % TPR;
    if (r >= rows || m[r] == -INFINITY) return;
    const float sr = sum[r], ir = 1.f / sr;
    float* row = lg + r * ldl;
    for (int t = 4 * k; t < n; t += 4 * TPR) {
        const float4 e = load4(row + t);
        float w[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = w[j] == 0.f ? 0.f : div_rn(w[j], sr, ir);
        if (DROP && a.drop.on && (w[0] != 0.f || w[1] != 0.f || w[2] != 0.f || w[3] != 0.f)) {
            float f[4];
            tb_philox::factors4(a.drop, a.site, (unsigned long long)(stat0 + r), (uint32_t)((col0 + t) >> 2), f);
#pragma unroll
            for (int j = 0; j < 4; ++j) w[j] *= f[j];
        }
        *reinterpret_cast<float4*>(row + t) = make_float4(w[0], w[1], w[2], w[3]);
    }
}

// Rows s0 .. s1 - 1 of head h of scene b written as dead rows: 0, and
// under STATS the row max -inf and the sum 0.
template <int DH, int NT, bool STATS, bool QB>
__device__ __forceinline__ void store_dead_rows(const Args& a, int b, int h, int s0, int s1) {
    for (int i = threadIdx.x; i < (s1 - s0) * DH; i += NT)
        store_out<QB>(a, ((long long)b * a.S + s0 + i / DH) * a.D + h * DH + i % DH, 0.f);
    if (STATS)
        for (int s = s0 + (int)threadIdx.x; s < s1; s += NT) {
            const long long j = ((long long)b * a.H + h) * a.S + s;
            a.rmax[j] = -INFINITY;
            a.rsum[j] = 0.f;
        }
}

// ---- path L: one block per (ROWS_L query rows, head, scene)

// Shared memory of a path-L block, in floats: the [ROWS_L][ldl] logits,
// q [ROWS_L][DH + 4], the K/V tiles [TK][LD] (then the groups' partial
// sums), the mask bits [ROWS_L][nt * 4], the warp columns' row maxima, the
// rows' max and sum, the live tiles and each tile's flag.
// ops/fused_attention.py mirrors it.
__host__ __device__ inline int rows_ldl(int T) { return (T + TK - 1) / TK * TK + 8; }

// K/V tiles of a path-L block: two (the next tile loads during this one's
// products) where they take at most KV_BUF_BYTES, else one (fp32 K/V at
// d_head 128, whose two tiles would leave no room for T = 1024 keys'
// logits: each tile then loads after the last one's products).
constexpr int KV_BUF_BYTES = 2 * 128 * 68 * 4;  // two fp32 tiles of TK keys at d_head 64
template <int DH, class KV>
__host__ __device__ constexpr int kv_bufs() { return 2 * TK * kv_ld<DH, KV>() * (int)sizeof(KV) <= KV_BUF_BYTES ? 2 : 1; }

template <int DH, class KV>
__host__ __device__ inline int rows_kv_floats() {
    const int tiles = kv_bufs<DH, KV>() * TK * kv_ld<DH, KV>() * (int)sizeof(KV) / 4;
    return tiles > THREADS_L * 16 ? tiles : THREADS_L * 16;
}

template <int DH, class KV>
size_t rows_smem(int T) {
    const int nt = (T + TK - 1) / TK;
    return sizeof(float) * ((size_t)ROWS_L * rows_ldl(T) + ROWS_L * (DH + 4) + rows_kv_floats<DH, KV>() +
                            ROWS_L * nt * (TK / 32) + (Grid<ROWS_L, TK, THREADS_L>::NWX + 2) * ROWS_L + 2 * nt);
}

// Path G, the T whose [ROWS_L, T] logits pass a block's shared memory:
// path L's block and arithmetic to the bit, with the logits (then the
// weights) in a slot of a global workspace in place of shared memory
// (ROWS_L rows of rows_ldl(T) floats a slot, 257 KB at T = 2048: 34 MB
// for the 132 SMs' slots, within the 50 MB L2), and the rest of path L's
// shared memory as it is. The grid is WS_BLOCKS_PER_SM blocks an SM
// (ws_slots; the global addressing takes 104-128 registers a thread where
// path L takes 56-64, so one 512-thread block fills an SM's registers),
// each with its own slot, walking the (row block, head, scene) work items
// in the order of path L's grid. The mask bits, the live tiles and the K/V
// tiles stay in shared memory: the bits bound T (past 35,000 keys).
inline long long ws_slots(const Args& a, int n_sm) {
    const long long work = (long long)((a.S + ROWS_L - 1) / ROWS_L) * a.H * a.B;
    return work < (long long)WS_BLOCKS_PER_SM * n_sm ? work : (long long)WS_BLOCKS_PER_SM * n_sm;
}

template <int DH, class KV>
size_t rows_ws_smem(int T) { return rows_smem<DH, KV>(T) - sizeof(float) * ROWS_L * rows_ldl(T); }

// Path L's kernel (WS false: one block a (row block, head, scene), the
// logits in shared memory) and path G's (WS: a 1-D grid of ws_slots
// blocks, the logits in the block's slot of the workspace).
template <int DH, class KV, bool DROP, bool STATS, bool WS>
__global__ void __launch_bounds__(THREADS_L) fwd_rows(const Args a) {
    constexpr int NT = THREADS_L, NWX = Grid<ROWS_L, TK, NT>::NWX, NB = kv_bufs<DH, KV>();
    constexpr int LQ = DH + 4, LD = kv_ld<DH, KV>(), GT = av_group<DH, ROWS_L>(), NG = av_groups<NT, GT>(),
                  KG = TK / NG;
    static_assert(av_cols<DH, ROWS_L, NT>() == DH && NG * GT <= NT && KG % 4 == 0, "weighted-sum groups");
    extern __shared__ float smem[];
    const int T = a.T, nt = (T + TK - 1) / TK, nw = nt * (TK / 32), ldl = rows_ldl(T);
    // path G walks the (row block, head, scene) work items in path L's grid
    // order on a 1-D grid; path L takes one, its block's
    const int n_rb = WS ? (a.S + ROWS_L - 1) / ROWS_L : 1;
    const long long n_work = WS ? (long long)n_rb * a.H * a.B : 1;
    for (long long wi = WS ? blockIdx.x : 0; wi < n_work; wi += WS ? gridDim.x : 1) {
        TB_TRACE_BEGIN(0);
        float* lg = WS ? a.ws + (long long)blockIdx.x * ROWS_L * ldl : smem;  // [ROWS_L][ldl]: logits, then weights
        float* qs = WS ? smem : lg + ROWS_L * ldl;               // [ROWS_L][LQ]
        KV* kv = reinterpret_cast<KV*>(qs + ROWS_L * LQ);        // NB [TK][LD] tiles; then the partial sums
        float* part = reinterpret_cast<float*>(kv);
        uint32_t* bits = reinterpret_cast<uint32_t*>(qs + ROWS_L * LQ + rows_kv_floats<DH, KV>());  // [ROWS_L][nw]
        float* rm = reinterpret_cast<float*>(bits + ROWS_L * nw);  // [NWX][ROWS_L] the warp columns' row maxima
        float* mrow = rm + NWX * ROWS_L;  // [ROWS_L] the row max (-inf: no allowed key, dead, past S)
        float* srow = mrow + ROWS_L;                             // [ROWS_L] the row sum
        int* live = reinterpret_cast<int*>(srow + ROWS_L);       // [nt] the live tiles
        int* flag = live + nt;                                   // [nt] a tile has an allowed pair

        const int b = WS ? (int)(wi / ((long long)n_rb * a.H)) : (int)blockIdx.z;
        const int h = WS ? (int)(wi / n_rb % a.H) : (int)blockIdx.y;
        const int s0 = (WS ? (int)(wi % n_rb) : (int)blockIdx.x) * ROWS_L;
        const int rows = min(ROWS_L, a.S - s0);
        const long long kv_base = (long long)b * T * a.D + h * DH;
        const long long stat0 = ((long long)b * a.H + h) * a.S + s0;
        const KV* K = static_cast<const KV*>(a.k);
        const KV* V = static_cast<const KV*>(a.v);
        const int brs = a.inv_ss == 0 ? 0 : nw;  // row stride of the bits: 0 for a padding mask

        if (a.src_inv != nullptr && !__syncthreads_or((int)threadIdx.x < rows && !dead_row(a, b, s0 + threadIdx.x))) {
            store_dead_rows<DH, NT, STATS, false>(a, b, h, s0, s0 + rows);  // no live row: no K/V staged
            continue;
        }
        stage_rows<DH, float, NT>(qs, a.q, ((long long)b * a.S + s0) * a.D + h * DH, 0, ROWS_L, rows, a.D, a.aligned);
        cp_async_commit();
        load_bits<NT>(bits, brs ? ROWS_L : 1, nw, a, b, s0, 0);
        for (int i = threadIdx.x; i < nt; i += NT) flag[i] = 0;
        __syncthreads();
        TB_TRACE(0, 1);  // q issued, the mask bits

        // the live tiles: those where some (row, key) pair is allowed; the
        // logits of the others are -inf and their K/V tiles never load
        for (int i = threadIdx.x; i < (brs ? ROWS_L : 1) * nw; i += NT)
            if (bits[i] != 0u) atomicOr(&flag[(i % nw) / (TK / 32)], 1);
        __syncthreads();
        int n_live = 0;
        for (int i = 0; i < nt; ++i) {
            if (!flag[i]) continue;
            if (threadIdx.x == 0) live[n_live] = i;
            ++n_live;
        }
        for (int i = 0; i < nt; ++i)  // the dead tiles' logits -inf
            if (!flag[i])
                for (int j = threadIdx.x; j < ROWS_L * TK; j += NT)
                    if (i * TK + j % TK < T) lg[(j / TK) * ldl + i * TK + j % TK] = -INFINITY;
        for (int j = threadIdx.x; j < ROWS_L * (nt * TK - T); j += NT) {  // past T: weight 0 (V rows there are 0)
            const int nc = nt * TK - T;
            lg[(j / nc) * ldl + T + j % nc] = 0.f;
        }
        __syncthreads();  // live[] and the fills written
        TB_TRACE(0, 2);  // the live tiles, the fills

        // logits and the row maxima: K tiles double-buffered, the next one in
        // flight during this one's products (with one buffer, issued after them)
        if (n_live > 0) {
            stage_rows<DH, KV, NT>(kv, K, kv_base, live[0] * TK, TK, T, a.D, a.aligned);
            cp_async_commit();
        }
        float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        for (int i = 0; i < n_live; ++i) {
            if (NB == 2) {
                if (i + 1 < n_live)
                    stage_rows<DH, KV, NT>(kv + ((i + 1) & 1) * TK * LD, K, kv_base, live[i + 1] * TK, TK, T, a.D,
                                           a.aligned);
                cp_async_commit();  // empty on the last tile: one group a step
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            tile_logits<DH, KV, ROWS_L, TK, NT>(lg, ldl, live[i] * TK, qs, kv + (i % NB) * TK * LD, live[i] * TK, bits,
                                                brs, 0, T, mx);
            __syncthreads();
            if (NB == 1 && i + 1 < n_live) {
                stage_rows<DH, KV, NT>(kv, K, kv_base, live[i + 1] * TK, TK, T, a.D, a.aligned);
                cp_async_commit();
            }
        }
        store_row_max<ROWS_L, TK, NT>(rm, mx);
        TB_TRACE(0, 3);  // the logits
        if (n_live > 0) {  // V's first tile loads during the softmax
            stage_rows<DH, KV, NT>(kv, V, kv_base, live[0] * TK, TK, T, a.D, a.aligned);
            cp_async_commit();
        }

        // softmax: the exact max over the whole row, then exp and sum, then
        // the division (and the dropout factors)
        __syncthreads();
        if (threadIdx.x < ROWS_L) {
            float m = -INFINITY;
            for (int x = 0; x < NWX; ++x) m = fmaxf(m, rm[x * ROWS_L + threadIdx.x]);
            mrow[threadIdx.x] = (int)threadIdx.x < rows && !dead_row(a, b, s0 + threadIdx.x) ? m : -INFINITY;
        }
        __syncthreads();
        exp_rows<ROWS_L, NT>(lg, ldl, T, rows, mrow, srow);
        __syncthreads();
        TB_TRACE(0, 4);  // the row max, exp and sum
        if (STATS && (int)threadIdx.x < rows) {  // a row with every target masked: -inf and 0
            a.rmax[stat0 + threadIdx.x] = mrow[threadIdx.x];
            a.rsum[stat0 + threadIdx.x] = srow[threadIdx.x];
        }
        weights_rows<ROWS_L, NT, DROP>(lg, ldl, T, rows, mrow, srow, a, stat0, 0);
        TB_TRACE(0, 5);  // the weights (this thread's share)

        // weighted sum: V tiles double-buffered; group grp takes keys
        // grp * KG .. of each tile, the partials added in group order
        const int grp = threadIdx.x / GT, lid = threadIdx.x % GT;
        const bool in_av = NG * GT == NT || grp < NG;  // d_head 4: the threads past NG groups take no part
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int i = 0; i < n_live; ++i) {
            if (NB == 2) {
                if (i + 1 < n_live)
                    stage_rows<DH, KV, NT>(kv + ((i + 1) & 1) * TK * LD, V, kv_base, live[i + 1] * TK, TK, T, a.D,
                                           a.aligned);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            if (in_av)
                tile_av<DH, KV, ROWS_L>(acc, lg, ldl, live[i] * TK + grp * KG, kv + (i % NB) * TK * LD, grp * KG, KG,
                                        lid);
            __syncthreads();
            if (NB == 1 && i + 1 < n_live) {
                stage_rows<DH, KV, NT>(kv, V, kv_base, live[i + 1] * TK, TK, T, a.D, a.aligned);
                cp_async_commit();
            }
        }
        __syncthreads();
        TB_TRACE(0, 6);  // the weighted sum
        if (in_av) store_partials<DH, ROWS_L>(part, acc, grp, lid);
        __syncthreads();
        for (int i = threadIdx.x; i < rows * DH; i += NT) {
            const int r = i / DH, c = i % DH;
            float s = part[i];
            for (int g = 1; g < NG; ++g) s += part[g * ROWS_L * DH + i];
            store_out<false>(a, ((long long)b * a.S + s0 + r) * a.D + h * DH + c, mrow[r] == -INFINITY ? 0.f : s);
        }
        TB_TRACE(0, 7);  // the groups' partials, the output
        if (WS) __syncthreads();  // the item's last reads of shared memory and of the slot are done
    }
}

// ---- path S: a cluster of ranks per (head, scene), a TK-key slice of T each

// Shared memory of a path-S block, in floats: the [ROWS_S][TK + 8] slice
// logits (then the groups' partial sums), q [ROWS_S][DH + 4], the K and V
// slices [TK][LD], the warp columns' row maxima, the rows' slice max, slice
// sum, max and sum, the mask bits [ROWS_S][TK / 32].
template <int DH, class KV>
size_t cluster_smem() {
    return sizeof(float) * ((size_t)ROWS_S * (TK + 8) + ROWS_S * (DH + 4) + 2 * TK * kv_ld<DH, KV>() * sizeof(KV) / 4 +
                            (Grid<ROWS_S, TK / 2, THREADS_S>::NWX + 4) * ROWS_S + ROWS_S * (TK / 32));
}

// v[k] = rank k's arr[i] for the cluster's ranks, all loads in flight at once.
__device__ __forceinline__ void gather(float (&v)[MAX_CLUSTER], float* arr, int i, int CL) {
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) v[k] = k < CL ? cluster_map(arr, (unsigned)k)[i] : 0.f;
}

// Three blocks an SM (registers and shared memory allow it), so that a
// cluster of eight finds room beside the others: at B = 8, 32 clusters.
// At d_head 128 a block's shared memory leaves room for one an SM, and the
// weighted sum runs in two passes of 64 columns (av_cols), each thread
// keeping both passes' sums in registers.
template <int DH, class KV, bool DROP, bool STATS>
__global__ void __launch_bounds__(THREADS_S, DH > 64 ? 1 : 3) fwd_cluster(const Args a) {
    constexpr int NT = THREADS_S, HK = TK / 2, NWX = Grid<ROWS_S, HK, NT>::NWX;
    constexpr int LQ = DH + 4, LD = kv_ld<DH, KV>(), LL = TK + 8, NW = TK / 32;
    constexpr int AC = av_cols<DH, ROWS_S, NT>(), NP = DH / AC;
    constexpr int GT = av_group<AC, ROWS_S>(), NG = NT / GT, KG = TK / NG;
    static_assert(NG * GT == NT && KG % 4 == 0 && NG * ROWS_S * DH <= ROWS_S * LL, "weighted-sum groups");
    extern __shared__ float smem[];
    TB_TRACE_BEGIN(1);
    float* lg = smem;                                   // [ROWS_S][LL]: the slice's logits, then weights
    float* part = lg;                                   // then [NG][ROWS_S][DH]; group 0's slot: the rank's sums
    float* qs = lg + ROWS_S * LL;                       // [ROWS_S][LQ]
    KV* kt = reinterpret_cast<KV*>(qs + ROWS_S * LQ);   // [TK][LD] the slice's keys
    KV* vt = kt + TK * LD;                              // [TK][LD] its values
    float* rm = reinterpret_cast<float*>(vt + TK * LD);  // [NWX][ROWS_S] the warp columns' row maxima
    float* pmax = rm + NWX * ROWS_S;                    // [ROWS_S] the slice's row max
    float* psum = pmax + ROWS_S;                        // [ROWS_S] the slice's sum of exp
    float* gmax = psum + ROWS_S;                        // [ROWS_S] the row max over T (-inf: no allowed key, dead)
    float* gsum = gmax + ROWS_S;                        // [ROWS_S] the row sum over T, in rank order
    uint32_t* bits = reinterpret_cast<uint32_t*>(gsum + ROWS_S);  // [ROWS_S][NW]

    const unsigned c = cluster_rank();
    const int CL = gridDim.x;
    const int b = blockIdx.z, h = blockIdx.y, S = a.S, T = a.T, t0 = (int)c * TK;
    const int n = max(0, min(TK, T - t0));  // the slice's keys below T
    const long long kv_base = (long long)b * T * a.D + h * DH;
    const long long stat0 = ((long long)b * a.H + h) * S;
    const int brs = a.inv_ss == 0 ? 0 : NW;
    const int rp = (S + CL - 1) / CL, r0 = (int)c * rp, r1 = min(S, r0 + rp);  // rank c writes rows r0 .. r1 - 1

    // every row dead: each rank writes its rows' zeros and leaves before the
    // first cluster barrier (all ranks read the same rows, so all leave)
    if (a.src_inv != nullptr && !__syncthreads_or((int)threadIdx.x < S && !dead_row(a, b, threadIdx.x))) {
        store_dead_rows<DH, NT, STATS, false>(a, b, h, r0, r1);
        return;
    }

    // q, the K and the V slice at once: V stays in flight through the
    // logits and the softmax
    stage_rows<DH, float, NT>(qs, a.q, (long long)b * S * a.D + h * DH, 0, ROWS_S, S, a.D, a.aligned);
    stage_rows<DH, KV, NT>(kt, static_cast<const KV*>(a.k), kv_base, t0, TK, T, a.D, a.aligned);
    cp_async_commit();
    stage_rows<DH, KV, NT>(vt, static_cast<const KV*>(a.v), kv_base, t0, TK, T, a.D, a.aligned);
    cp_async_commit();
    load_bits<NT>(bits, brs ? ROWS_S : 1, NW, a, b, 0, t0);
    for (int j = threadIdx.x; j < ROWS_S * (TK - n); j += NT)  // keys past T: weight 0 (V rows there are 0)
        lg[(j / (TK - n)) * LL + n + j % (TK - n)] = 0.f;
    cp_async_wait<1>();
    __syncthreads();
    TB_TRACE(1, 1);  // q and K arrived, the mask bits
    const bool live = __syncthreads_or(threadIdx.x < (brs ? ROWS_S : 1) * NW &&
                                       bits[(threadIdx.x / NW) * brs + threadIdx.x % NW] != 0u);
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    if (live) {  // two halves of 64 keys: 4 x 4 micro-tiles, few registers
        tile_logits<DH, KV, ROWS_S, HK, NT>(lg, LL, 0, qs, kt, t0, bits, brs, t0, T, mx);
        tile_logits<DH, KV, ROWS_S, HK, NT>(lg, LL, HK, qs, kt + HK * LD, t0 + HK, bits, brs, t0, T, mx);
    } else {  // no pair of the slice is allowed: no product
        for (int j = threadIdx.x; j < ROWS_S * n; j += NT) lg[(j / n) * LL + j % n] = -INFINITY;
    }
    __syncthreads();

    TB_TRACE(1, 2);  // the logits
    // the exact row max: each rank's over its slice, then the ranks' maxima
    store_row_max<ROWS_S, HK, NT>(rm, mx);
    __syncthreads();
    if (threadIdx.x < ROWS_S) {
        float m = -INFINITY;
        for (int x = 0; x < NWX; ++x) m = fmaxf(m, rm[x * ROWS_S + threadIdx.x]);
        pmax[threadIdx.x] = (int)threadIdx.x < S && !dead_row(a, b, threadIdx.x) ? m : -INFINITY;
    }
    cluster_sync();
    if (threadIdx.x < ROWS_S) {
        float v[MAX_CLUSTER];
        gather(v, pmax, threadIdx.x, CL);
        float m = v[0];
        for (int k = 1; k < CL; ++k) m = fmaxf(m, v[k]);
        gmax[threadIdx.x] = m;
    }
    __syncthreads();
    TB_TRACE(1, 3);  // the slice max, exchanged
    exp_rows<ROWS_S, NT>(lg, LL, n, S, gmax, psum);
    cluster_sync();
    TB_TRACE(1, 4);  // exp and the slice sum
    if (threadIdx.x < ROWS_S) {  // the slices' sums in rank order: the same float on every rank
        float v[MAX_CLUSTER];
        gather(v, psum, threadIdx.x, CL);
        float s = v[0];
        for (int k = 1; k < CL; ++k) s += v[k];
        gsum[threadIdx.x] = s;
    }
    __syncthreads();
    weights_rows<ROWS_S, NT, DROP>(lg, LL, n, S, gmax, gsum, a, stat0, t0);
    TB_TRACE(1, 5);  // the sum, exchanged, and the weights (this thread's share)

    // the slice's weighted sum: group grp takes keys grp * KG .., the
    // groups' partials added in group order, then the ranks' in rank order
    const int grp = threadIdx.x / GT, lid = threadIdx.x % GT;
    float acc[NP][4][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.f;
    cp_async_wait<0>();
    __syncthreads();
    if (live)
#pragma unroll
        for (int p = 0; p < NP; ++p)
            tile_av<DH, KV, ROWS_S, AC>(acc[p], lg, LL, grp * KG, vt, grp * KG, KG, lid, p * AC);
    __syncthreads();  // the weights are read: their buffer takes the partials
    TB_TRACE(1, 6);  // V arrived, the weighted sum
#pragma unroll
    for (int p = 0; p < NP; ++p) store_partials<DH, ROWS_S, AC>(part, acc[p], grp, lid, p * AC);
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS_S * DH; i += NT) {
        float s = part[i];
        for (int g = 1; g < NG; ++g) s += part[g * ROWS_S * DH + i];
        part[i] = s;
    }
    cluster_sync();
    TB_TRACE(1, 7);  // the groups' partials
    for (int i = r0 * DH + threadIdx.x; i < r1 * DH; i += NT) {
        const int r = i / DH, d = i % DH;
        float v[MAX_CLUSTER];
        gather(v, part, i, CL);
        float s = v[0];
        for (int k = 1; k < CL; ++k) s += v[k];
        store_out<false>(a, ((long long)b * S + r) * a.D + h * DH + d, gmax[r] == -INFINITY ? 0.f : s);
    }
    if (STATS && (int)threadIdx.x >= r0 && (int)threadIdx.x < r1) {  // -inf and 0 for an all-masked row
        a.rmax[stat0 + threadIdx.x] = gmax[threadIdx.x];
        a.rsum[stat0 + threadIdx.x] = gmax[threadIdx.x] == -INFINITY ? 0.f : gsum[threadIdx.x];
    }
    cluster_sync();  // no rank leaves while another reads its shared memory
    TB_TRACE(1, 8);  // the ranks' partials added, the output
}

// ---- K1-bf16 on the tensor cores: bf16 q, k and v
//
// A warp keeps its logits in registers: the C fragments of its 16-row
// m-tile over NJ MMA n-tiles of 8 keys (lane (g, t) holds rows
// r0 = 16 mt + g and r0 + 8, keys 2t and 2t + 1 of each n-tile). They are
// scaled and masked there, the row max is taken over the whole row (the
// warp's keys, then across warps in shared memory, and on path S across
// the cluster's ranks) before any exp, exp and the row sums (each lane's in
// key order, its 4 lanes' by a butterfly, then the warps' and the ranks' in
// order) are made in place, and each weight is divided and rounded to bf16
// as the C fragments of two n-tiles are packed into the A fragment of a
// P V k-step of 16 keys: no logit or weight goes through shared memory.

using bf16 = __nv_bfloat16;

// C-fragment n-tiles of a DH-column P V: DH / 8, and at d_head 4 one,
// whose last 4 columns are not stored.
template <int DH>
__host__ __device__ constexpr int o_tiles() { return DH < 8 ? 1 : DH / 8; }

// z[j] = the sums q k of the warp's m-tile mt of the staged q (qs
// [rows][LD]) over key n-tile j of a staged K tile kt [TK][LD] from key
// kn0: DH / 16 k-steps of bf16 MMAs; below d_head 16 one m16n8k8 k-step,
// whose columns past DH (d_head 4: the lanes of columns 4-7) are zeros.
template <int DH, int NJ>
__device__ __forceinline__ void mma_logits(float (&z)[NJ][4], const bf16* qs, int mt, const bf16* kt, int kn0) {
    constexpr int LD = kv_ld<DH, bf16>();
#pragma unroll
    for (int j = 0; j < NJ; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0.f;
    if constexpr (DH < 16) {
        const bool kin = 2 * (int)(threadIdx.x & 3) < DH;  // the lane's two k columns lie in the head
        uint32_t fa[2] = {0u, 0u};
        if (kin) tb_mma::load_a_k8(fa, qs, LD, 16 * mt, 0);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            uint32_t fb[1] = {0u};
            if (kin) tb_mma::load_b_nk_k8(fb, kt, LD, 0, kn0 + 8 * j);
            mma_bf16_1688(z[j], fa, fb);
        }
    } else {
#pragma unroll
        for (int k0 = 0; k0 < DH; k0 += 16) {
            uint32_t fa[4];
            tb_mma::load_a(fa, qs, LD, 16 * mt, k0);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                uint32_t fb[2];
                tb_mma::load_b_nk(fb, kt, LD, k0, kn0 + 8 * j);
                mma_bf16_16816(z[j], fa, fb);
            }
        }
    }
}

// mma_logits' sums times the fp32 scale 1 / sqrt(dh) (the TPU kernel's
// order), -inf where the pair is not allowed or the key is at or past T,
// in place (n-tile j's keys from global key tg0 + 8 j; the bits read as
// tile_logits reads them, word (t - bkey0) / 32 of row r's bstride), and
// the lane's max of its rows r0 (mx[0]) and r0 + 8 (mx[1]).
template <int DH, int NJ>
__device__ __forceinline__ void mask_logits(float (&z)[NJ][4], int r0, int tg0, const uint32_t* bits, int bstride,
                                            int bkey0, int T, float (&mx)[2]) {
    const float scale = (float)(1.0 / sqrt((double)DH));
    const int t2 = 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = r0 + 8 * (i >> 1), t = tg0 + 8 * j + t2 + (i & 1), tb = t - bkey0;
            const uint32_t word = t < T ? bits[r * bstride + (tb >> 5)] : 0u;
            z[j][i] = (word >> (tb & 31)) & 1u ? z[j][i] * scale : -INFINITY;
            mx[i >> 1] = fmaxf(mx[i >> 1], z[j][i]);
        }
}

// exp(z - m) in place for rows whose max m (rm) is finite (0 elsewhere),
// and the lane's sums of each row in key order.
template <int NJ>
__device__ __forceinline__ void exp_logits(float (&z)[NJ][4], const float (&rm)[2], float (&sm)[2]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float m = rm[i >> 1];
            z[j][i] = m == -INFINITY ? 0.f : expf(z[j][i] - m);
            sm[i >> 1] += z[j][i];
        }
}

// v of the lane's rows r0, r0 + 8 reduced over the row's 4 lanes (max or
// sum), written to row[r0] and row[r0 + 8] by the first of them.
template <bool MAX>
__device__ __forceinline__ void store_rows(float* row, int r0, const float (&v)[2]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const float x = MAX ? group_max<4>(v[hf]) : group_sum<4>(v[hf]);
        if ((threadIdx.x & 3) == 0) row[r0 + 8 * hf] = x;
    }
}

// o += P V over the warp's NJ 8 keys: P the weights e / sum (div_rn; 0 for
// a zero e or a row whose max is -inf) of exp_logits' e, rounded to bf16 as
// two n-tiles' C fragments are packed into a k-step's A fragment; V a
// staged tile [..][LD] from row v0 (d_head 4: one n-tile, V's columns
// past the head read as zeros).
template <int DH, int NJ>
__device__ __forceinline__ void weights_times_v(float (&o)[o_tiles<DH>()][4], const float (&z)[NJ][4], const float (&rm)[2],
                                                const float (&sum)[2], const bf16* vt, int v0) {
    constexpr int LD = kv_ld<DH, bf16>();
    bool lv[2];
    float sr[2], ir[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        lv[hf] = rm[hf] != -INFINITY;
        sr[hf] = lv[hf] ? sum[hf] : 1.f;
        ir[hf] = 1.f / sr[hf];
    }
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
        float p[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float e = z[2 * kk + jj][i];
                const int hf = i >> 1;
                p[jj][i] = lv[hf] && e != 0.f ? div_rn(e, sr[hf], ir[hf]) : 0.f;
            }
        const uint32_t fa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]), pack_bf16(p[1][0], p[1][1]),
                                pack_bf16(p[1][2], p[1][3])};
        if constexpr (DH < 8) {
            uint32_t fb[2] = {0u, 0u};
            if ((int)((threadIdx.x & 31) >> 2) < DH) tb_mma::load_b_kn(fb, vt, LD, v0 + 16 * kk, 0);
            mma_bf16_16816(o[0], fa, fb);
        } else {
#pragma unroll
            for (int d = 0; d < DH / 8; ++d) {
                uint32_t fb[2];
                tb_mma::load_b_kn(fb, vt, LD, v0 + 16 * kk, 8 * d);
                mma_bf16_16816(o[d], fa, fb);
            }
        }
    }
}

// The lane's C fragments o of rows r0, r0 + 8 into a [..][DH] fp32 array
// (d_head 4: the n-tile's first 4 columns).
template <int DH>
__device__ __forceinline__ void store_sums(float* dst, int r0, const float (&o)[o_tiles<DH>()][4]) {
    const int c = 2 * (threadIdx.x & 3);
    if constexpr (DH < 8) {
        if (c < DH) {
            float* pp = dst + r0 * DH + c;
            *reinterpret_cast<float2*>(pp) = make_float2(o[0][0], o[0][1]);
            *reinterpret_cast<float2*>(pp + 8 * DH) = make_float2(o[0][2], o[0][3]);
        }
    } else {
#pragma unroll
        for (int d = 0; d < DH / 8; ++d) {
            float* pp = dst + r0 * DH + 8 * d + c;
            *reinterpret_cast<float2*>(pp) = make_float2(o[d][0], o[d][1]);
            *reinterpret_cast<float2*>(pp + 8 * DH) = make_float2(o[d][2], o[d][3]);
        }
    }
}

// Path L of K1-bf16: blocks per (head, scene) that walk its row blocks of
// ROWS_L query rows (row block blockIdx.x, + gridDim.x, ...), T at most
// NKW TK. Warp w takes m-tile w % MT and key tile w / MT ([16, TK] logits
// in registers). Where K and V both fit beside the tiles' partial sums
// (rows_mma_both: d_head 16 and 32 at T = 1024), every K and V tile is
// staged once as the block starts and serves each of its row blocks, and
// the host gives a head as many blocks as fill the card once (the
// K/V tiles read from L2 once a block, not once a row block: the reads of
// the first design bound it). Otherwise a block takes one row block, stages
// every K tile, and V in K's place once the logits are made (landing
// during the softmax). The tiles' partial sums [nt][ROWS_L][DH] are added
// in tile order. Shared memory: q [ROWS_L][LD], the K (and V) tiles
// [nt TK][LD] in bf16, the partial sums (in K's place without V), the
// mask bits, the tiles' row maxima and sums, the rows' max and sum, each
// tile's flag.
constexpr int NKW = THREADS_L / 32 / (ROWS_L / 16);  // key tiles of a path-L block of K1-bf16 (a warp's each)

template <int DH>
__host__ __device__ inline size_t rows_mma_bytes(int nt, bool both) {
    return 2 * ((size_t)ROWS_L + (both ? 2 : 1) * nt * TK) * kv_ld<DH, bf16>() +
           sizeof(float) * ((both ? (size_t)nt * ROWS_L * DH : 0) + (size_t)ROWS_L * nt * (TK / 32) +
                            (2 * NKW + 2) * ROWS_L + nt);
}

// K and V stay resident beside the partial sums
template <int DH>
__host__ __device__ inline bool rows_mma_both(int nt) { return rows_mma_bytes<DH>(nt, true) <= SMEM_OPTIN; }

template <int DH>
size_t rows_mma_smem(int T) {
    const int nt = (T + TK - 1) / TK;
    return rows_mma_bytes<DH>(nt, rows_mma_both<DH>(nt));
}

// Blocks a head of path L of K1-bf16: with K and V resident, as many as
// fill the card's n_sm SMs once (one block an SM) when the heads alone do
// not; otherwise one a row block.
template <int DH>
int rows_mma_blocks(const Args& a, int n_sm) {
    const int n_rb = (a.S + ROWS_L - 1) / ROWS_L;
    const long long heads = (long long)a.B * a.H;
    if (!rows_mma_both<DH>((a.T + TK - 1) / TK) || heads >= n_sm) return n_rb;
    return min(n_rb, max(1, n_sm / (int)heads));
}

template <int DH>
__global__ void __launch_bounds__(THREADS_L, 1) fwd_rows_mma(const Args a) {
    constexpr int NT = THREADS_L, MT = ROWS_L / 16, NJ = TK / 8, LD = kv_ld<DH, bf16>();
    static_assert(NKW == MAX_CLUSTER, "a key tile a warp");
    extern __shared__ float smem[];
    const int T = a.T, nt = (T + TK - 1) / TK, nw = nt * (TK / 32);
    const bool both = rows_mma_both<DH>(nt);
    bf16* qs = reinterpret_cast<bf16*>(smem);             // [ROWS_L][LD]
    bf16* kt0 = qs + ROWS_L * LD;                         // [nt TK][LD]: K
    bf16* vt0 = both ? kt0 + nt * TK * LD : kt0;          // [nt TK][LD]: V, beside K or in its place
    float* end = reinterpret_cast<float*>(vt0 + nt * TK * LD);
    float* part = both ? end : reinterpret_cast<float*>(kt0);  // [nt][ROWS_L][DH], in K's place without V
    uint32_t* bits = reinterpret_cast<uint32_t*>(both ? end + nt * ROWS_L * DH : end);  // [ROWS_L][nw]
    float* tmax = reinterpret_cast<float*>(bits + ROWS_L * nw);  // [NKW][ROWS_L] each tile's row max
    float* tsum = tmax + NKW * ROWS_L;                    // [NKW][ROWS_L] each tile's row sum of exp
    float* mrow = tsum + NKW * ROWS_L;                    // [ROWS_L] the row max (-inf: no allowed key, dead, past S)
    float* srow = mrow + ROWS_L;                          // [ROWS_L] the row sum
    int* flag = reinterpret_cast<int*>(srow + ROWS_L);    // [nt] a tile has an allowed pair

    const int b = blockIdx.z, h = blockIdx.y, n_rb = (a.S + ROWS_L - 1) / ROWS_L;
    const long long kv_base = (long long)b * T * a.D + h * DH;
    const bf16* K = static_cast<const bf16*>(a.k);
    const bf16* V = static_cast<const bf16*>(a.v);
    const int brs = a.inv_ss == 0 ? 0 : nw;  // row stride of the bits: 0 for a padding mask
    const int w = threadIdx.x >> 5, mt = w % MT, kt = w / MT, r0 = 16 * mt + ((threadIdx.x & 31) >> 2);

    if (both) {  // K and V once, for every row block of the block
        stage_rows<DH, bf16, NT>(kt0, K, kv_base, 0, nt * TK, T, a.D, a.aligned);
        stage_rows<DH, bf16, NT>(vt0, V, kv_base, 0, nt * TK, T, a.D, a.aligned);
        cp_async_commit();
    }
    bool have_bits = false;  // a padding mask's bits and live tiles serve every row block
    for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
        TB_TRACE_BEGIN(0);
        const int s0 = rb * ROWS_L, rows = min(ROWS_L, a.S - s0);
        if (a.src_inv != nullptr && !__syncthreads_or((int)threadIdx.x < rows && !dead_row(a, b, s0 + threadIdx.x))) {
            store_dead_rows<DH, NT, false, true>(a, b, h, s0, s0 + rows);  // no live row
            continue;
        }
        stage_rows<DH, bf16, NT>(qs, reinterpret_cast<const bf16*>(a.q), ((long long)b * a.S + s0) * a.D + h * DH, 0,
                                 ROWS_L, rows, a.D, a.aligned);
        if (!both) stage_rows<DH, bf16, NT>(kt0, K, kv_base, 0, nt * TK, T, a.D, a.aligned);
        cp_async_commit();
        if (!have_bits || brs != 0) {
            have_bits = true;
            load_bits<NT>(bits, brs ? ROWS_L : 1, nw, a, b, s0, 0);
            for (int i = threadIdx.x; i < nt; i += NT) flag[i] = 0;
            __syncthreads();
            for (int i = threadIdx.x; i < (brs ? ROWS_L : 1) * nw; i += NT)  // live tiles: some pair allowed
                if (bits[i] != 0u) atomicOr(&flag[(i % nw) / (TK / 32)], 1);
        }
        TB_TRACE(0, 1);  // q (K, V) issued, the mask bits and live tiles
        cp_async_wait<0>();
        __syncthreads();
        TB_TRACE(0, 2);  // q and K arrived

        const bool mine = kt < nt && flag[kt];  // the warp's key tile is live
        float z[NJ][4];
        float mx[2] = {-INFINITY, -INFINITY};
        if (mine) {
            mma_logits<DH, NJ>(z, qs, mt, kt0 + kt * TK * LD, 0);
            mask_logits<DH, NJ>(z, r0, kt * TK, bits, brs, 0, T, mx);
        }
        if (kt < nt) store_rows<true>(tmax + kt * ROWS_L, r0, mx);
        __syncthreads();  // every K read: V may take its place
        TB_TRACE(0, 3);  // the logits
        if (!both) {  // V in K's place, landing during the softmax
            for (int i = 0; i < nt; ++i)
                if (flag[i]) stage_rows<DH, bf16, NT>(vt0 + i * TK * LD, V, kv_base, i * TK, TK, T, a.D, a.aligned);
            cp_async_commit();
        }
        if (threadIdx.x < ROWS_L) {  // the exact row max over every tile
            float m = -INFINITY;
            for (int x = 0; x < nt; ++x) m = fmaxf(m, tmax[x * ROWS_L + threadIdx.x]);
            mrow[threadIdx.x] = (int)threadIdx.x < rows && !dead_row(a, b, s0 + threadIdx.x) ? m : -INFINITY;
        }
        __syncthreads();
        const float rm[2] = {mrow[r0], mrow[r0 + 8]};
        float sm[2] = {0.f, 0.f};
        if (mine) exp_logits<NJ>(z, rm, sm);
        if (kt < nt) store_rows<false>(tsum + kt * ROWS_L, r0, sm);
        __syncthreads();
        if (threadIdx.x < ROWS_L) {  // the tiles' sums in tile order
            float s = 0.f;
            for (int x = 0; x < nt; ++x) s += tsum[x * ROWS_L + threadIdx.x];
            srow[threadIdx.x] = s;
        }
        cp_async_wait<0>();
        __syncthreads();  // the row sums written, V arrived
        TB_TRACE(0, 4);  // the row max, exp and sum, V

        float o[o_tiles<DH>()][4];
#pragma unroll
        for (int d = 0; d < o_tiles<DH>(); ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
        if (mine) {
            const float sum[2] = {srow[r0], srow[r0 + 8]};
            weights_times_v<DH, NJ>(o, z, rm, sum, vt0 + kt * TK * LD, 0);
        }
        if (!both) __syncthreads();  // every V read: K's place takes the partial sums
        TB_TRACE(0, 5);  // the weights and the weighted sum
        if (kt < nt) store_sums<DH>(part + kt * ROWS_L * DH, r0, o);
        __syncthreads();
        for (int i = threadIdx.x; i < rows * DH; i += NT) {
            const int r = i / DH, c = i % DH;
            float s = part[i];
            for (int x = 1; x < nt; ++x) s += part[x * ROWS_L * DH + i];
            store_out<true>(a, ((long long)b * a.S + s0 + r) * a.D + h * DH + c, mrow[r] == -INFINITY ? 0.f : s);
        }
        __syncthreads();  // q, the partials, the row statistics free for the next row block
        TB_TRACE(0, 6);  // the tiles' partials, the output
    }
    cp_async_wait<0>();  // no copy in flight when the block leaves
}

// Path L of K1-bf16 at d_head 128, where the K tiles of T = 1024 keys
// (278 KB) do not fit a block: fwd_rows_mma's warps and arithmetic (warp w
// the m-tile w % MT of key tile w / MT, the logits and weights in its
// registers), one row block a block, with K and V staged in slabs of CS =
// 64 columns of every key tile, one slab at a time in one buffer. The
// logits' k-steps run over the slabs in column order into the same C
// fragments (the sums of a whole-row kernel, in its order); the weighted
// sum runs a slab of output columns at a time from the weights packed once
// into A fragments (32 registers where the logits took 64), its tiles'
// partial sums added in tile order as fwd_rows_mma adds them.
// Shared memory: q [ROWS_L][LDQ] in bf16, the slab [nt TK][CS + 8] in
// bf16, the tiles' partial sums of a slab [nt][ROWS_L][CS], the mask bits
// and the row statistics as fwd_rows_mma's. rows_mma_slab_smem.
constexpr int CS = 64;  // columns of a K/V slab

template <int DH>
size_t rows_mma_slab_smem(int T) {
    const int nt = (T + TK - 1) / TK;
    return 2 * ((size_t)ROWS_L * kv_ld<DH, bf16>() + (size_t)nt * TK * kv_ld<CS, bf16>()) +
           sizeof(float) * ((size_t)nt * ROWS_L * CS + (size_t)ROWS_L * nt * (TK / 32) + (2 * NKW + 2) * ROWS_L + nt);
}

// z[j] += the sums q k over columns c0 .. c0 + W - 1 of the warp's m-tile
// mt of q (qs [rows][ldq]) with key n-tile j of a slab kt [..][ldk] of
// those columns from key kn0: W / 16 k-steps of bf16 MMAs.
template <int NJ, int W = CS>
__device__ __forceinline__ void mma_logits_slab(float (&z)[NJ][4], const bf16* qs, int ldq, int c0, int mt,
                                                const bf16* kt, int ldk, int kn0) {
#pragma unroll
    for (int k0 = 0; k0 < W; k0 += 16) {
        uint32_t fa[4];
        tb_mma::load_a(fa, qs, ldq, 16 * mt, c0 + k0);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            uint32_t fb[2];
            tb_mma::load_b_nk(fb, kt, ldk, k0, kn0 + 8 * j);
            mma_bf16_16816(z[j], fa, fb);
        }
    }
}

// The weights of weights_times_v (e / sum, div_rn; 0 for a zero e or a row
// whose max is -inf), rounded to bf16 and packed into the A fragments of
// the NJ / 2 k-steps of 16 keys, once for every slab of V.
template <int NJ>
__device__ __forceinline__ void pack_weights(uint32_t (&pa)[NJ / 2][4], const float (&z)[NJ][4], const float (&rm)[2],
                                             const float (&sum)[2]) {
    bool lv[2];
    float sr[2], ir[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        lv[hf] = rm[hf] != -INFINITY;
        sr[hf] = lv[hf] ? sum[hf] : 1.f;
        ir[hf] = 1.f / sr[hf];
    }
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
        float p[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float e = z[2 * kk + jj][i];
                const int hf = i >> 1;
                p[jj][i] = lv[hf] && e != 0.f ? div_rn(e, sr[hf], ir[hf]) : 0.f;
            }
        pa[kk][0] = pack_bf16(p[0][0], p[0][1]);
        pa[kk][1] = pack_bf16(p[0][2], p[0][3]);
        pa[kk][2] = pack_bf16(p[1][0], p[1][1]);
        pa[kk][3] = pack_bf16(p[1][2], p[1][3]);
    }
}

// o += P V over the warp's NJ 8 keys for the W columns of a V slab vt
// [..][LD] from row v0, P the packed weights of pack_weights (W = 4: one
// n-tile, the slab's columns past it read as zeros).
template <int NJ, int W = CS>
__device__ __forceinline__ void packed_times_v(float (&o)[o_tiles<W>()][4], const uint32_t (&pa)[NJ / 2][4],
                                               const bf16* vt, int v0) {
    constexpr int LD = kv_ld<W, bf16>();
    if constexpr (W < 8) {
        const bool nin = (int)((threadIdx.x & 31) >> 2) < W;
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk) {
            uint32_t fb[2] = {0u, 0u};
            if (nin) tb_mma::load_b_kn(fb, vt, LD, v0 + 16 * kk, 0);
            mma_bf16_16816(o[0], pa[kk], fb);
        }
    } else {
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk)
#pragma unroll
            for (int d = 0; d < W / 8; ++d) {
                uint32_t fb[2];
                tb_mma::load_b_kn(fb, vt, LD, v0 + 16 * kk, 8 * d);
                mma_bf16_16816(o[d], pa[kk], fb);
            }
    }
}

template <int DH>
__global__ void __launch_bounds__(THREADS_L, 1) fwd_rows_mma_slab(const Args a) {
    constexpr int NT = THREADS_L, MT = ROWS_L / 16, NJ = TK / 8, LDQ = kv_ld<DH, bf16>(), LDS = kv_ld<CS, bf16>();
    static_assert(NKW == MAX_CLUSTER && DH % CS == 0, "a key tile a warp, whole slabs");
    extern __shared__ float smem[];
    TB_TRACE_BEGIN(0);
    const int T = a.T, nt = (T + TK - 1) / TK, nw = nt * (TK / 32);
    bf16* qs = reinterpret_cast<bf16*>(smem);             // [ROWS_L][LDQ]
    bf16* sl = qs + ROWS_L * LDQ;                         // [nt TK][LDS]: a slab of K, then of V
    float* part = reinterpret_cast<float*>(sl + nt * TK * LDS);  // [nt][ROWS_L][CS] a slab's partial sums
    uint32_t* bits = reinterpret_cast<uint32_t*>(part + nt * ROWS_L * CS);  // [ROWS_L][nw]
    float* tmax = reinterpret_cast<float*>(bits + ROWS_L * nw);  // [NKW][ROWS_L] each tile's row max
    float* tsum = tmax + NKW * ROWS_L;                    // [NKW][ROWS_L] each tile's row sum of exp
    float* mrow = tsum + NKW * ROWS_L;                    // [ROWS_L] the row max (-inf: no allowed key, dead, past S)
    float* srow = mrow + ROWS_L;                          // [ROWS_L] the row sum
    int* flag = reinterpret_cast<int*>(srow + ROWS_L);    // [nt] a tile has an allowed pair

    const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * ROWS_L, rows = min(ROWS_L, a.S - s0);
    const long long kv_base = (long long)b * T * a.D + h * DH;
    const bf16* K = static_cast<const bf16*>(a.k);
    const bf16* V = static_cast<const bf16*>(a.v);
    const int brs = a.inv_ss == 0 ? 0 : nw;  // row stride of the bits: 0 for a padding mask
    const int w = threadIdx.x >> 5, mt = w % MT, kt = w / MT, r0 = 16 * mt + ((threadIdx.x & 31) >> 2);

    if (a.src_inv != nullptr && !__syncthreads_or((int)threadIdx.x < rows && !dead_row(a, b, s0 + threadIdx.x))) {
        store_dead_rows<DH, NT, false, true>(a, b, h, s0, s0 + rows);  // no live row
        return;
    }
    stage_rows<DH, bf16, NT>(qs, reinterpret_cast<const bf16*>(a.q), ((long long)b * a.S + s0) * a.D + h * DH, 0,
                             ROWS_L, rows, a.D, a.aligned);
    stage_rows<CS, bf16, NT>(sl, K, kv_base, 0, nt * TK, T, a.D, a.aligned);
    cp_async_commit();
    load_bits<NT>(bits, brs ? ROWS_L : 1, nw, a, b, s0, 0);
    for (int i = threadIdx.x; i < nt; i += NT) flag[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < (brs ? ROWS_L : 1) * nw; i += NT)  // live tiles: some pair allowed
        if (bits[i] != 0u) atomicOr(&flag[(i % nw) / (TK / 32)], 1);
    cp_async_wait<0>();
    __syncthreads();
    TB_TRACE(0, 1);  // q and K's first slab arrived, the mask bits and live tiles

    const bool mine = kt < nt && flag[kt];  // the warp's key tile is live
    float z[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0.f;
    for (int c0 = 0; c0 < DH; c0 += CS) {
        if (c0 > 0) {  // every warp is done with the last slab: the next one in its place
            stage_rows<CS, bf16, NT>(sl, K + c0, kv_base, 0, nt * TK, T, a.D, a.aligned);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
        }
        if (mine) mma_logits_slab<NJ>(z, qs, LDQ, c0, mt, sl + kt * TK * LDS, LDS, 0);
        __syncthreads();
    }
    float mx[2] = {-INFINITY, -INFINITY};
    if (mine) mask_logits<DH, NJ>(z, r0, kt * TK, bits, brs, 0, T, mx);
    if (kt < nt) store_rows<true>(tmax + kt * ROWS_L, r0, mx);
    TB_TRACE(0, 2);  // the logits
    for (int i = 0; i < nt; ++i)  // V's first slab, landing during the softmax
        if (flag[i]) stage_rows<CS, bf16, NT>(sl + i * TK * LDS, V, kv_base, i * TK, TK, T, a.D, a.aligned);
    cp_async_commit();
    __syncthreads();
    if (threadIdx.x < ROWS_L) {  // the exact row max over every tile
        float m = -INFINITY;
        for (int x = 0; x < nt; ++x) m = fmaxf(m, tmax[x * ROWS_L + threadIdx.x]);
        mrow[threadIdx.x] = (int)threadIdx.x < rows && !dead_row(a, b, s0 + threadIdx.x) ? m : -INFINITY;
    }
    __syncthreads();
    const float rm[2] = {mrow[r0], mrow[r0 + 8]};
    float sm[2] = {0.f, 0.f};
    if (mine) exp_logits<NJ>(z, rm, sm);
    if (kt < nt) store_rows<false>(tsum + kt * ROWS_L, r0, sm);
    __syncthreads();
    if (threadIdx.x < ROWS_L) {  // the tiles' sums in tile order
        float s = 0.f;
        for (int x = 0; x < nt; ++x) s += tsum[x * ROWS_L + threadIdx.x];
        srow[threadIdx.x] = s;
    }
    cp_async_wait<0>();
    __syncthreads();  // the row sums written, V's first slab arrived
    TB_TRACE(0, 3);  // the row max, exp and sum
    uint32_t pa[NJ / 2][4];  // the weights, packed once for every slab
    if (mine) {
        const float sum[2] = {srow[r0], srow[r0 + 8]};
        pack_weights<NJ>(pa, z, rm, sum);
    }

    for (int c0 = 0; c0 < DH; c0 += CS) {
        if (c0 > 0) {  // every warp is done with the last slab
            for (int i = 0; i < nt; ++i)
                if (flag[i]) stage_rows<CS, bf16, NT>(sl + i * TK * LDS, V + c0, kv_base, i * TK, TK, T, a.D, a.aligned);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
        }
        float o[CS / 8][4];
#pragma unroll
        for (int d = 0; d < CS / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
        if (mine) packed_times_v<NJ>(o, pa, sl + kt * TK * LDS, 0);
        if (kt < nt) store_sums<CS>(part + kt * ROWS_L * CS, r0, o);
        __syncthreads();  // every partial written, every V read
        for (int i = threadIdx.x; i < rows * CS; i += NT) {
            const int r = i / CS, c = i % CS;
            float s = part[i];
            for (int x = 1; x < nt; ++x) s += part[x * ROWS_L * CS + i];
            store_out<true>(a, ((long long)b * a.S + s0 + r) * a.D + h * DH + c0 + c, mrow[r] == -INFINITY ? 0.f : s);
        }
        __syncthreads();  // the partials read
    }
    TB_TRACE(0, 4);  // the weights, the weighted sum, the output
}

// Path L of K1-bf16 past NKW key tiles (T > 1024): fwd_rows_mma's warps
// and arithmetic (warp w the m-tile w % MT; its logits and weights in
// registers as C fragments), one row block a block, with warp column kt
// taking key tiles kt, kt + NKW, ... in rounds of NKW tiles. No round's
// logits outlive it: three passes over the rounds recompute each tile's
// logits on the tensor cores (the same MMAs in the same order, so the same
// sums each time), first for each tile's row max, then, after the exact
// row max over all tiles, for each tile's sum of exp (the row sum adds the
// tiles' sums in tile order), then for the weights, divided and rounded to
// bf16 as fwd_rows_mma rounds them, and P V. A round's K, then its V, is
// staged in slabs of LW = min(DH, 32) columns of its NKW tiles
// ([NKW TK][LW + 8] bf16, 82 KB), so the block's shared memory grows with T
// only by the mask bits and each tile's row max and sum; the weighted sum
// runs a slab of LW output columns at a time (the rounds' logits recomputed
// for each past d_head 32), each warp column's P V summed over its tiles in
// the MMAs' accumulators and the warp columns' sums added in order.
// Shared memory: q [ROWS_L][LDQ] in bf16, the slab (then the warp
// columns' partial sums [NKW][ROWS_L][LW]), the mask bits, each tile's
// row max and sum [nt][ROWS_L], the rows' max and sum, each tile's flag.
template <int DH>
__host__ __device__ constexpr int long_cols() { return DH < 32 ? DH : 32; }

template <int DH>
size_t rows_mma_long_smem(int T) {
    constexpr int LW = long_cols<DH>();
    const int nt = (T + TK - 1) / TK;
    return 2 * (size_t)ROWS_L * kv_ld<DH, bf16>() + 2 * (size_t)NKW * TK * kv_ld<LW, bf16>() +
           sizeof(float) * ((size_t)ROWS_L * nt * (TK / 32) + (size_t)2 * nt * ROWS_L + 2 * ROWS_L + nt);
}

template <int DH>
__global__ void __launch_bounds__(THREADS_L, 1) fwd_rows_mma_long(const Args a) {
    constexpr int NT = THREADS_L, MT = ROWS_L / 16, NJ = TK / 8, LW = long_cols<DH>();
    constexpr int LDQ = kv_ld<DH, bf16>(), LDS = kv_ld<LW, bf16>();
    static_assert(DH % LW == 0 && NKW * ROWS_L * LW * 4 <= NKW * TK * LDS * 2, "whole slabs; the partials in the slab");
    extern __shared__ float smem[];
    TB_TRACE_BEGIN(0);
    const int T = a.T, nt = (T + TK - 1) / TK, nw = nt * (TK / 32), n_round = (nt + NKW - 1) / NKW;
    bf16* qs = reinterpret_cast<bf16*>(smem);             // [ROWS_L][LDQ]
    bf16* sl = qs + ROWS_L * LDQ;                         // [NKW TK][LDS]: a slab of a round's K or V tiles
    float* part = reinterpret_cast<float*>(sl);           // then [NKW][ROWS_L][LW] the warp columns' sums
    uint32_t* bits = reinterpret_cast<uint32_t*>(sl + NKW * TK * LDS);  // [ROWS_L][nw]
    float* tmax = reinterpret_cast<float*>(bits + ROWS_L * nw);  // [nt][ROWS_L] each tile's row max
    float* tsum = tmax + nt * ROWS_L;                     // [nt][ROWS_L] each tile's row sum of exp
    float* mrow = tsum + nt * ROWS_L;                     // [ROWS_L] the row max (-inf: no allowed key, dead, past S)
    float* srow = mrow + ROWS_L;                          // [ROWS_L] the row sum
    int* flag = reinterpret_cast<int*>(srow + ROWS_L);    // [nt] a tile has an allowed pair

    const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * ROWS_L, rows = min(ROWS_L, a.S - s0);
    const long long kv_base = (long long)b * T * a.D + h * DH;
    const bf16* K = static_cast<const bf16*>(a.k);
    const bf16* V = static_cast<const bf16*>(a.v);
    const int brs = a.inv_ss == 0 ? 0 : nw;  // row stride of the bits: 0 for a padding mask
    const int w = threadIdx.x >> 5, mt = w % MT, kt = w / MT, r0 = 16 * mt + ((threadIdx.x & 31) >> 2);

    if (a.src_inv != nullptr && !__syncthreads_or((int)threadIdx.x < rows && !dead_row(a, b, s0 + threadIdx.x))) {
        store_dead_rows<DH, NT, false, true>(a, b, h, s0, s0 + rows);  // no live row
        return;
    }
    stage_rows<DH, bf16, NT>(qs, reinterpret_cast<const bf16*>(a.q), ((long long)b * a.S + s0) * a.D + h * DH, 0,
                             ROWS_L, rows, a.D, a.aligned);
    cp_async_commit();
    load_bits<NT>(bits, brs ? ROWS_L : 1, nw, a, b, s0, 0);
    for (int i = threadIdx.x; i < nt; i += NT) flag[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < (brs ? ROWS_L : 1) * nw; i += NT)  // live tiles: some pair allowed
        if (bits[i] != 0u) atomicOr(&flag[(i % nw) / (TK / 32)], 1);
    cp_async_wait<0>();
    __syncthreads();
    TB_TRACE(0, 1);  // q arrived, the mask bits and live tiles

    // columns c0 .. c0 + LW - 1 of src's live tiles of round r into the slab
    // (the caller's barrier comes first: the slab's last readers are done)
    auto stage_slab = [&](const bf16* src, int r, int c0) {
        for (int i = 0; i < NKW; ++i) {
            const int t = r * NKW + i;
            if (t < nt && flag[t]) stage_rows<LW, bf16, NT>(sl + i * TK * LDS, src + c0, kv_base, t * TK, TK, T, a.D,
                                                            a.aligned);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
    };
    // the masked, scaled logits of the warp's tile of round r (mine: it is
    // live) and the lane's row maxima over them
    float z[NJ][4];
    auto logits = [&](int r, float (&mx)[2]) -> bool {
        const int tile = r * NKW + kt;
        const bool mine = tile < nt && flag[tile];
#pragma unroll
        for (int j = 0; j < NJ; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0.f;
        for (int c0 = 0; c0 < DH; c0 += LW) {
            __syncthreads();
            stage_slab(K, r, c0);
            if constexpr (LW < 16) {  // d_head 8 and 4: the whole head in one slab, one m16n8k8 k-step
                if (mine) mma_logits<DH, NJ>(z, qs, mt, sl + kt * TK * LDS, 0);
            } else {
                if (mine) mma_logits_slab<NJ, LW>(z, qs, LDQ, c0, mt, sl + kt * TK * LDS, LDS, 0);
            }
        }
        if (mine) mask_logits<DH, NJ>(z, r0, tile * TK, bits, brs, 0, T, mx);
        return mine;
    };

    for (int r = 0; r < n_round; ++r) {  // each tile's row max
        float mx[2] = {-INFINITY, -INFINITY};
        logits(r, mx);
        if (r * NKW + kt < nt) store_rows<true>(tmax + (r * NKW + kt) * ROWS_L, r0, mx);
    }
    __syncthreads();
    TB_TRACE(0, 2);  // the logits, each tile's row max
    if (threadIdx.x < ROWS_L) {  // the exact row max over every tile
        float m = -INFINITY;
        for (int x = 0; x < nt; ++x) m = fmaxf(m, tmax[x * ROWS_L + threadIdx.x]);
        mrow[threadIdx.x] = (int)threadIdx.x < rows && !dead_row(a, b, s0 + threadIdx.x) ? m : -INFINITY;
    }
    __syncthreads();
    const float rm[2] = {mrow[r0], mrow[r0 + 8]};
    for (int r = 0; r < n_round; ++r) {  // each tile's sum of exp
        float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
        if (logits(r, mx)) exp_logits<NJ>(z, rm, sm);
        if (r * NKW + kt < nt) store_rows<false>(tsum + (r * NKW + kt) * ROWS_L, r0, sm);
    }
    __syncthreads();
    if (threadIdx.x < ROWS_L) {  // the tiles' sums in tile order
        float s = 0.f;
        for (int x = 0; x < nt; ++x) s += tsum[x * ROWS_L + threadIdx.x];
        srow[threadIdx.x] = s;
    }
    __syncthreads();
    TB_TRACE(0, 3);  // the logits again, the row max, exp and sum
    const float sum[2] = {srow[r0], srow[r0 + 8]};

    for (int c0 = 0; c0 < DH; c0 += LW) {  // a slab of output columns
        float o[o_tiles<LW>()][4];
#pragma unroll
        for (int d = 0; d < o_tiles<LW>(); ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
        for (int r = 0; r < n_round; ++r) {
            float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
            const bool mine = logits(r, mx);
            uint32_t pa[NJ / 2][4];  // the weights of the warp's tile
            if (mine) {
                exp_logits<NJ>(z, rm, sm);
                pack_weights<NJ>(pa, z, rm, sum);
            }
            __syncthreads();
            stage_slab(V, r, c0);
            if (mine) packed_times_v<NJ, LW>(o, pa, sl + kt * TK * LDS, 0);
        }
        __syncthreads();  // every V read: the slab takes the partial sums
        store_sums<LW>(part + kt * ROWS_L * LW, r0, o);
        __syncthreads();
        for (int i = threadIdx.x; i < rows * LW; i += NT) {
            const int r = i / LW, c = i % LW;
            float s = part[i];
            for (int x = 1; x < NKW; ++x) s += part[x * ROWS_L * LW + i];
            store_out<true>(a, ((long long)b * a.S + s0 + r) * a.D + h * DH + c0 + c, mrow[r] == -INFINITY ? 0.f : s);
        }
    }
    TB_TRACE(0, 4);  // the logits again, the weights, the weighted sum, the output
}

// Path S of K1-bf16: a cluster of ranks per (head, scene), a TK-key slice
// of T each, as fwd_cluster. Its 8 warps take 4 m-tiles x 2 key halves of
// the slice ([16, TK / 2] logits in registers); the halves' row maxima
// and sums, then the ranks', are exchanged as fwd_cluster exchanges them,
// and the halves' weighted sums are added in order, then the ranks' in rank
// order. Four blocks an SM (registers and shared memory allow it: the
// cluster's exchanges leave a block waiting, and more blocks hide that).
// Shared memory, in floats: the halves' partial sums [2][ROWS_S][DH]
// (then the rank's sums), q [ROWS_S][LD] and the K and V slices [TK][LD]
// in bf16, the halves' row maxima and sums, the rows' slice max, slice
// sum, max and sum, the mask bits [ROWS_S][TK / 32].
template <int DH>
size_t cluster_mma_smem() {
    return sizeof(float) * ((size_t)2 * ROWS_S * DH + (ROWS_S + 2 * TK) * kv_ld<DH, bf16>() / 2 + 8 * ROWS_S +
                            ROWS_S * (TK / 32));
}

template <int DH>
__global__ void __launch_bounds__(THREADS_S, DH > 64 ? 1 : 4) fwd_cluster_mma(const Args a) {
    constexpr int NT = THREADS_S, MT = ROWS_S / 16, NH = NT / 32 / MT, NJ = TK / NH / 8;
    constexpr int LD = kv_ld<DH, bf16>(), NW = TK / 32;
    static_assert(NH == 2 && NJ % 2 == 0, "two key halves");
    extern __shared__ float smem[];
    TB_TRACE_BEGIN(1);
    float* part = smem;                                   // [2][ROWS_S][DH] the halves' sums; [0] then the rank's
    bf16* qs = reinterpret_cast<bf16*>(part + 2 * ROWS_S * DH);  // [ROWS_S][LD]
    bf16* kt = qs + ROWS_S * LD;                          // [TK][LD] the slice's keys
    bf16* vt = kt + TK * LD;                              // [TK][LD] its values
    float* hmax = reinterpret_cast<float*>(vt + TK * LD);  // [2][ROWS_S] the halves' row maxima
    float* hsum = hmax + 2 * ROWS_S;                      // [2][ROWS_S] the halves' row sums
    float* pmax = hsum + 2 * ROWS_S;                      // [ROWS_S] the slice's row max
    float* psum = pmax + ROWS_S;                          // [ROWS_S] the slice's sum of exp
    float* gmax = psum + ROWS_S;                          // [ROWS_S] the row max over T (-inf: no allowed key, dead)
    float* gsum = gmax + ROWS_S;                          // [ROWS_S] the row sum over T, in rank order
    uint32_t* bits = reinterpret_cast<uint32_t*>(gsum + ROWS_S);  // [ROWS_S][NW]

    const unsigned c = cluster_rank();
    const int CL = gridDim.x;
    const int b = blockIdx.z, h = blockIdx.y, S = a.S, T = a.T, t0 = (int)c * TK;
    const long long kv_base = (long long)b * T * a.D + h * DH;
    const int brs = a.inv_ss == 0 ? 0 : NW;
    const int rp = (S + CL - 1) / CL, rb = (int)c * rp, re = min(S, rb + rp);  // rank c writes rows rb .. re - 1
    const int w = threadIdx.x >> 5, mt = w % MT, half = w / MT, r0 = 16 * mt + ((threadIdx.x & 31) >> 2);

    // every row dead: each rank writes its rows' zeros and leaves before the
    // first cluster barrier (all ranks read the same rows, so all leave)
    if (a.src_inv != nullptr && !__syncthreads_or((int)threadIdx.x < S && !dead_row(a, b, threadIdx.x))) {
        store_dead_rows<DH, NT, false, true>(a, b, h, rb, re);
        return;
    }

    // q, the K and the V slice at once: V stays in flight through the
    // logits and the softmax
    stage_rows<DH, bf16, NT>(qs, reinterpret_cast<const bf16*>(a.q), (long long)b * S * a.D + h * DH, 0, ROWS_S, S, a.D,
                             a.aligned);
    stage_rows<DH, bf16, NT>(kt, static_cast<const bf16*>(a.k), kv_base, t0, TK, T, a.D, a.aligned);
    cp_async_commit();
    stage_rows<DH, bf16, NT>(vt, static_cast<const bf16*>(a.v), kv_base, t0, TK, T, a.D, a.aligned);
    cp_async_commit();
    load_bits<NT>(bits, brs ? ROWS_S : 1, NW, a, b, 0, t0);
    cp_async_wait<1>();
    __syncthreads();
    TB_TRACE(1, 1);  // q and K arrived, the mask bits
    const bool live = __syncthreads_or(threadIdx.x < (brs ? ROWS_S : 1) * NW &&
                                       bits[(threadIdx.x / NW) * brs + threadIdx.x % NW] != 0u);
    float z[NJ][4];
    float mx[2] = {-INFINITY, -INFINITY};
    if (live) {  // no pair of the slice allowed: no product, every logit -inf
        mma_logits<DH, NJ>(z, qs, mt, kt, NJ * 8 * half);
        mask_logits<DH, NJ>(z, r0, t0 + NJ * 8 * half, bits, brs, t0, T, mx);
    }
    store_rows<true>(hmax + half * ROWS_S, r0, mx);
    __syncthreads();
    TB_TRACE(1, 2);  // the logits
    // the exact row max: each rank's over its slice, then the ranks' maxima
    if (threadIdx.x < ROWS_S) {
        const float m = fmaxf(hmax[threadIdx.x], hmax[ROWS_S + threadIdx.x]);
        pmax[threadIdx.x] = (int)threadIdx.x < S && !dead_row(a, b, threadIdx.x) ? m : -INFINITY;
    }
    cluster_sync();
    if (threadIdx.x < ROWS_S) {
        float v[MAX_CLUSTER];
        gather(v, pmax, threadIdx.x, CL);
        float m = v[0];
        for (int k = 1; k < CL; ++k) m = fmaxf(m, v[k]);
        gmax[threadIdx.x] = m;
    }
    __syncthreads();
    TB_TRACE(1, 3);  // the slice max, exchanged
    const float rm[2] = {gmax[r0], gmax[r0 + 8]};
    float sm[2] = {0.f, 0.f};
    if (live) exp_logits<NJ>(z, rm, sm);
    store_rows<false>(hsum + half * ROWS_S, r0, sm);
    __syncthreads();
    if (threadIdx.x < ROWS_S) psum[threadIdx.x] = hsum[threadIdx.x] + hsum[ROWS_S + threadIdx.x];
    cluster_sync();
    TB_TRACE(1, 4);  // exp and the slice sum
    if (threadIdx.x < ROWS_S) {  // the slices' sums in rank order: the same float on every rank
        float v[MAX_CLUSTER];
        gather(v, psum, threadIdx.x, CL);
        float s = v[0];
        for (int k = 1; k < CL; ++k) s += v[k];
        gsum[threadIdx.x] = s;
    }
    cp_async_wait<0>();
    __syncthreads();  // the sums written, V arrived
    TB_TRACE(1, 5);  // the sum, exchanged, V

    // the halves' weighted sums, added in order into the rank's, then the
    // ranks' in rank order
    float o[o_tiles<DH>()][4];
#pragma unroll
    for (int d = 0; d < o_tiles<DH>(); ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    if (live) {
        const float sum[2] = {gsum[r0], gsum[r0 + 8]};
        weights_times_v<DH, NJ>(o, z, rm, sum, vt, NJ * 8 * half);
    }
    store_sums<DH>(part + half * ROWS_S * DH, r0, o);
    __syncthreads();
    TB_TRACE(1, 6);  // the weights and the weighted sum
    for (int i = threadIdx.x; i < ROWS_S * DH; i += NT) part[i] += part[ROWS_S * DH + i];
    cluster_sync();
    TB_TRACE(1, 7);  // the halves' sums
    for (int i = rb * DH + threadIdx.x; i < re * DH; i += NT) {
        const int r = i / DH, d = i % DH;
        float v[MAX_CLUSTER];
        gather(v, part, i, CL);
        float s = v[0];
        for (int k = 1; k < CL; ++k) s += v[k];
        store_out<true>(a, ((long long)b * S + r) * a.D + h * DH + d, gmax[r] == -INFINITY ? 0.f : s);
    }
    cluster_sync();  // no rank leaves while another reads its shared memory
    TB_TRACE(1, 8);  // the ranks' partials added, the output
}

// ---- the path choice and the launch

// Path S where every row of a head fits one block (S <= ROWS_S), T fits a
// cluster's slices, and path L's grid would be small (fewer than
// LARGE_GRID blocks: the rollout's as2pl at B = 8 gives 64, at B = 48 384);
// else path L.
inline bool takes_cluster(const Args& a) {
    const long long row_blocks = (long long)((a.S + ROWS_L - 1) / ROWS_L) * a.H * a.B;
    return a.S <= ROWS_S && (a.T + TK - 1) / TK <= MAX_CLUSTER && row_blocks < LARGE_GRID;
}

using Kernel = void (*)(const Args);

// `kernel` on path S's grid, a cluster of T / TK ranks per (head, scene),
// with `smem` bytes of dynamic shared memory a block.
inline cudaError_t launch_cluster(Kernel kernel, size_t smem, const Args& a, cudaStream_t st) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int cl = (a.T + TK - 1) / TK;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cl, a.H, a.B);
    cfg.blockDim = dim3(THREADS_S);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// `kernel` on path L's grid, blocks_x blocks per (head, scene).
inline cudaError_t launch_rows(Kernel kernel, size_t smem, int blocks_x, const Args& a, cudaStream_t st) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(blocks_x, a.H, a.B);
    kernel<<<grid, THREADS_L, smem, st>>>(a);
    return cudaGetLastError();
}

// The card's SM count.
inline cudaError_t sm_count(int& n_sm) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    return err == cudaSuccess ? cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) : err;
}

// Path S, else path L where its block's logits fit shared memory, else
// path G on a 1-D grid of ws_slots blocks (the caller's workspace must hold
// a slot for each: cudaErrorInvalidValue if it does not).
template <int DH, class KV, bool DROP, bool STATS>
cudaError_t launch(const Args& a, cudaStream_t st) {
    if (takes_cluster(a)) return launch_cluster(fwd_cluster<DH, KV, DROP, STATS>, cluster_smem<DH, KV>(), a, st);
    if (rows_smem<DH, KV>(a.T) <= (size_t)SMEM_OPTIN)
        return launch_rows(fwd_rows<DH, KV, DROP, STATS, false>, rows_smem<DH, KV>(a.T), (a.S + ROWS_L - 1) / ROWS_L, a,
                           st);
    int n_sm = 0;
    cudaError_t err = sm_count(n_sm);
    if (err != cudaSuccess) return err;
    const long long slots = ws_slots(a, n_sm);
    if (a.ws == nullptr || a.ws_floats < slots * ROWS_L * rows_ldl(a.T)) return cudaErrorInvalidValue;
    const size_t smem = rows_ws_smem<DH, KV>(a.T);
    err = cudaFuncSetAttribute(fwd_rows<DH, KV, DROP, STATS, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fwd_rows<DH, KV, DROP, STATS, true><<<dim3((unsigned)slots), THREADS_L, smem, st>>>(a);
    return cudaGetLastError();
}

// K1-bf16's path choice: path S as fp32 K1 takes it, but path L where path
// L's blocks fill the card's n_sm SMs (the joint futures' as2pl at B = 48:
// 0.0482 against path S's 0.0617 ms on an H100; at B = 8 path S's sums keep
// the bf16 validation replay within its hold, PERF.md).
inline bool takes_cluster_bf16(const Args& a, int n_sm) {
    return takes_cluster(a) && (long long)((a.S + ROWS_L - 1) / ROWS_L) * a.H * a.B < n_sm;
}

// K1-bf16: bf16 q, k, v and output, the products on the tensor cores; past
// NKW key tiles, fwd_rows_mma_long.
template <int DH>
cudaError_t launch_bf16(const Args& a, cudaStream_t st) {
    if ((a.T + TK - 1) / TK > NKW)
        return launch_rows(fwd_rows_mma_long<DH>, rows_mma_long_smem<DH>(a.T), (a.S + ROWS_L - 1) / ROWS_L, a, st);
    int n_sm = 0;
    cudaError_t err = sm_count(n_sm);
    if (err != cudaSuccess) return err;
    if (takes_cluster_bf16(a, n_sm)) return launch_cluster(fwd_cluster_mma<DH>, cluster_mma_smem<DH>(), a, st);
    if constexpr (DH > CS)
        return launch_rows(fwd_rows_mma_slab<DH>, rows_mma_slab_smem<DH>(a.T), (a.S + ROWS_L - 1) / ROWS_L, a, st);
    else
        return launch_rows(fwd_rows_mma<DH>, rows_mma_smem<DH>(a.T), rows_mma_blocks<DH>(a, n_sm), a, st);
}

// q, k and v 16-byte aligned (each head's row slice then is too: D and dh
// are multiples of 16 elements): their tiles load with cp.async.
inline int aligned16(const void* q, const void* k, const void* v) {
    return ((uintptr_t)q % 16 == 0) && ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0);
}

}  // namespace tb_attn

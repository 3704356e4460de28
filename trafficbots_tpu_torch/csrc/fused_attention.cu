// K1: the masked multi-head attention core for Hopper (sm_90a), plain C
// interface.
//
// Replaces: trafficbots_tpu/ops/fused_attention.py, fused_attention_core ->
// _attn_kernel (the Pallas TPU kernel). Same function:
//   out[b, s, h*dh:(h+1)*dh] = softmax_t(q_h . k_h / sqrt(dh), masked) . v_h
// with invalid[b, s, t] != 0 = disallowed target. A row whose targets are all
// disallowed comes out exactly 0 (the reference lifts the mask on such rows
// and zeroes their output; the result is the same zeros). With src_invalid
// (the dead-query-row skip, fused_attention_core(..., row_block >= 0) with
// its `_skip`), a query row marked dead there comes out 0 as well; a block
// or cluster of dead rows only writes its zeros (attn_fwd.cuh).
//
// Precision: q, the logits, the softmax and the accumulation are fp32. K/V
// may be stored in bf16 (the eval map K/V cache): they are widened to fp32
// as they are loaded and used in fp32 from there on. This matches the JAX
// package's XLA path and the port's plain version (attention_core_plain),
// not the TPU kernel path, which also rounds q and the weights to bf16.
// tb_fused_attention_bf16 (K1-bf16) is that TPU kernel path, for bf16 q, k
// and v (the model under precision="bf16"): the weights rounded to bf16,
// the output bf16, the products on the tensor cores (bf16 mma.sync with
// fp32 accumulation: fwd_rows_mma / fwd_cluster_mma in attn_fwd.cuh).
//
// The kernel is the shared forward of csrc/attn_fwd.cuh without dropout and
// without row statistics; that header says what bounds it on the card (fp32
// operations) and what its two paths do about it: a thread-block cluster
// over T at the rollout's as2pl (S = 64, T = 1024, bf16 K/V), 32-row blocks
// with register micro-tiles at the map self-attention and the latent as2pl,
// and those blocks with their logits in a global workspace past the T whose
// logits fit shared memory (path G: data.n_pl = 2048 and beyond).
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6), on
// the device: 0.0263 ms at the rollout as2pl, B = 8 (the first design
// 0.0578 in the same run), 0.111 at the joint futures' B = 48 (0.193),
// 0.227 and 0.283 at the map self-attention and the latent as2pl (0.472,
// 0.561; SDPA's forward 0.369, 0.392).

#include "attn_fwd.cuh"

namespace {

template <class KV>
cudaError_t launch_dh(const tb_attn::Args& a, cudaStream_t st) {
    switch (a.D / a.H) {
        case 16: return tb_attn::launch<16, KV, false, false>(a, st);
        case 32: return tb_attn::launch<32, KV, false, false>(a, st);
        case 64: return tb_attn::launch<64, KV, false, false>(a, st);
        case 128: return tb_attn::launch<128, KV, false, false>(a, st);
        default: return cudaErrorInvalidValue;
    }
}

cudaError_t launch_dh_bf16(const tb_attn::Args& a, cudaStream_t st) {
    switch (a.D / a.H) {
        case 16: return tb_attn::launch_bf16<16>(a, st);
        case 32: return tb_attn::launch_bf16<32>(a, st);
        case 64: return tb_attn::launch_bf16<64>(a, st);
        case 128: return tb_attn::launch_bf16<128>(a, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B,S,D] fp32, k/v [B,T,D] fp32 (kv_bf16 = 0) or bf16 (kv_bf16 = 1),
// invalid addressed as inv[b * inv_sb + s * inv_ss + t] (bool bytes),
// src_invalid [B,S] contiguous bool bytes (dead query rows) or null,
// out [B,S,D] fp32; ws: ws_floats fp32 of workspace for path G's logits
// (ops/fused_attention.py workspace_floats; null where no T needs it).
// Returns the cudaError_t of the launch.
extern "C" int tb_fused_attention(const void* q, const void* k, const void* v, const void* invalid,
                                  const void* src_invalid, void* out, int B, int S, int T, int D, int n_head,
                                  int kv_bf16, long long inv_sb, long long inv_ss, void* ws, long long ws_floats,
                                  void* stream) {
    tb_attn::Args a{static_cast<const float*>(q), k, v, static_cast<const uint8_t*>(invalid),
                    static_cast<float*>(out), nullptr, nullptr, B, S, T, D, n_head, inv_sb, inv_ss,
                    tb_philox::Dropout{0ull, 0u, 1.f, 0}, 0u, tb_attn::aligned16(q, k, v),
                    static_cast<const uint8_t*>(src_invalid), static_cast<float*>(ws), ws_floats};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(kv_bf16 ? launch_dh<__nv_bfloat16>(a, st) : launch_dh<float>(a, st));
}

// K1's bf16 variant: q, k, v [B,S,D] / [B,T,D] bf16, out [B,S,D] bf16 (the
// Pallas _attn_kernel on bf16 operands: fp32 logits and softmax, weights
// rounded to bf16, fp32 weighted sum, the output rounded once; the products
// as bf16 MMAs with fp32 accumulation, attn_fwd.cuh). The other arguments as
// tb_fused_attention's.
extern "C" int tb_fused_attention_bf16(const void* q, const void* k, const void* v, const void* invalid,
                                       const void* src_invalid, void* out, int B, int S, int T, int D, int n_head,
                                       long long inv_sb, long long inv_ss, void* stream) {
    tb_attn::Args a{static_cast<const float*>(q), k, v, static_cast<const uint8_t*>(invalid),
                    static_cast<float*>(out), nullptr, nullptr, B, S, T, D, n_head, inv_sb, inv_ss,
                    tb_philox::Dropout{0ull, 0u, 1.f, 0}, 0u, tb_attn::aligned16(q, k, v),
                    static_cast<const uint8_t*>(src_invalid)};
    return (int)launch_dh_bf16(a, static_cast<cudaStream_t>(stream));
}

#ifdef TB_ATTN_TRACE
// The phase trace's counters (ops/attn_fwd_trace.py): read into h[32], or zeroed.
extern "C" int tb_attn_trace_read(unsigned long long* h) {
    return (int)cudaMemcpyFromSymbol(h, tb_attn_trace, sizeof(tb_attn_trace));
}
extern "C" int tb_attn_trace_zero() {
    const unsigned long long z[32] = {};
    return (int)cudaMemcpyToSymbol(tb_attn_trace, z, sizeof(z));
}
#endif

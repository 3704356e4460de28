// The node kernels' phase trace, in a build with -DTB_NODE_TRACE only
// (ops/node_trace.py). Thread 0 of a block adds the clock64 cycles since its
// last mark to tb_node_trace[kernel][phase]; slot 15 counts work items (a
// block, or one item of a block that walks several). A phase's cycles are
// thread 0's and include its waits at barriers. Each source names its
// kernels' phases with TB_NODE_PHASES("id name: phase|phase|...;...").
#pragma once

#ifdef TB_NODE_TRACE
__device__ unsigned long long tb_node_trace[4][16];
#define TB_NODE_BEGIN(K)                         \
    unsigned long long tb_nt_ = clock64();       \
    if (threadIdx.x == 0) atomicAdd(&tb_node_trace[K][15], 1ull)
#define TB_NODE_MARK(K, P)                                        \
    if (threadIdx.x == 0) {                                       \
        const unsigned long long now_ = clock64();                \
        atomicAdd(&tb_node_trace[K][P], now_ - tb_nt_);           \
        tb_nt_ = now_;                                            \
    }
// a device function that marks phases of its caller's kernel: its own clock
// from here; the caller takes its clock anew after the call
#define TB_NODE_RESUME() unsigned long long tb_nt_ = clock64()
#define TB_NODE_RESTART() tb_nt_ = clock64()
#define TB_NODE_PHASES(S) \
    extern "C" const char* tb_node_trace_phases() { return S; }
extern "C" int tb_node_trace_read(unsigned long long* h) {
    return (int)cudaMemcpyFromSymbol(h, tb_node_trace, sizeof(tb_node_trace));
}
extern "C" int tb_node_trace_zero() {
    static const unsigned long long z[4][16] = {};
    return (int)cudaMemcpyToSymbol(tb_node_trace, z, sizeof(z));
}
#else
#define TB_NODE_BEGIN(K)
#define TB_NODE_MARK(K, P)
#define TB_NODE_RESUME()
#define TB_NODE_RESTART()
#define TB_NODE_PHASES(S)
#endif

// A CPU stand-in for the part of the CUDA runtime that the port's kernels
// use, so that their sources compile with g++ and run on the host
// (tests/test_torch_cuda_emu.py, tests/test_torch_cuda_emu_node.py). Every
// thread of a block is a fiber (a ucontext with a stack of its own) on the
// launching thread, run until it waits at a barrier and then switched for
// the next one in turn, so that a launch takes one core and no system
// thread is made or woken per CUDA thread; a kernel's static __shared__
// variables are statics (which the blocks of a launch share one after
// another; no kernel run in a cluster has any), __syncthreads is a barrier
// over the block's fibers (__syncwarp one over a warp's), and the dynamic
// shared memory is filled with NaN before each block, so a read of a word
// the block did not write shows. The blocks of a launch run one after another, except that the
// blocks of one thread-block cluster run at once (cudaLaunchKernelEx with a
// cluster dimension): cluster_sync is a barrier over all of their threads
// and cluster_map points into another block's shared memory. Warp shuffles
// (and ballots) exchange through a per-warp slot array between two warp
// barriers; a warp's mma.sync (csrc/mma.cuh) exchanges its fragments
// through per-lane slots (two sets, used in turn) behind one warp barrier,
// each lane summing its four outputs in fp32 over k in order;
// shared-memory integer atomics are std::atomic_ref; the cp.async copies
// are synchronous (their commits and waits do nothing); clock64 is the
// host's steady clock.
// TB_CUDA_EMU tells a source that these plain bodies stand in for its
// Hopper primitives.
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
#include <memory>
#include <stdint.h>
#include <ucontext.h>
#include <vector>

#include "cuda_bf16.h"
using std::max;
using std::min;

#define TB_CUDA_EMU 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static  // one per block: the blocks of a launch run one after another
#define __restrict__ __restrict

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_idx { unsigned x, y, z; };
inline thread_local emu_idx threadIdx, blockIdx;
inline thread_local dim3 gridDim, blockDim;

struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return uint4{a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return uint2{a, b}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) { return bytes > 232448 ? 1 : 0; }
// a card of EMU_SMS SMs, one block an SM: a persistent grid walks its work
// in several passes
constexpr int EMU_SMS = 2;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = EMU_SMS; return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }

template <class T> inline T __ldg(const T* p) { return *p; }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }  // the card's is within 2 ulp of this
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {  // byte i: byte s[4i..4i+2] of y:x
    const uint64_t v = (uint64_t)y << 32 | x;
    unsigned r = 0;
    for (int i = 0; i < 4; ++i) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7u))) & 0xffu) << (8 * i);
    return r;
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __uint_as_float(unsigned u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

constexpr size_t EMU_SMEM = 232448 / 4;  // floats of one block's shared memory
constexpr int EMU_MAX_CLUSTER = 8;
constexpr int EMU_MAX_THREADS = 1024;

// One lane's mma.sync fragments (csrc/mma.cuh): A, B and the accumulator.
struct EmuMmaSlot {
    uint32_t a[4], b[2];
    float c[4];
};

inline void emu_yield();

// A barrier over n fibers: each waits, switching to the others, until the
// n-th arrives.
struct EmuBarrier {
    int n, count = 0;
    unsigned gen = 0;
    explicit EmuBarrier(int n_) : n(n_) {}
    void arrive_and_wait() {
        const unsigned g = gen;
        if (++count == n) {
            count = 0;
            ++gen;
            return;
        }
        while (gen == g) emu_yield();
    }
};

// One block's state: its barrier, its warps' barriers, shuffle and mma
// slots, its __syncthreads_or words, its shared memory.
struct EmuBlock {
    std::unique_ptr<EmuBarrier> bar;
    std::vector<std::unique_ptr<EmuBarrier>> warp_bar;
    float shfl[EMU_MAX_THREADS];
    EmuMmaSlot mma[2][EMU_MAX_THREADS];  // used in turn by a warp's calls
    std::atomic<int> vote[3];
    std::vector<float> smem = std::vector<float>(EMU_SMEM + 4);
    float* base() { return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem.data()) + 15) & ~uintptr_t(15)); }
};
inline EmuBlock* emu_blocks;              // the cluster's blocks, by rank
inline EmuBarrier* emu_cluster_bar;       // all threads of the cluster
// the running fiber's CUDA thread (saved and restored at each switch)
inline thread_local EmuBlock* emu_blk;
inline thread_local unsigned emu_rank, emu_vote_n, emu_mma_n;
inline thread_local float* emu_smem;      // this block's dynamic shared memory
struct EmuThreadState {
    emu_idx tid, bid;
    dim3 grid, block;
    EmuBlock* blk;
    unsigned rank, vote_n, mma_n;
    float* smem;
};
inline EmuThreadState emu_save() {
    return {threadIdx, blockIdx, gridDim, blockDim, emu_blk, emu_rank, emu_vote_n, emu_mma_n, emu_smem};
}
inline void emu_load(const EmuThreadState& s) {
    threadIdx = s.tid, blockIdx = s.bid, gridDim = s.grid, blockDim = s.block;
    emu_blk = s.blk, emu_rank = s.rank, emu_vote_n = s.vote_n, emu_mma_n = s.mma_n, emu_smem = s.smem;
}

// The fibers of a launch, run round robin from the launching thread.
struct EmuFiber {
    ucontext_t ctx;
    EmuThreadState st;
    bool done = false;
};
constexpr size_t EMU_STACK = 256 * 1024;  // bytes of a fiber's stack
inline thread_local std::vector<EmuFiber>* emu_fibers;
inline thread_local int emu_cur, emu_live;
inline thread_local ucontext_t emu_main;
inline thread_local const std::function<void()>* emu_fiber_body;

// From the running fiber to the next one that is not done (from the last
// one to finish back to the launch).
inline void emu_switch(bool finished) {
    std::vector<EmuFiber>& f = *emu_fibers;
    const int me = emu_cur;
    if (finished) {
        f[me].done = true;
        if (--emu_live == 0) setcontext(&emu_main);
    } else {
        f[me].st = emu_save();
    }
    int next = me;
    do next = (next + 1) % (int)f.size(); while (f[next].done);
    if (next == me) return;
    emu_cur = next;
    emu_load(f[next].st);
    if (finished)
        setcontext(&f[next].ctx);
    else
        swapcontext(&f[me].ctx, &f[next].ctx);
}
inline void emu_yield() { emu_switch(false); }
inline void emu_fiber_main() {
    (*emu_fiber_body)();
    emu_switch(true);
}

inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp() { emu_blk->warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
    const unsigned n = emu_vote_n++;
    if (threadIdx.x == 0) emu_blk->vote[(n + 1) % 3].store(0);
    if (p) emu_blk->vote[n % 3].fetch_or(1);
    emu_blk->bar->arrive_and_wait();
    return emu_blk->vote[n % 3].load();
}
inline int atomicOr(int* p, int v) { return std::atomic_ref<int>(*p).fetch_or(v); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
    EmuBlock& b = *emu_blk;
    const unsigned t = threadIdx.x;
    b.shfl[t] = v;
    b.warp_bar[t / 32]->arrive_and_wait();
    const float r = b.shfl[t ^ (unsigned)o];
    b.warp_bar[t / 32]->arrive_and_wait();
    return r;
}
inline int __shfl_xor_sync(unsigned m, int v, int o) {
    float f;
    std::memcpy(&f, &v, 4);
    f = __shfl_xor_sync(m, f, o);
    std::memcpy(&v, &f, 4);
    return v;
}

inline unsigned __ballot_sync(unsigned, int p) {
    EmuBlock& b = *emu_blk;
    const unsigned t = threadIdx.x, w0 = t / 32 * 32;
    b.shfl[t] = p ? 1.f : 0.f;
    b.warp_bar[t / 32]->arrive_and_wait();
    unsigned bits = 0;
    for (unsigned i = 0; i < 32 && w0 + i < blockDim.x; ++i) bits |= (b.shfl[w0 + i] != 0.f ? 1u : 0u) << i;
    b.warp_bar[t / 32]->arrive_and_wait();
    return bits;
}

// The primitives of csrc/mma.cuh. c += a b for the warp's 16 x 16 A and
// 16 x 8 B (bf16, two a register, the lower index in the lower half) in
// the PTX ISA's m16n8k16 fragments: lane (g, t) = (lane / 4, lane % 4)
// holds A at rows g, g + 8, columns 2t, 2t + 1 (+ 8), B at k rows 2t,
// 2t + 1 (+ 8) of column g, C at rows g, g + 8, columns 2t, 2t + 1. A
// warp's lanes make the same calls, so they agree on the slot set of each
// (its count's parity); a lane writes a set again only after the next
// call's barrier, which every lane passes once it has read this call's.
inline float emu_bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
inline float emu_bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
inline void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    EmuBlock& blk = *emu_blk;
    const unsigned t = threadIdx.x, w0 = t / 32 * 32, lane = t % 32;
    EmuMmaSlot* set = blk.mma[emu_mma_n++ & 1];
    EmuMmaSlot& mine = set[t];
    std::memcpy(mine.a, a, sizeof(mine.a));
    std::memcpy(mine.b, b, sizeof(mine.b));
    std::memcpy(mine.c, c, sizeof(mine.c));
    blk.warp_bar[t / 32]->arrive_and_wait();
    auto A = [&](int r, int k) {  // the lane and register that hold A[r][k]
        const EmuMmaSlot& s = set[w0 + (r % 8) * 4 + (k % 8) / 2];
        const uint32_t u = s.a[(r >= 8) + 2 * (k >= 8)];
        return k % 2 ? emu_bf16_hi(u) : emu_bf16_lo(u);
    };
    auto B = [&](int k, int n) {
        const uint32_t u = set[w0 + n * 4 + (k % 8) / 2].b[k >= 8];
        return k % 2 ? emu_bf16_hi(u) : emu_bf16_lo(u);
    };
    float d[4];
    for (int i = 0; i < 4; ++i) {
        const int r = (int)lane / 4 + 8 * (i >= 2), n = 2 * ((int)lane % 4) + i % 2;
        float s = mine.c[i];
        for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);  // each product exact in fp32
        d[i] = s;
    }
    std::memcpy(c, d, sizeof(d));
}
// m16n8k8: A 16 x 8 (lane (g, t): a[0] row g, columns 2t, 2t + 1; a[1]
// row g + 8), B 8 x 8 (b[0] k rows 2t, 2t + 1 of column g), C as above.
inline void mma_bf16_1688(float (&c)[4], const uint32_t (&a)[2], const uint32_t (&b)[1]) {
    EmuBlock& blk = *emu_blk;
    const unsigned t = threadIdx.x, w0 = t / 32 * 32, lane = t % 32;
    EmuMmaSlot* set = blk.mma[emu_mma_n++ & 1];
    EmuMmaSlot& mine = set[t];
    std::memcpy(mine.a, a, sizeof(a));
    mine.b[0] = b[0];
    std::memcpy(mine.c, c, sizeof(mine.c));
    blk.warp_bar[t / 32]->arrive_and_wait();
    auto A = [&](int r, int k) {
        const uint32_t u = set[w0 + (r % 8) * 4 + k / 2].a[r >= 8];
        return k % 2 ? emu_bf16_hi(u) : emu_bf16_lo(u);
    };
    auto B = [&](int k, int n) {
        const uint32_t u = set[w0 + n * 4 + k / 2].b[0];
        return k % 2 ? emu_bf16_hi(u) : emu_bf16_lo(u);
    };
    float d[4];
    for (int i = 0; i < 4; ++i) {
        const int r = (int)lane / 4 + 8 * (i >= 2), n = 2 * ((int)lane % 4) + i % 2;
        float s = mine.c[i];
        for (int k = 0; k < 8; ++k) s += A(r, k) * B(k, n);
        d[i] = s;
    }
    std::memcpy(c, d, sizeof(d));
}
inline uint32_t pack_bf16(float lo, float hi) {
    return (uint32_t)__float2bfloat16_rn(lo).x | (uint32_t)__float2bfloat16_rn(hi).x << 16;
}

// The phase traces' clock and counters (csrc/node_trace.cuh).
inline long long clock64() { return std::chrono::steady_clock::now().time_since_epoch().count(); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
    return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
template <class T> cudaError_t cudaMemcpyToSymbol(T& sym, const void* src, size_t n) {
    std::memcpy(&sym, src, n);
    return 0;
}
template <class T> cudaError_t cudaMemcpyFromSymbol(void* dst, const T& sym, size_t n) {
    std::memcpy(dst, &sym, n);
    return 0;
}

// The Hopper primitives of csrc/attn_fwd.cuh.
inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async8(void* dst, const void* src) { std::memcpy(dst, src, 8); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline unsigned cluster_rank() { return emu_rank; }
inline void cluster_sync() { emu_cluster_bar->arrive_and_wait(); }
template <class T> T* cluster_map(T* p, unsigned rank) {
    const std::ptrdiff_t off = reinterpret_cast<char*>(p) - reinterpret_cast<char*>(emu_smem);
    return reinterpret_cast<T*>(reinterpret_cast<char*>(emu_blocks[rank].base()) + off);
}

// Runs body for every block of grid, `cluster` consecutive blocks along x
// at once (one fiber per CUDA thread of each).
inline void emu_launch(dim3 grid, int nthr, const std::function<void()>& body, unsigned cluster = 1) {
    if (cluster < 1 || cluster > EMU_MAX_CLUSTER || grid.x % cluster || nthr > EMU_MAX_THREADS) std::abort();
    std::vector<EmuBlock> blocks(cluster);
    for (auto& b : blocks) {
        b.bar = std::make_unique<EmuBarrier>(nthr);
        for (int w = 0; w * 32 < nthr; ++w) b.warp_bar.push_back(std::make_unique<EmuBarrier>(min(32, nthr - 32 * w)));
        for (auto& v : b.vote) v.store(0);
    }
    EmuBarrier cbar(nthr * (int)cluster);
    emu_blocks = blocks.data();
    emu_cluster_bar = &cbar;
    const std::function<void()> run = [&] {  // one CUDA thread: every block of its rank
        const unsigned t = threadIdx.x;
        for (unsigned z = 0; z < grid.z; ++z)
            for (unsigned y = 0; y < grid.y; ++y)
                for (unsigned x0 = 0; x0 < grid.x; x0 += cluster) {
                    blockIdx = {x0 + emu_rank, y, z};
                    if (t == 0) std::fill(emu_smem, emu_smem + EMU_SMEM, NAN);
                    cbar.arrive_and_wait();
                    body();
                    cbar.arrive_and_wait();
                }
    };
    const int n = nthr * (int)cluster;
    static thread_local std::vector<std::unique_ptr<char[]>> stacks;  // reused by later launches
    while ((int)stacks.size() < n) stacks.emplace_back(new char[EMU_STACK]);
    std::vector<EmuFiber> fibers(n);
    for (int i = 0; i < n; ++i) {
        const unsigned c = i / nthr;
        fibers[i].st = {{(unsigned)(i % nthr), 0, 0}, {0, 0, 0}, grid, dim3(nthr), &blocks[c], c, 0, 0,
                        blocks[c].base()};
        getcontext(&fibers[i].ctx);
        fibers[i].ctx.uc_stack.ss_sp = stacks[i].get();
        fibers[i].ctx.uc_stack.ss_size = EMU_STACK;
        fibers[i].ctx.uc_link = nullptr;
        makecontext(&fibers[i].ctx, emu_fiber_main, 0);
    }
    emu_fibers = &fibers;
    emu_fiber_body = &run;
    emu_live = n;
    emu_cur = 0;
    emu_load(fibers[0].st);
    swapcontext(&emu_main, &fibers[0].ctx);  // back when every fiber is done
}

// cudaLaunchKernelEx with a cluster dimension along x (the only attribute read).
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttribute {
    cudaLaunchAttributeID id;
    struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...), Act&&... args) {
    unsigned cluster = 1;
    for (unsigned i = 0; i < cfg->numAttrs; ++i)
        if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) cluster = cfg->attrs[i].val.clusterDim.x;
    emu_launch(cfg->gridDim, (int)cfg->blockDim.x, [&] { kernel(args...); }, cluster);
    return cudaSuccess;
}

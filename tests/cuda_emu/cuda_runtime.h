// A CPU stand-in for the part of the CUDA runtime that the port's kernels
// use, so that their sources compile with g++ and run on the host
// (tests/test_torch_cuda_emu.py). Every thread of a block is a std::thread,
// the blocks of a launch run one after another, __syncthreads is a
// std::barrier, and the dynamic shared memory is filled with NaN before
// each block, so a read of a word the block did not write shows. Warp
// shuffles are not emulated (a kernel that uses them aborts).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
#include <stdint.h>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __restrict__ __restrict

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_idx { unsigned x, y, z; };
inline thread_local emu_idx threadIdx, blockIdx;
inline thread_local dim3 gridDim, blockDim;

struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) { return bytes > 232448 ? 1 : 0; }
inline cudaError_t cudaGetLastError() { return 0; }

inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __shfl_xor_sync(unsigned, float v, int) { std::abort(); return v; }

constexpr size_t EMU_SMEM = 232448 / 4;
alignas(16) inline float emu_smem[EMU_SMEM];
inline std::barrier<>* emu_bar;
inline std::atomic<int> emu_or[3];
inline thread_local unsigned emu_or_n;

inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
    const unsigned n = emu_or_n++;
    if (threadIdx.x == 0) emu_or[(n + 1) % 3].store(0);
    if (p) emu_or[n % 3].fetch_or(1);
    emu_bar->arrive_and_wait();
    return emu_or[n % 3].load();
}

inline void emu_launch(dim3 grid, int nthr, const std::function<void()>& body) {
    std::barrier<> bar(nthr);
    emu_bar = &bar;
    for (auto& o : emu_or) o.store(0);
    std::vector<std::thread> ts;
    for (int t = 0; t < nthr; ++t)
        ts.emplace_back([&, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockDim = dim3(nthr);
            gridDim = grid;
            emu_or_n = 0;
            for (unsigned z = 0; z < grid.z; ++z)
                for (unsigned y = 0; y < grid.y; ++y)
                    for (unsigned x = 0; x < grid.x; ++x) {
                        blockIdx = {x, y, z};
                        if (t == 0) { std::fill(emu_smem, emu_smem + EMU_SMEM, NAN); }
                        bar.arrive_and_wait();
                        body();
                        bar.arrive_and_wait();
                    }
        });
    for (auto& th : ts) th.join();
}

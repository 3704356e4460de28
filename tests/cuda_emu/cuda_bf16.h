// The part of cuda_bf16.h that the port's kernels use, for the CPU
// emulator (cuda_runtime.h): bf16 as its 16 bits, widened exactly, and
// rounded from fp32 to nearest even.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
    uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 b) {
    const uint32_t u = (uint32_t)b.x << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    uint32_t u;
    std::memcpy(&u, &f, 4);
    __nv_bfloat16 b;
    if ((u & 0x7fffffffu) > 0x7f800000u) {  // NaN stays a (quiet) NaN
        b.x = (uint16_t)((u >> 16) | 0x40u);
    } else {  // to nearest, ties to even
        b.x = (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
    }
    return b;
}

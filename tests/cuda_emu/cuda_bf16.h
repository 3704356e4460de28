// The part of cuda_bf16.h that the port's kernels use, for the CPU
// emulator (cuda_runtime.h): bf16 as its 16 bits, widened exactly.
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

// Counter-based Philox4x32-10 for the port's dropout, shared by every
// kernel with a dropout site (attention_train.cu, node_encoder_train.cu,
// dropout.cu) and mirrored bit for bit by ops/dropout.py's plain version.
//
// Replaces the TPU's per-(seed, site) re-seeded hardware PRNG of
// trafficbots_tpu/ops/kernel_common.py `dropout_mask`. The mask of an element
// depends only on (seed, site, the element's coordinates in the logical
// tensor), never on a kernel's blocking:
//   key     = the 64-bit seed (k0 = low word, k1 = high word)
//   counter = (col / 4, site, row low word, row high word)
// where `row` is the flat index of the element's leading coordinates and
// `col` its last coordinate; word col % 4 of the output is the element's
// bits. Keep iff bits >= threshold (= min(p * 2^32, 2^32 - 1)), kept
// elements scale by 1 / (1 - p): inverted dropout, as the TPU kernels draw.

#pragma once

#include <stdint.h>

namespace tb_philox {

struct U4 {
    uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r > 0) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
        const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
        c0 = n0;
        c1 = lo1;
        c2 = n2;
        c3 = lo0;
    }
    return U4{c0, c1, c2, c3};
}

// The four bits words of elements col4 * 4 .. col4 * 4 + 3 of `row`.
__device__ __forceinline__ U4 bits4(unsigned long long seed, uint32_t site, unsigned long long row,
                                    uint32_t col4) {
    return philox4x32_10(col4, site, (uint32_t)row, (uint32_t)(row >> 32), (uint32_t)seed,
                         (uint32_t)(seed >> 32));
}

// Dropout parameters as the kernels take them: the keep threshold on the
// 32-bit draw and the scale of a kept element (computed on the host, so the
// plain version and every kernel use the same float).
struct Dropout {
    unsigned long long seed;
    uint32_t threshold;
    float scale;
    int on;  // p > 0
};

__device__ __forceinline__ float keep(const Dropout& d, uint32_t bits) {
    return bits >= d.threshold ? d.scale : 0.f;
}

// The inverted-dropout factors (0 or scale) of elements col4*4 .. col4*4+3.
__device__ __forceinline__ void factors4(const Dropout& d, uint32_t site, unsigned long long row,
                                         uint32_t col4, float (&f)[4]) {
    if (!d.on) {
        f[0] = f[1] = f[2] = f[3] = 1.f;
        return;
    }
    const U4 b = bits4(d.seed, site, row, col4);
    f[0] = keep(d, b.x);
    f[1] = keep(d, b.y);
    f[2] = keep(d, b.z);
    f[3] = keep(d, b.w);
}

}  // namespace tb_philox

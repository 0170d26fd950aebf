// The warp butterfly that K2's redesigned instances (gen_grad_narrow.cuh,
// gen_grad_pol_wide.cuh) sum their per-ray parameter cotangents with.
#pragma once

#include <cuda_runtime.h>

// The warp's sums of NV values (NV a power of 2 up to 32) by a butterfly:
// at each of log2(NV) steps a lane keeps half of its values and adds its
// partner's half, then the last steps add the one value left. Lane l ends
// with the sum of value l / (32 / NV) over the 32 lanes, in a fixed order.
template <int NV>
__device__ __forceinline__ float warp_scatter_sum(float (&v)[NV], int lane) {
#pragma unroll
    for (int h = NV / 2, off = 16; h >= 1; h /= 2, off /= 2) {
        const bool hi = (lane & off) != 0;
#pragma unroll
        for (int j = 0; j < h; ++j) {
            const float send = hi ? v[j] : v[j + h];
            const float keep = hi ? v[j + h] : v[j];
            v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
    }
    float r = v[0];
#pragma unroll
    for (int off = 16 / NV; off >= 1; off /= 2)
        r += __shfl_xor_sync(0xffffffffu, r, off);
    return r;
}

// Device helpers shared by the port's kernel sources: compile-time
// unrolling over register arrays and the warp's 32 x 32 bit transpose.
// Each source that uses them includes this header; ``_build.py`` hashes it
// with the source, so an edit here rebuilds every library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// A compile-time index that converts to int on the device.
template <int I>
struct Index {
    static constexpr int value = I;
    __host__ __device__ constexpr operator int() const { return I; }
};

// f(0), f(1), ..., f(N - 1) as N statements, each index a compile-time
// constant: arrays indexed by it stay in registers however large f is.
template <int N, int I = 0, class F>
__device__ __forceinline__ void unrolled(F&& f)
{
    if constexpr (I < N) {
        f(Index<I>{});
        unrolled<N, I + 1>(f);
    }
}

// The 32 x 32 bit transpose across a warp: lane l holds row l on entry and
// column l on exit (bit i of lane l's word goes to bit l of lane i's). Step
// s swaps the lane-index bit s with the bit-index bit s: a lane keeps the
// half of its bits whose index bit s equals its lane bit s and takes the
// other half from its partner, rotated by s (the bits a rotation wraps land
// in the kept half): a shuffle, a funnel shift and one LOP3 a step.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lid)
{
    const uint32_t lo[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u, 0x55555555u};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const int s = 16 >> k;
        const bool up = lid & s;
        const uint32_t keep = up ? ~lo[k] : lo[k];
        const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
        const uint32_t t = __funnelshift_l(y, y, up ? 32 - s : s);  // rotate left
        x = (x & keep) | (t & ~keep);
    }
    return x;
}

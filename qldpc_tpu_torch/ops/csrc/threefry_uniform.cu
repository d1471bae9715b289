// The Monte-Carlo sampler's counter stream: threefry2x32 uniforms (K8).
//
// Replaces no Pallas kernel: the JAX package's
// qldpc_tpu/utils/rng.py:counter_uniform is XLA code. It computes what
// utils/rng.py:counter_uniform_plain computes, bit for bit: for sample
// g < batch and pair j < P = ceil(stride / 2), the 20-round threefry2x32 of
// the counter pair ((base + g*P + j) mod 2^32, 0) under the key (k0, k1),
// each output word o converted to (o >> 8) * 2^-24 (exact in float32) and
// written to u[g, 2j] and u[g, 2j + 1] of the (batch, stride) float32
// output. Where stride is odd, each sample's last pair drops its second word.
//
// What bounds it on the card: the integer instruction rate. A pair costs
// about 78 32-bit integer operations (the cipher's 72: two key adds, 20
// rounds of an add, a rotate and a XOR, five key injections of two adds; the
// counter's add and the two conversions) and writes 8 bytes, nothing read:
// at the H100's 64 INT32 lanes an SM that is about twice the time the stores
// need at 3.35 TB/s. The plain version carries the words in int64 and masks after
// every add and rotate, about 160 passes over memory a call; here the words
// stay in registers as uint32 (the wrap is the mask), the rotate is one
// funnel shift, the key, base and P come by value, and each uniform is
// written once, in its final layout.
//
// Grid: shaped from (batch, P), so no thread divides by P. A block holds
// bx x gy threads, bx pairs of a sample's row by gy samples (the Python
// launcher's launch_shape: bx = ceil(P / chunks) for chunks = ceil(P / 256),
// gy = 256 / bx); the grid is (ceil(batch / gy), chunks), and a thread steps
// by gridDim.y * bx pairs past 65,535 chunks. Where P <= 256 a block covers
// gy whole rows, gy * P consecutive counters, and its stores are contiguous.
// An even stride stores a float2 a thread (a row starts on an even word);
// an odd stride two words.

#include <cuda_runtime.h>
#include <stdint.h>

#define K8_THREADS 256

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r)
{
    return __funnelshift_l(x, x, r);
}

// (o >> 8) * 2^-24: a 24-bit integer times a power of two, exact
__device__ __forceinline__ float to_unit(uint32_t o)
{
    return __uint2float_rn(o >> 8) * 5.9604644775390625e-08f;
}

#define K8_ROUND(r)          \
    x0 += x1;                \
    x1 = rotl32(x1, r) ^ x0;

// threefry2x32 with 20 rounds: the rotations (13, 15, 26, 6) and
// (17, 29, 16, 24) in turn, a key injection after every four rounds
__device__ __forceinline__ void threefry2x32_20(uint32_t k0, uint32_t k1, uint32_t& x0,
                                                uint32_t& x1)
{
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += k0;
    x1 += k1;
    K8_ROUND(13) K8_ROUND(15) K8_ROUND(26) K8_ROUND(6)
    x0 += k1;
    x1 += k2 + 1u;
    K8_ROUND(17) K8_ROUND(29) K8_ROUND(16) K8_ROUND(24)
    x0 += k2;
    x1 += k0 + 2u;
    K8_ROUND(13) K8_ROUND(15) K8_ROUND(26) K8_ROUND(6)
    x0 += k0;
    x1 += k1 + 3u;
    K8_ROUND(17) K8_ROUND(29) K8_ROUND(16) K8_ROUND(24)
    x0 += k1;
    x1 += k2 + 4u;
    K8_ROUND(13) K8_ROUND(15) K8_ROUND(26) K8_ROUND(6)
    x0 += k2;
    x1 += k0 + 5u;
}

template <bool EVEN>
__global__ void __launch_bounds__(K8_THREADS)
threefry_uniform_kernel(float* __restrict__ out, uint32_t k0, uint32_t k1, uint32_t base,
                        int batch, int P, int stride)
{
    const int g = blockIdx.x * blockDim.y + threadIdx.y;
    if (g >= batch) return;
    const uint32_t row = base + (uint32_t)g * (uint32_t)P;  // mod 2^32
    float* const u = out + (size_t)g * stride;
    for (int j = blockIdx.y * blockDim.x + threadIdx.x; j < P; j += gridDim.y * blockDim.x) {
        uint32_t x0 = row + (uint32_t)j, x1 = 0u;
        threefry2x32_20(k0, k1, x0, x1);
        if (EVEN) {
            reinterpret_cast<float2*>(u)[j] = make_float2(to_unit(x0), to_unit(x1));
        } else {
            u[2 * j] = to_unit(x0);
            if (2 * j + 1 < stride) u[2 * j + 1] = to_unit(x1);
        }
    }
}

// out: (batch, stride) float32; (bx, gy, grid_x, grid_y) from launch_shape.
// Returns the cudaError_t of the launch.
extern "C" int threefry_uniform_launch(void* out, unsigned k0, unsigned k1, unsigned base,
                                       int batch, int stride, int bx, int gy, int grid_x,
                                       int grid_y, void* stream_)
{
    if (bx < 1 || gy < 1 || bx * gy > K8_THREADS || grid_x < 1 || grid_y < 1 || grid_y > 65535
        || batch < 1 || stride < 1)
        return (int)cudaErrorInvalidValue;
    const int P = (stride + 1) / 2;
    cudaStream_t stream = (cudaStream_t)stream_;
    const dim3 grid(grid_x, grid_y), block(bx, gy);
    if (stride % 2 == 0)
        threefry_uniform_kernel<true><<<grid, block, 0, stream>>>(
            (float*)out, k0, k1, base, batch, P, stride);
    else
        threefry_uniform_kernel<false><<<grid, block, 0, stream>>>(
            (float*)out, k0, k1, base, batch, P, stride);
    return (int)cudaGetLastError();
}

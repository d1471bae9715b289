// Layered (check-serial) belief propagation for check-regular graphs (K7).
//
// Replaces qldpc_tpu/ops/bp_pallas.py::_bp_layered_kernel. It computes what
// the XLA layered path (qldpc_tpu/decoders/bp.py::_build_layered) computes,
// so the plain torch version in ops/bp_layered_cuda.py is its exact
// reference: per iteration the checks run in L contiguous layers; in each,
// Q = posterior[v(e)] - R_e (clipped), the check rule of K1 on the layer's
// checks, then every posterior adds its edges' R_new - R_old in ascending
// edge order (the order of the JAX path's scatter-add). The TPU kernel
// gathered and scattered through per-layer one-hot MXU matmuls; here every
// lane gathers from shared memory.
//
// What bounds it on the card: the transcendental work of the check rule and
// the sequential layers, not device memory (a sample's syndrome and priors
// are read once, its posteriors written once). So the design is about how
// samples share the card: one warp decodes one sample at a time, with its R,
// one layer's deltas, its posteriors and its syndrome in the warp's slice of
// shared memory (2.8 KB at [[144,12,12]]). Warps of a persistent grid, sized
// from the SM count and the occupancy, take the next sample from a global
// counter (zeroed on the stream per call), so a sample that converges frees
// its warp at once, no sample waits for another, and every barrier is a
// __syncwarp. Per iteration, for each layer:
//   1. check phase, one lane per check of the layer: Q from the posteriors
//      and R, R_new, the delta R_new - R_old into D, R = R_new;
//   2. variable phase, one lane per variable the layer touches (host tables
//      from var_edge, ops/bp_layered_cuda.py::layer_tables): the posterior
//      plus the deltas of its layer-local edges, ascending.
// Then the lanes test the checks' parities against the syndrome; a warp
// whose sample reproduces it stores the state of that iteration and takes
// the next sample.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DC 32
#define TANH_CLIP 0.9999999f
#define FULL_MASK 0xffffffffu

// torch.clamp and torch.min propagate NaN, fminf and fmaxf drop it (as K1)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi)
{
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float lo)
{
    return isnan(x) ? x : fmaxf(x, lo);
}

// One check of degree dc <= MAXDC: new messages from the posteriors vs and
// the old messages r, the deltas into d, r updated. The loops run to the
// compile-time MAXDC so that the per-slot arrays stay in registers.
template <int MAXDC>
__device__ __forceinline__ void check_update(
    const float* vs, float* r, float* d, const int* __restrict__ cv, int dc,
    float ss, int method, float alpha, int use_alpha, float offset,
    int use_offset, float clip, int use_clip)
{
    float q[MAXDC], rn[MAXDC];
#pragma unroll
    for (int j = 0; j < MAXDC; ++j) {
        if (j < dc) {
            float x = vs[__ldg(cv + j)] - r[j];
            if (use_clip) x = clamp_nan(x, -clip, clip);
            q[j] = x;
        }
    }
    if (method == 0) {
        // leave-one-out product as exclusive prefix x exclusive suffix, both
        // folded sequentially (bp.py::_others_product)
        float t[MAXDC], suf[MAXDC + 1];
#pragma unroll
        for (int j = 0; j < MAXDC; ++j)
            if (j < dc) t[j] = tanhf(q[j] * 0.5f);
#pragma unroll
        for (int j = 0; j < MAXDC; ++j)
            if (j == dc - 1) suf[j] = t[j];
#pragma unroll
        for (int j = MAXDC - 2; j >= 0; --j)
            if (j < dc - 1) suf[j] = suf[j + 1] * t[j];
        float left = 1.0f;
#pragma unroll
        for (int j = 0; j < MAXDC; ++j) {
            if (j < dc) {
                const float right = j + 1 < dc ? suf[j + 1] : 1.0f;
                float x = (left * right) * ss;
                x = clamp_nan(x, -TANH_CLIP, TANH_CLIP);
                float rr = 2.0f * atanhf(x);
                if (use_alpha) rr = rr * alpha;
                rn[j] = rr;
                left = left * t[j];
            }
        }
    } else {
        // min-sum: leave-one-out sign, two minima with the first argmin,
        // optional offset, then alpha (as K1)
        int neg = 0, amin = 0;
        float min1 = fabsf(q[0]);
        bool has_nan = false;
#pragma unroll
        for (int j = 0; j < MAXDC; ++j) {
            if (j < dc) {
                neg += q[j] >= 0.0f ? 0 : 1;
                const float a = fabsf(q[j]);
                has_nan |= isnan(a);
                if (a < min1) { min1 = a; amin = j; }
            }
        }
        if (has_nan) min1 = __int_as_float(0x7fffffff);
        float min2 = __int_as_float(0x7f800000);  // +inf
#pragma unroll
        for (int j = 0; j < MAXDC; ++j)
            if (j < dc && j != amin) min2 = fminf(min2, fabsf(q[j]));
#pragma unroll
        for (int j = 0; j < MAXDC; ++j) {
            if (j < dc) {
                const int own = q[j] >= 0.0f ? 0 : 1;
                const float sign = ((neg - own) & 1) ? -1.0f : 1.0f;
                float mag = fabsf(q[j]) == min1 ? min2 : min1;
                if (use_offset) mag = max_nan(mag - offset, 0.0f);
                float rr = (ss * sign) * mag;
                if (use_alpha) rr = rr * alpha;
                rn[j] = rr;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < MAXDC; ++j) {
        if (j < dc) {
            d[j] = rn[j] - r[j];
            r[j] = rn[j];
        }
    }
}

// Six blocks of 256 threads an SM (at most 42 registers a thread) for the
// common small degree: measured faster on the H100 than the compiler's own
// choice of 48 registers, five blocks.
template <int MAXDC>
__global__ void __launch_bounds__(256, MAXDC <= 8 ? 6 : 1) bp_layered_warp_kernel(
    const uint8_t* __restrict__ syn,       // (B, m) 0/1
    const float* __restrict__ priors,      // (B, n) or (n,) with prior_stride 0
    int prior_stride,
    const int* __restrict__ check_var,     // (m, dc)
    const int* __restrict__ layer_vars,    // (L, T) touched variables, pad n
    const int* __restrict__ layer_edges,   // (L, T, K) layer-local edges, pad -1
    float* __restrict__ values_out,        // (B, n)
    uint8_t* __restrict__ conv_out,        // (B,)
    int* __restrict__ iters_out,           // (B,)
    int* __restrict__ next_sample,         // work counter, 0 at launch
    int B, int m, int n, int dc, int L, int T, int K,
    int method,                            // 0 sum-product, 1 min-sum
    float alpha, int use_alpha,
    float offset, int use_offset,
    float clip, int use_clip,
    int max_iter, int warp_floats)
{
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int E = m * dc, ml = m / L, El = ml * dc;
    float* R = smem + (size_t)(threadIdx.x >> 5) * warp_floats;  // (E,)
    float* D = R + E;                                             // (El,)
    float* V = D + El;                                            // (n,)
    uint8_t* ssyn = reinterpret_cast<uint8_t*>(V + n);            // (m,)

    for (;;) {
        int s = 0;
        if (lane == 0) s = atomicAdd(next_sample, 1);
        s = __shfl_sync(FULL_MASK, s, 0);
        if (s >= B) return;
        const float* pr = priors + (size_t)s * prior_stride;
        for (int v = lane; v < n; v += 32) V[v] = pr[v];
        for (int c = lane; c < m; c += 32) ssyn[c] = syn[(size_t)s * m + c];
        for (int e = lane; e < E; e += 32) R[e] = 0.0f;
        __syncwarp();

        int conv = 0, iters = max_iter > 0 ? max_iter - 1 : 0;
        for (int it = 0; it < max_iter; ++it) {
            for (int l = 0; l < L; ++l) {
                for (int cl = lane; cl < ml; cl += 32) {
                    const int c = l * ml + cl;
                    check_update<MAXDC>(V, R + c * dc, D + cl * dc, check_var + c * dc, dc,
                                        ssyn[c] ? -1.0f : 1.0f, method, alpha, use_alpha,
                                        offset, use_offset, clip, use_clip);
                }
                __syncwarp();
                const int* lv = layer_vars + (size_t)l * T;
                const int* le = layer_edges + (size_t)l * T * K;
                for (int k = lane; k < T; k += 32) {
                    const int v = __ldg(lv + k);
                    if (v >= n) continue;
                    float val = V[v];
                    for (int j = 0; j < K; ++j) {
                        const int e = __ldg(le + k * K + j);
                        if (e < 0) break;
                        val = val + D[e];
                    }
                    V[v] = val;
                }
                __syncwarp();
            }
            int mismatch = 0;
            for (int c = lane; c < m; c += 32) {
                const int* cv = check_var + c * dc;
                int par = 0;
                for (int j = 0; j < dc; ++j) par ^= V[__ldg(cv + j)] < 0.0f;
                mismatch |= par != ssyn[c];
            }
            if (!__any_sync(FULL_MASK, mismatch)) {
                conv = 1;
                iters = it;
                break;
            }
        }

        for (int v = lane; v < n; v += 32) values_out[(size_t)s * n + v] = V[v];
        if (lane == 0) {
            conv_out[s] = (uint8_t)conv;
            iters_out[s] = iters;
        }
        __syncwarp();  // the slice is reused by the next sample
    }
}

extern "C" int bp_layered_launch(
    const void* syn, const void* priors, int prior_stride,
    const void* check_var, const void* layer_vars, const void* layer_edges,
    void* values_out, void* conv_out, void* iters_out, void* counter,
    int B, int m, int n, int dc, int L, int T, int K, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float clip, int use_clip, int max_iter, int warps_per_block, void* stream_)
{
    if (dc < 1 || dc > MAX_DC || L < 1 || m % L || T < 1 || K < 1
        || warps_per_block < 1 || warps_per_block > 32)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    cudaStream_t stream = (cudaStream_t)stream_;
    // R, D and V in floats, the syndrome bytes, each slice 16-byte aligned
    const int warp_floats = ((m * dc + (m / L) * dc + n + (m + 3) / 4) + 3) & ~3;
    const size_t smem = (size_t)warps_per_block * warp_floats * sizeof(float);
    const int threads = 32 * warps_per_block;
    auto kernel = dc <= 8 ? &bp_layered_warp_kernel<8> : &bp_layered_warp_kernel<MAX_DC>;
    // opt in for every size: the default limit is 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem))
        != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long wanted = ((long long)B + warps_per_block - 1) / warps_per_block;
    const int blocks = (int)(wanted < (long long)sms * per_sm ? wanted : (long long)sms * per_sm);
    if ((err = cudaMemsetAsync(counter, 0, sizeof(int), stream)) != cudaSuccess) return (int)err;
    kernel<<<blocks, threads, smem, stream>>>(
        (const uint8_t*)syn, (const float*)priors, prior_stride,
        (const int*)check_var, (const int*)layer_vars, (const int*)layer_edges,
        (float*)values_out, (uint8_t*)conv_out, (int*)iters_out, (int*)counter,
        B, m, n, dc, L, T, K, method, alpha, use_alpha, offset, use_offset,
        clip, use_clip, max_iter, warp_floats);
    return (int)cudaGetLastError();
}

// Fused flooding belief propagation for check-regular Tanner graphs (K1).
//
// Replaces qldpc_tpu/ops/bp_pallas.py::_bp_kernel. It computes what the XLA
// flooding path (qldpc_tpu/decoders/bp.py::_step) computes, in the same
// floating-point order, so the plain torch version in ops/bp_cuda.py is its
// exact reference. The TPU kernel moved messages with one-hot MXU matmuls
// because Mosaic cannot gather; here every lane gathers from shared memory.
//
// What bounds it on the card: the check update's transcendental work
// (tanhf/atanhf per edge per iteration for sum-product) and how samples share
// the card, not device memory: a sample's syndrome and priors are read once
// and its posteriors written once, whatever its iteration count. Samples
// converge after 0 to 50 iterations, so one warp decodes one sample at a
// time, with Q, R, the posteriors and the syndrome in the warp's slice of
// shared memory (4.1 KB at [[144,12,12]]; the priors once a block when every
// sample shares them). Warps of a persistent grid, sized from the SM count
// and the occupancy, take the next sample from a global counter (zeroed on
// the stream per call), so a sample that converges frees its warp at once,
// no sample waits for another, and every barrier is a __syncwarp. The
// scheduling is K7's (bp_layered.cu).
//
// A warp's iteration is a chain of lane rounds (72 checks over 32 lanes is
// three), so each round's latency counts. The check rule of a lane is
// written out for the degrees of the BB codes (dc = 6, dv = 3) at compile
// time: its six tanhf and six atanhf are independent statements on
// registers, not a loop over a stack array, and overlap. Other degrees take
// the generic instance (dc <= 32 at run time).
//
// Layout: edge e = c*dc + j (check-regular graphs: edges sorted by check).
// check_var (m, dc) holds the variable of each edge; var_edge (n, dv) holds
// each variable's edges in order, padded with E. Per iteration:
//   1. check phase, one lane per check: R from Q;
//   2. variable phase, one lane per variable: the posterior as a left fold
//      over the variable's edges plus the prior, then Q = posterior - R,
//      damping and clip for each of its edges;
//   3. syndrome test, one lane per check: the parity of the hard decisions
//      (posterior < 0) against the syndrome; __any_sync over the warp.
// A sample that reproduces its syndrome stores the state of that iteration.
//
// bf16 operands (mm_dtype="bfloat16", qldpc_tpu/ops/bp_pallas.py:283-297) are
// a compile-time flag (BF): the messages round where the TPU kernel's bf16
// matmul operands round them, rd(x) being round-to-nearest-even to bf16 and
// back. The first Q of an edge is rd(prior) (and so is every prior the
// block's first-iteration table is built from); the posterior is the float32
// left fold of rd(R) over the variable's edges plus the float32 prior; the
// next Q is rd(posterior) - R, R unrounded, then damping against the old Q
// (rd(prior) at the first iteration) and the clip. The hard decision and
// convergence read the float32 posterior. The state stays in shared memory
// as float32, so BF changes no byte the kernel moves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_util.cuh"

#define MAX_DC 32
#define TANH_CLIP 0.9999999f
#define FULL_MASK 0xffffffffu
// blocks of 256 threads an SM that the registers must allow
#define K1_MIN_BLOCKS 4

// torch.clamp and torch.min propagate NaN, fminf and fmaxf drop it: these
// helpers and the explicit test in the min-sum rule keep the kernel equal to
// the plain version when an infinite prior or a check of degree 1 turns a
// message into NaN (inf - inf on the variable side).
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi)
{
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float lo)
{
    return isnan(x) ? x : fmaxf(x, lo);
}

// x rounded to nearest even in bf16 under BF, back in float32; else x
template <bool BF>
__device__ __forceinline__ float rd(float x)
{
    if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(x)); else return x;
}

// One check's rule on its dc messages q (Q, or at the first iteration the
// priors of its variables, rounded under BF: what Q would hold), into r.
// DC > 0: dc = DC at compile time; DC = 0: dc <= MAX_DC at run time.
template <int DC, bool BF>
__device__ __forceinline__ void check_rule(
    const float* q_src, const float* P, const int* __restrict__ cv, bool from_prior, float* r,
    float ss, int dc_rt, int method, float alpha, int use_alpha, float offset,
    int use_offset)
{
    if constexpr (DC > 0) {
        float q[DC];
        unrolled<DC>([&](auto j) { q[j] = from_prior ? rd<BF>(P[__ldg(cv + j)]) : q_src[j]; });
        if (method == 0) {
            // leave-one-out product as exclusive prefix x exclusive suffix,
            // both folded sequentially (bp.py::_others_product)
            float t[DC], suf[DC + 1], x[DC];
            unrolled<DC>([&](auto j) { t[j] = tanhf(q[j] * 0.5f); });
            suf[DC] = 1.0f;
            unrolled<DC>([&](auto i) {
                constexpr int j = DC - 1 - decltype(i)::value;
                suf[j] = j == DC - 1 ? t[j] : suf[j + 1] * t[j];
            });
            float left = 1.0f;
            unrolled<DC>([&](auto j) {
                const float right = j + 1 < DC ? suf[j + 1] : 1.0f;
                x[j] = clamp_nan((left * right) * ss, -TANH_CLIP, TANH_CLIP);
                left = left * t[j];
            });
            unrolled<DC>([&](auto j) {
                float rr = 2.0f * atanhf(x[j]);
                if (use_alpha) rr = rr * alpha;
                r[j] = rr;
            });
        } else {
            // min-sum: leave-one-out sign, two minima with the first argmin,
            // optional offset, then alpha (bp.py:261-290). A NaN |Q| makes
            // min1 NaN, so every magnitude is NaN.
            int neg = 0, amin = 0;
            float min1 = fabsf(q[0]);
            bool has_nan = false;
            unrolled<DC>([&](auto j) {
                neg += q[j] >= 0.0f ? 0 : 1;
                const float a = fabsf(q[j]);
                has_nan |= isnan(a);
                if (a < min1) { min1 = a; amin = j; }
            });
            if (has_nan) min1 = __int_as_float(0x7fffffff);
            float min2 = __int_as_float(0x7f800000);  // +inf
            unrolled<DC>([&](auto j) { if (j != amin) min2 = fminf(min2, fabsf(q[j])); });
            unrolled<DC>([&](auto j) {
                const int own = q[j] >= 0.0f ? 0 : 1;
                const float sign = ((neg - own) & 1) ? -1.0f : 1.0f;
                float mag = fabsf(q[j]) == min1 ? min2 : min1;
                if (use_offset) mag = max_nan(mag - offset, 0.0f);
                float rr = (ss * sign) * mag;
                if (use_alpha) rr = rr * alpha;
                r[j] = rr;
            });
        }
    } else {
        const int dc = dc_rt;
        float q[MAX_DC];
        for (int j = 0; j < dc; ++j) q[j] = from_prior ? rd<BF>(P[__ldg(cv + j)]) : q_src[j];
        if (method == 0) {
            float t[MAX_DC], suf[MAX_DC];
            for (int j = 0; j < dc; ++j) t[j] = tanhf(q[j] * 0.5f);
            suf[dc - 1] = t[dc - 1];
            for (int j = dc - 2; j >= 0; --j) suf[j] = suf[j + 1] * t[j];
            float left = 1.0f;
            for (int j = 0; j < dc; ++j) {
                const float right = j + 1 < dc ? suf[j + 1] : 1.0f;
                float x = clamp_nan((left * right) * ss, -TANH_CLIP, TANH_CLIP);
                float rr = 2.0f * atanhf(x);
                if (use_alpha) rr = rr * alpha;
                r[j] = rr;
                left = left * t[j];
            }
        } else {
            int neg = 0, amin = 0;
            float min1 = fabsf(q[0]);
            bool has_nan = false;
            for (int j = 0; j < dc; ++j) {
                neg += q[j] >= 0.0f ? 0 : 1;
                const float a = fabsf(q[j]);
                has_nan |= isnan(a);
                if (a < min1) { min1 = a; amin = j; }
            }
            if (has_nan) min1 = __int_as_float(0x7fffffff);
            float min2 = __int_as_float(0x7f800000);  // +inf
            for (int j = 0; j < dc; ++j)
                if (j != amin) min2 = fminf(min2, fabsf(q[j]));
            for (int j = 0; j < dc; ++j) {
                const int own = q[j] >= 0.0f ? 0 : 1;
                const float sign = ((neg - own) & 1) ? -1.0f : 1.0f;
                float mag = fabsf(q[j]) == min1 ? min2 : min1;
                if (use_offset) mag = max_nan(mag - offset, 0.0f);
                float rr = (ss * sign) * mag;
                if (use_alpha) rr = rr * alpha;
                r[j] = rr;
            }
        }
    }
}

// DC, DV > 0: the degrees at compile time (check-regular dc, and dv edges a
// variable with padding allowed); 0: at run time. BF: bf16 operands.
template <int DC, int DV, bool BF>
__global__ void __launch_bounds__(256, DC > 0 ? K1_MIN_BLOCKS : 1) bp_flooding_warp_kernel(
    const uint8_t* __restrict__ syn,      // (B, m) 0/1
    const float* __restrict__ priors,     // (B, n) or (n,) with prior_stride 0
    int prior_stride,
    const int* __restrict__ check_var,    // (m, dc)
    const int* __restrict__ var_edge,     // (n, dv), padded with E
    float* __restrict__ values_out,       // (B, n)
    uint8_t* __restrict__ conv_out,       // (B,)
    int* __restrict__ iters_out,          // (B,)
    int* __restrict__ next_sample,        // work counter, 0 at launch
    int B, int m, int n, int dc_rt, int dv_rt,
    int method,                           // 0 sum-product, 1 min-sum
    float alpha, int use_alpha,
    float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip,
    int max_iter, int warp_floats)
{
    extern __shared__ float smem[];
    const int dc = DC > 0 ? DC : dc_rt, dv = DV > 0 ? DV : dv_rt;
    const int lane = threadIdx.x & 31;
    const int E = m * dc;
    const bool shared_prior = prior_stride == 0;
    // ahead of the slices when every sample shares the priors: the priors,
    // and the first iteration's R for either syndrome bit of each check (a
    // check's messages are then its variables' priors in every sample)
    float* Pb = smem;
    float* R0 = smem + ((n + 3) & ~3);                     // (2, E)
    float* Q = smem + (shared_prior ? ((n + 3) & ~3) + 2 * E : 0)
               + (size_t)(threadIdx.x >> 5) * warp_floats;
    float* R = Q + E;                                      // (E,)
    float* V = R + E;                                      // (n,) posteriors
    float* P = shared_prior ? Pb : V + n;                  // (n,) priors
    uint8_t* ssyn = reinterpret_cast<uint8_t*>(V + n + (shared_prior ? 0 : n));  // (m,)
    if (shared_prior) {  // once, before any sample
        for (int v = threadIdx.x; v < n; v += blockDim.x) Pb[v] = priors[v];
        __syncthreads();
        for (int i = threadIdx.x; i < 2 * m; i += blockDim.x) {
            const int bit = i >= m, c = i - bit * m;
            check_rule<DC, BF>(nullptr, Pb, check_var + c * dc, true, R0 + bit * E + c * dc,
                           bit ? -1.0f : 1.0f, dc, method, alpha, use_alpha, offset, use_offset);
        }
        __syncthreads();
    }

    for (;;) {
        int s = 0;
        if (lane == 0) s = atomicAdd(next_sample, 1);
        s = __shfl_sync(FULL_MASK, s, 0);
        if (s >= B) return;
        if (!shared_prior) {
            const float* pr = priors + (size_t)s * prior_stride;
            for (int v = lane; v < n; v += 32) P[v] = pr[v];
        }
        for (int c = lane; c < m; c += 32) ssyn[c] = syn[(size_t)s * m + c];
        __syncwarp();
        for (int v = lane; v < n; v += 32) V[v] = P[v];
        __syncwarp();

        int conv = 0, iters = max_iter > 0 ? max_iter - 1 : 0;
        for (int it = 0; it < max_iter; ++it) {
            // 1. check phase (the first iteration's from the priors, or from
            //    the block's table when they are shared)
            const bool from_table = shared_prior && it == 0;
            if (!from_table)
                for (int c = lane; c < m; c += 32)
                    check_rule<DC, BF>(Q + c * dc, P, check_var + c * dc, it == 0, R + c * dc,
                                   ssyn[c] ? -1.0f : 1.0f, dc, method, alpha, use_alpha, offset,
                                   use_offset);
            __syncwarp();
            // 2. variable phase; the first iteration damps against Q = the
            //    variable's prior
            auto r_of = [&](int ek) {
                return ek >= E ? 0.0f : from_table ? R0[(ssyn[ek / dc] ? E : 0) + ek] : R[ek];
            };
            // the posterior folds rd(R); each next Q takes R unrounded
            // (the pads' 0 rounds to itself)
            for (int v = lane; v < n; v += 32) {
                const int* ve = var_edge + v * dv;
                int e[DV > 0 ? DV : 1];
                float r[DV > 0 ? DV : 1];
                float acc;
                if constexpr (DV > 0) {
                    unrolled<DV>([&](auto k) {
                        e[k] = __ldg(ve + k);
                        r[k] = r_of(e[k]);
                    });
                    acc = rd<BF>(r[0]);
                    unrolled<DV - 1>([&](auto k) { acc = acc + rd<BF>(r[k + 1]); });
                } else {
                    acc = rd<BF>(r_of(__ldg(ve)));
                    for (int k = 1; k < dv; ++k) acc = acc + rd<BF>(r_of(__ldg(ve + k)));
                }
                acc = acc + P[v];  // the posterior
                V[v] = acc;
                const float from = rd<BF>(acc);
                auto update = [&](int ek, float rk) {
                    if (ek >= E) return;
                    float qn = from - rk;
                    if (use_damping)
                        qn = damp_new * qn + damp_old * (it == 0 ? rd<BF>(P[v]) : Q[ek]);
                    if (use_clip) qn = clamp_nan(qn, -clip, clip);
                    Q[ek] = qn;
                };
                if constexpr (DV > 0) {
                    unrolled<DV>([&](auto k) { update(e[k], r[k]); });
                } else {
                    for (int k = 0; k < dv; ++k) {
                        const int ek = __ldg(ve + k);
                        update(ek, r_of(ek));
                    }
                }
            }
            __syncwarp();
            // 3. syndrome test
            int mismatch = 0;
            for (int c = lane; c < m; c += 32) {
                const int* cv = check_var + c * dc;
                int par = 0;
                if constexpr (DC > 0) {
                    unrolled<DC>([&](auto j) { par ^= V[__ldg(cv + j)] < 0.0f; });
                } else {
                    for (int j = 0; j < dc; ++j) par ^= V[__ldg(cv + j)] < 0.0f;
                }
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

// Floats of one warp's slice: Q, R, the posteriors, the priors unless they
// are shared, the syndrome bytes; 16-byte aligned. A block also holds the
// shared priors and the first iteration's table (2 E) ahead of the slices.
extern "C" int bp_flooding_warp_floats(int m, int n, int dc, int shared_prior)
{
    return ((2 * m * dc + n + (shared_prior ? 0 : n) + (m + 3) / 4) + 3) & ~3;
}

typedef void (*k1_kernel_t)(
    const uint8_t*, const float*, int, const int*, const int*, float*, uint8_t*, int*, int*,
    int, int, int, int, int, int, float, int, float, int, float, float, int, float, int, int, int);

// The persistent grid: as many blocks as the samples need, at most what the
// SMs hold at once (the occupancy of this size). The instance: the BB codes'
// degrees at compile time, any other at run time, each with float32 or bf16
// operands. Returns the blocks, or a negative cudaError_t.
static int grid_blocks(int B, int m, int n, int dc, int dv, int shared_prior, int bf16,
                       int warps_per_block, int* warp_floats, size_t* smem,
                       k1_kernel_t* kernel_out)
{
    *warp_floats = bp_flooding_warp_floats(m, n, dc, shared_prior);
    *smem = ((size_t)warps_per_block * *warp_floats
             + (shared_prior ? ((n + 3) & ~3) + 2 * (size_t)m * dc : 0)) * sizeof(float);
    const int threads = 32 * warps_per_block;
    const bool bb = dc == 6 && dv == 3;
    const k1_kernel_t kernel = bf16 ? (bb ? &bp_flooding_warp_kernel<6, 3, true>
                                          : &bp_flooding_warp_kernel<0, 0, true>)
                                    : (bb ? &bp_flooding_warp_kernel<6, 3, false>
                                          : &bp_flooding_warp_kernel<0, 0, false>);
    *kernel_out = kernel;
    // opt in for every size: the default limit is 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err != cudaSuccess) return -(int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return -(int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return -(int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, *smem))
        != cudaSuccess)
        return -(int)err;
    if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
    const long long wanted = ((long long)B + warps_per_block - 1) / warps_per_block;
    return (int)(wanted < (long long)sms * per_sm ? wanted : (long long)sms * per_sm);
}

extern "C" int bp_flooding_grid(int B, int m, int n, int dc, int dv, int shared_prior,
                                int bf16, int warps_per_block)
{
    if (dc < 1 || dc > MAX_DC || warps_per_block < 1 || warps_per_block > 32 || B <= 0)
        return -(int)cudaErrorInvalidValue;
    int warp_floats;
    size_t smem;
    k1_kernel_t kernel;
    return grid_blocks(B, m, n, dc, dv, shared_prior, bf16, warps_per_block, &warp_floats,
                       &smem, &kernel);
}

extern "C" int bp_flooding_launch(
    const void* syn, const void* priors, int prior_stride,
    const void* check_var, const void* var_edge,
    void* values_out, void* conv_out, void* iters_out, void* counter,
    int B, int m, int n, int dc, int dv, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int bf16, int max_iter,
    int warps_per_block, void* stream_)
{
    if (dc < 1 || dc > MAX_DC || warps_per_block < 1 || warps_per_block > 32)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    cudaStream_t stream = (cudaStream_t)stream_;
    int warp_floats;
    size_t smem;
    k1_kernel_t kernel;
    const int blocks = grid_blocks(B, m, n, dc, dv, prior_stride == 0, bf16, warps_per_block,
                                   &warp_floats, &smem, &kernel);
    if (blocks < 0) return -blocks;
    cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, 32 * warps_per_block, smem, stream>>>(
        (const uint8_t*)syn, (const float*)priors, prior_stride,
        (const int*)check_var, (const int*)var_edge,
        (float*)values_out, (uint8_t*)conv_out, (int*)iters_out, (int*)counter,
        B, m, n, dc, dv, method, alpha, use_alpha, offset, use_offset,
        damp_new, damp_old, use_damping, clip, use_clip, max_iter, warp_floats);
    return (int)cudaGetLastError();
}

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
// thread gathers from shared memory.
//
// What bounds it on the card: as K1, the transcendental work of the check
// rule and the barriers, here two per layer (2L per iteration) plus the
// syndrome and freeze. Device memory is touched only to load a sample's
// syndrome and priors and to store its posteriors: one CTA decodes S
// samples with R, one layer's deltas, the posteriors and the syndrome
// resident in shared memory (2.8 KB per sample at [[144,12,12]]), and
// leaves once all of its samples have converged.
//
// Layout: edge e = c*dc + j; layer l holds checks [l*ml, (l+1)*ml) and so
// edges [l*El, (l+1)*El), El = ml*dc. Per iteration, for each layer:
//   1. check phase, one thread per (sample, check of the layer): Q from the
//      posteriors and R, R_new, the delta R_new - R_old into D, R = R_new;
//   2. variable phase, one thread per (sample, variable): the posterior
//      plus the deltas of its edges in the layer, ascending.
// Then one thread per (sample, check) checks the parity of the hard
// decisions against the syndrome, and one thread freezes the samples whose
// syndrome is reproduced, keeping the state of that iteration.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DC 32
#define MAX_S 64
#define TANH_CLIP 0.9999999f

// torch.clamp and torch.min propagate NaN, fminf and fmaxf drop it (as K1)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi)
{
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float lo)
{
    return isnan(x) ? x : fmaxf(x, lo);
}

__global__ void bp_layered_kernel(
    const uint8_t* __restrict__ syn,      // (B, m) 0/1
    const float* __restrict__ priors,     // (B, n) or (n,) with prior_stride 0
    int prior_stride,
    const int* __restrict__ check_var,    // (m, dc)
    const int* __restrict__ var_edge,     // (n, dv), padded with E
    float* __restrict__ values_out,       // (B, n)
    uint8_t* __restrict__ conv_out,       // (B,)
    int* __restrict__ iters_out,          // (B,)
    int B, int m, int n, int dc, int dv, int L,
    int method,                           // 0 sum-product, 1 min-sum
    float alpha, int use_alpha,
    float offset, int use_offset,
    float clip, int use_clip,
    int max_iter, int S)
{
    extern __shared__ float smem[];
    const int E = m * dc, ml = m / L, El = ml * dc;
    float* R = smem;                 // (S, E)
    float* D = R + S * E;            // (S, El) one layer's deltas
    float* V = D + S * El;           // (S, n) posteriors
    uint8_t* ssyn = reinterpret_cast<uint8_t*>(V + S * n);  // (S, m)

    __shared__ int active[MAX_S];
    __shared__ int mismatch[MAX_S];
    __shared__ int conv_s[MAX_S];
    __shared__ int iters_s[MAX_S];
    __shared__ int any_active;

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int b0 = blockIdx.x * S;

    for (int i = tid; i < S * n; i += nt) {
        const int s = i / n, v = i - s * n, b = b0 + s;
        V[i] = b < B ? priors[(size_t)b * prior_stride + v] : 0.0f;
    }
    for (int i = tid; i < S * m; i += nt) {
        const int s = i / m, c = i - s * m, b = b0 + s;
        ssyn[i] = b < B ? syn[(size_t)b * m + c] : 0;
    }
    for (int i = tid; i < S * E; i += nt) R[i] = 0.0f;
    if (tid < S) {
        active[tid] = (b0 + tid) < B;
        conv_s[tid] = 0;
        iters_s[tid] = max_iter > 0 ? max_iter - 1 : 0;
    }
    __syncthreads();

    for (int it = 0; it < max_iter; ++it) {
        for (int l = 0; l < L; ++l) {
            const int e0 = l * El;
            // ---- 1. check phase on layer l -------------------------------
            for (int i = tid; i < S * ml; i += nt) {
                const int s = i / ml, cl = i - s * ml;
                if (!active[s]) continue;
                const int c = l * ml + cl;
                const int* cv = check_var + c * dc;
                const float* vs = V + s * n;
                float* r = R + s * E + c * dc;
                float* d = D + s * El + cl * dc;
                const float ss = ssyn[s * m + c] ? -1.0f : 1.0f;
                float q[MAX_DC], rn[MAX_DC];
                for (int j = 0; j < dc; ++j) {
                    float x = vs[cv[j]] - r[j];
                    if (use_clip) x = clamp_nan(x, -clip, clip);
                    q[j] = x;
                }
                if (method == 0) {
                    // leave-one-out product as exclusive prefix x exclusive
                    // suffix, both folded sequentially (bp.py::_others_product)
                    float t[MAX_DC], suf[MAX_DC];
                    for (int j = 0; j < dc; ++j) t[j] = tanhf(q[j] * 0.5f);
                    suf[dc - 1] = t[dc - 1];
                    for (int j = dc - 2; j >= 0; --j) suf[j] = suf[j + 1] * t[j];
                    float left = 1.0f;
                    for (int j = 0; j < dc; ++j) {
                        const float right = j + 1 < dc ? suf[j + 1] : 1.0f;
                        float x = (left * right) * ss;
                        x = clamp_nan(x, -TANH_CLIP, TANH_CLIP);
                        float rr = 2.0f * atanhf(x);
                        if (use_alpha) rr = rr * alpha;
                        rn[j] = rr;
                        left = left * t[j];
                    }
                } else {
                    // min-sum: leave-one-out sign, two minima with the first
                    // argmin, optional offset, then alpha (as K1)
                    int neg = 0;
                    float min1 = fabsf(q[0]);
                    int amin = 0;
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
                        rn[j] = rr;
                    }
                }
                for (int j = 0; j < dc; ++j) {
                    d[j] = rn[j] - r[j];
                    r[j] = rn[j];
                }
            }
            __syncthreads();

            // ---- 2. variable phase on layer l ----------------------------
            for (int i = tid; i < S * n; i += nt) {
                const int s = i / n, v = i - s * n;
                if (!active[s]) continue;
                const int* ve = var_edge + v * dv;
                const float* ds = D + s * El;
                float val = V[i];
                for (int j = 0; j < dv; ++j) {
                    const int e = ve[j];
                    if (e < E && e >= e0 && e < e0 + El) val = val + ds[e - e0];
                }
                V[i] = val;
            }
            __syncthreads();
        }

        // ---- 3. syndrome phase -------------------------------------------
        if (tid < S) mismatch[tid] = 0;
        __syncthreads();
        for (int i = tid; i < S * m; i += nt) {
            const int s = i / m, c = i - s * m;
            if (!active[s]) continue;
            const int* cv = check_var + c * dc;
            const float* vs = V + s * n;
            int par = 0;
            for (int j = 0; j < dc; ++j) par ^= vs[cv[j]] < 0.0f;
            if (par != ssyn[i]) mismatch[s] = 1;
        }
        __syncthreads();

        // ---- 4. freeze ---------------------------------------------------
        if (tid == 0) {
            int any = 0;
            for (int s = 0; s < S; ++s) {
                if (!active[s]) continue;
                if (mismatch[s]) {
                    any = 1;
                } else {
                    active[s] = 0;
                    conv_s[s] = 1;
                    iters_s[s] = it;
                }
            }
            any_active = any;
        }
        __syncthreads();
        if (!any_active) break;
    }

    for (int i = tid; i < S * n; i += nt) {
        const int s = i / n, b = b0 + s;
        if (b < B) values_out[(size_t)b * n + (i - s * n)] = V[i];
    }
    if (tid < S && b0 + tid < B) {
        conv_out[b0 + tid] = (uint8_t)conv_s[tid];
        iters_out[b0 + tid] = iters_s[tid];
    }
}

extern "C" int bp_layered_launch(
    const void* syn, const void* priors, int prior_stride,
    const void* check_var, const void* var_edge,
    void* values_out, void* conv_out, void* iters_out,
    int B, int m, int n, int dc, int dv, int L, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float clip, int use_clip, int max_iter,
    int samples_per_block, int threads, void* stream)
{
    if (dc > MAX_DC || samples_per_block > MAX_S || samples_per_block < 1
        || L < 1 || m % L)
        return (int)cudaErrorInvalidValue;
    const int S = samples_per_block;
    const size_t smem = (size_t)S * (m * dc + (m / L) * dc + n) * sizeof(float)
                        + (size_t)S * m;
    // opt in for every size: the static shared memory counts against the
    // same 48 KB default as the dynamic part
    cudaError_t err = cudaFuncSetAttribute(
        bp_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + S - 1) / S;
    if (blocks > 0) {
        bp_layered_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)syn, (const float*)priors, prior_stride,
            (const int*)check_var, (const int*)var_edge,
            (float*)values_out, (uint8_t*)conv_out, (int*)iters_out,
            B, m, n, dc, dv, L, method, alpha, use_alpha, offset, use_offset,
            clip, use_clip, max_iter, S);
    }
    return (int)cudaGetLastError();
}

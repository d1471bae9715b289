// Fused flooding belief propagation for check-regular Tanner graphs (K1).
//
// Replaces qldpc_tpu/ops/bp_pallas.py::_bp_kernel. It computes what the XLA
// flooding path (qldpc_tpu/decoders/bp.py::_step) computes, in the same
// floating-point order, so the plain torch version in ops/bp_cuda.py is its
// exact reference. The TPU kernel moved messages with one-hot MXU matmuls
// because Mosaic cannot gather; here every thread gathers from shared memory.
//
// What bounds it on the card: the check update's transcendental work
// (tanhf/atanhf per edge per iteration for sum-product) and the latency of
// the block-wide barriers between the three phases of an iteration. Device
// memory is touched only to load a sample's syndrome and priors and to store
// its posteriors: one CTA decodes S samples with Q, R, the posteriors and the
// hard decisions resident in shared memory for all iterations (4.8 KB per
// sample at [[144,12,12]]), and leaves as soon as all of its samples have
// converged, so device memory traffic is independent of the iteration count.
//
// Layout: edge e = c*dc + j (check-regular graphs: edges sorted by check).
// check_var (m, dc) holds the variable of each edge; var_edge (n, dv) holds
// each variable's edges in order, padded with E. Per iteration:
//   1. check phase, one thread per (sample, check): R from Q;
//   2. variable phase, one thread per (sample, variable): the posterior as a
//      left fold over the variable's edges plus the prior, hard decision,
//      then Q = posterior - R, damping and clip for each of its edges;
//   3. syndrome phase, one thread per (sample, check): parity of the hard
//      decisions against the syndrome;
//   4. one thread freezes the samples whose syndrome is reproduced.
// A converged sample keeps the state of the iteration that converged it.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DC 32
#define MAX_S 64
#define TANH_CLIP 0.9999999f

__global__ void bp_flooding_kernel(
    const uint8_t* __restrict__ syn,      // (B, m) 0/1
    const float* __restrict__ priors,     // (B, n) or (n,) with prior_stride 0
    int prior_stride,
    const int* __restrict__ check_var,    // (m, dc)
    const int* __restrict__ var_edge,     // (n, dv), padded with E
    float* __restrict__ values_out,       // (B, n)
    uint8_t* __restrict__ conv_out,       // (B,)
    int* __restrict__ iters_out,          // (B,)
    int B, int m, int n, int dc, int dv,
    int method,                           // 0 sum-product, 1 min-sum
    float alpha, int use_alpha,
    float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip,
    int max_iter, int S)
{
    extern __shared__ float smem[];
    const int E = m * dc;
    float* Q = smem;                 // (S, E)
    float* R = Q + S * E;            // (S, E)
    float* V = R + S * E;            // (S, n) posteriors
    float* P = V + S * n;            // (S, n) priors
    uint8_t* hard = reinterpret_cast<uint8_t*>(P + S * n);  // (S, n)
    uint8_t* ssyn = hard + S * n;    // (S, m)

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
        const float p = b < B ? priors[(size_t)b * prior_stride + v] : 0.0f;
        P[i] = p;
        V[i] = p;
    }
    for (int i = tid; i < S * m; i += nt) {
        const int s = i / m, c = i - s * m, b = b0 + s;
        ssyn[i] = b < B ? syn[(size_t)b * m + c] : 0;
    }
    for (int i = tid; i < S * E; i += nt) {
        const int s = i / E, e = i - s * E, b = b0 + s;
        Q[i] = b < B ? priors[(size_t)b * prior_stride + check_var[e]] : 0.0f;
    }
    if (tid < S) {
        active[tid] = (b0 + tid) < B;
        conv_s[tid] = 0;
        iters_s[tid] = max_iter > 0 ? max_iter - 1 : 0;
    }
    __syncthreads();

    for (int it = 0; it < max_iter; ++it) {
        // ---- 1. check phase --------------------------------------------
        for (int i = tid; i < S * m; i += nt) {
            const int s = i / m, c = i - s * m;
            if (!active[s]) continue;
            const float* q = Q + s * E + c * dc;
            float* r = R + s * E + c * dc;
            const float ss = ssyn[i] ? -1.0f : 1.0f;
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
                    x = fminf(fmaxf(x, -TANH_CLIP), TANH_CLIP);
                    float rr = 2.0f * atanhf(x);
                    if (use_alpha) rr = rr * alpha;
                    r[j] = rr;
                    left = left * t[j];
                }
            } else {
                // min-sum: leave-one-out sign, two minima with the first
                // argmin, optional offset, then alpha (bp.py:261-290)
                int neg = 0;
                float min1 = fabsf(q[0]);
                int amin = 0;
                for (int j = 0; j < dc; ++j) {
                    neg += q[j] >= 0.0f ? 0 : 1;
                    const float a = fabsf(q[j]);
                    if (a < min1) { min1 = a; amin = j; }
                }
                float min2 = __int_as_float(0x7f800000);  // +inf
                for (int j = 0; j < dc; ++j)
                    if (j != amin) min2 = fminf(min2, fabsf(q[j]));
                for (int j = 0; j < dc; ++j) {
                    const int own = q[j] >= 0.0f ? 0 : 1;
                    const float sign = ((neg - own) & 1) ? -1.0f : 1.0f;
                    float mag = fabsf(q[j]) == min1 ? min2 : min1;
                    if (use_offset) mag = fmaxf(mag - offset, 0.0f);
                    float rr = (ss * sign) * mag;
                    if (use_alpha) rr = rr * alpha;
                    r[j] = rr;
                }
            }
        }
        if (tid < S) mismatch[tid] = 0;
        __syncthreads();

        // ---- 2. variable phase -----------------------------------------
        for (int i = tid; i < S * n; i += nt) {
            const int s = i / n, v = i - s * n;
            if (!active[s]) continue;
            const int* ve = var_edge + v * dv;
            const float* rs = R + s * E;
            float acc = ve[0] < E ? rs[ve[0]] : 0.0f;
            for (int k = 1; k < dv; ++k) acc = acc + (ve[k] < E ? rs[ve[k]] : 0.0f);
            const float val = acc + P[i];
            V[i] = val;
            hard[i] = val < 0.0f;
            float* qs = Q + s * E;
            for (int k = 0; k < dv; ++k) {
                const int e = ve[k];
                if (e >= E) continue;
                float qn = val - rs[e];
                if (use_damping) qn = damp_new * qn + damp_old * qs[e];
                if (use_clip) qn = fminf(fmaxf(qn, -clip), clip);
                qs[e] = qn;
            }
        }
        __syncthreads();

        // ---- 3. syndrome phase -----------------------------------------
        for (int i = tid; i < S * m; i += nt) {
            const int s = i / m, c = i - s * m;
            if (!active[s]) continue;
            const int* cv = check_var + c * dc;
            const uint8_t* hs = hard + s * n;
            int par = 0;
            for (int j = 0; j < dc; ++j) par ^= hs[cv[j]];
            if (par != ssyn[i]) mismatch[s] = 1;
        }
        __syncthreads();

        // ---- 4. freeze -------------------------------------------------
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

extern "C" int bp_flooding_launch(
    const void* syn, const void* priors, int prior_stride,
    const void* check_var, const void* var_edge,
    void* values_out, void* conv_out, void* iters_out,
    int B, int m, int n, int dc, int dv, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int max_iter,
    int samples_per_block, int threads, void* stream)
{
    if (dc > MAX_DC || samples_per_block > MAX_S || samples_per_block < 1)
        return (int)cudaErrorInvalidValue;
    const int S = samples_per_block;
    const size_t smem = (size_t)S * (2 * m * dc + 2 * n) * sizeof(float)
                        + (size_t)S * (n + m);
    // opt in for every size: the kernel's static shared memory counts
    // against the same 48 KB default as the dynamic part
    cudaError_t err = cudaFuncSetAttribute(
        bp_flooding_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + S - 1) / S;
    if (blocks > 0) {
        bp_flooding_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)syn, (const float*)priors, prior_stride,
            (const int*)check_var, (const int*)var_edge,
            (float*)values_out, (uint8_t*)conv_out, (int*)iters_out,
            B, m, n, dc, dv, method, alpha, use_alpha, offset, use_offset,
            damp_new, damp_old, use_damping, clip, use_clip, max_iter, S);
    }
    return (int)cudaGetLastError();
}

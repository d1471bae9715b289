// Structured space-time belief propagation (K6).
//
// Replaces qldpc_tpu/ops/spacetime_bp_pallas.py::_st_bp_kernel. It computes
// flooding BP on H_st = [I_T (x) H | I + S_{-m}] without building it, as
// qldpc_tpu/decoders/spacetime_bp.py::SpaceTimeBPDecoder._build does, in
// the same floating-point order, so the plain torch version in
// ops/spacetime_bp_cuda.py is its exact reference. The TPU kernel moved the
// spatial messages of each round with one-hot MXU matmuls on the base
// tables and evaluated atanh through its log identity; here every thread
// gathers from shared memory and calls atanhf.
//
// What bounds it on the card: as K1, the check update's transcendental work
// (tanhf and atanhf on every one of the dc + 2 slots of each of the T*m
// checks, each iteration, for sum-product) and the block-wide barriers
// between the phases of an iteration. Device memory is touched only to load
// a sample's detectors and the priors and to store its posteriors: a block
// decodes S samples with Q and R on all T*m*(dc + 2) slots, the T*(n + m)
// posteriors and the hard decisions resident in shared memory (69 KB per
// sample at [[144,12,12]], T = 12, so one sample a block and three blocks a
// multiprocessor), and leaves as soon as its samples have converged.
//
// Layout per sample: spatial slot t*E + c*dc + j (E = m*dc, the base code's
// edge e = c*dc + j in round t); temporal slots t*m + c, "a" for u_t and "b"
// for u_{t-1}, whose round-0 entries are the phantom pinned to BIG. The
// priors are per variable, shared by the batch, and read through the cache.
// Per iteration:
//   1. check phase, one thread per (sample, round, check): R on the dc + 2
//      slots from Q, the rule of K1;
//   2. variable phase, one thread per (sample, round, variable): the
//      posterior as a left fold over the base variable's edges in that round
//      plus the prior, hard decision, Q = posterior - R on its edges; then
//      one thread per (sample, round, check) for u_t: the posterior
//      (R_a[t] + R_b[t+1]) + prior (R_b[T] = 0), Q_a[t] and Q_b[t+1];
//      damping and clip on all three message planes;
//   3. syndrome phase, one thread per (sample, round, check): parity of the
//      base check's hard decisions in round t, u_t and u_{t-1} against the
//      detector;
//   4. one thread freezes the samples whose detectors are reproduced.
// A converged sample keeps the state of the iteration that converged it.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SLOTS 32
#define MAX_S 16
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

// R on k slots of one check from q[0..k-1]; writes r[j] for each slot.
__device__ __forceinline__ void check_rule(
    const float* q, float* r, int k, float ss, int method,
    float alpha, int use_alpha, float offset, int use_offset)
{
    if (method == 0) {
        // leave-one-out product as exclusive prefix x exclusive suffix,
        // both folded sequentially (bp.py::_others_product)
        float t[MAX_SLOTS], suf[MAX_SLOTS];
        for (int j = 0; j < k; ++j) t[j] = tanhf(q[j] * 0.5f);
        suf[k - 1] = t[k - 1];
        for (int j = k - 2; j >= 0; --j) suf[j] = suf[j + 1] * t[j];
        float left = 1.0f;
        for (int j = 0; j < k; ++j) {
            const float right = j + 1 < k ? suf[j + 1] : 1.0f;
            float x = (left * right) * ss;
            x = clamp_nan(x, -TANH_CLIP, TANH_CLIP);
            float rr = 2.0f * atanhf(x);
            if (use_alpha) rr = rr * alpha;
            r[j] = rr;
            left = left * t[j];
        }
    } else {
        // min-sum: leave-one-out sign, two minima with the first argmin,
        // optional offset, then alpha; a NaN |Q| makes every magnitude NaN
        int neg = 0;
        float min1 = fabsf(q[0]);
        int amin = 0;
        bool has_nan = false;
        for (int j = 0; j < k; ++j) {
            neg += q[j] >= 0.0f ? 0 : 1;
            const float a = fabsf(q[j]);
            has_nan |= isnan(a);
            if (a < min1) { min1 = a; amin = j; }
        }
        if (has_nan) min1 = __int_as_float(0x7fffffff);
        float min2 = __int_as_float(0x7f800000);  // +inf
        for (int j = 0; j < k; ++j)
            if (j != amin) min2 = fminf(min2, fabsf(q[j]));
        for (int j = 0; j < k; ++j) {
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

__device__ __forceinline__ float message_update(
    float qn, float q_old, float damp_new, float damp_old, int use_damping,
    float clip, int use_clip)
{
    if (use_damping) qn = damp_new * qn + damp_old * q_old;
    if (use_clip) qn = clamp_nan(qn, -clip, clip);
    return qn;
}

__global__ void st_bp_kernel(
    const uint8_t* __restrict__ syn,       // (B, T*m) 0/1 detectors
    const float* __restrict__ prior_sp,    // (T*n,)
    const float* __restrict__ prior_u,     // (T*m,)
    const int* __restrict__ check_var,     // (m, dc) base code
    const int* __restrict__ var_edge,      // (n, dv) base code, padded with E
    float* __restrict__ values_out,        // (B, T*n + T*m)
    uint8_t* __restrict__ conv_out,        // (B,)
    int* __restrict__ iters_out,           // (B,)
    int B, int T, int m, int n, int dc, int dv,
    int method, float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int max_iter, int S)
{
    extern __shared__ float smem[];
    const int E = m * dc, TE = T * E, Tm = T * m, Tn = T * n;
    const int k = dc + 2;
    float* Qs = smem;               // (S, TE)
    float* Qa = Qs + S * TE;        // (S, Tm)
    float* Qb = Qa + S * Tm;        // (S, Tm), round 0 pinned to BIG
    float* Rs = Qb + S * Tm;        // (S, TE)
    float* Ra = Rs + S * TE;        // (S, Tm)
    float* Rb = Ra + S * Tm;        // (S, Tm)
    float* Vs = Rb + S * Tm;        // (S, Tn) data posteriors
    float* Vu = Vs + S * Tn;        // (S, Tm) measurement posteriors
    uint8_t* hs = reinterpret_cast<uint8_t*>(Vu + S * Tm);  // (S, Tn)
    uint8_t* hu = hs + S * Tn;      // (S, Tm)
    uint8_t* ssyn = hu + S * Tm;    // (S, Tm)

    __shared__ int active[MAX_S];
    __shared__ int mismatch[MAX_S];
    __shared__ int conv_s[MAX_S];
    __shared__ int iters_s[MAX_S];
    __shared__ int any_active;

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int b0 = blockIdx.x * S;

    for (int i = tid; i < S * Tn; i += nt) {
        const int r = i % Tn;
        Vs[i] = prior_sp[r];
    }
    for (int i = tid; i < S * Tm; i += nt) {
        const int s = i / Tm, r = i - s * Tm, b = b0 + s;
        const float pu = prior_u[r];
        Vu[i] = pu;
        Qa[i] = pu;
        Qb[i] = r < m ? 1e9f : prior_u[r - m];
        ssyn[i] = b < B ? syn[(size_t)b * Tm + r] : 0;
    }
    for (int i = tid; i < S * TE; i += nt) {
        const int r = i % TE, t = r / E, e = r - t * E;
        Qs[i] = prior_sp[t * n + check_var[e]];
    }
    if (tid < S) {
        active[tid] = (b0 + tid) < B;
        conv_s[tid] = 0;
        iters_s[tid] = max_iter > 0 ? max_iter - 1 : 0;
    }
    __syncthreads();

    for (int it = 0; it < max_iter; ++it) {
        // ---- 1. check phase ----------------------------------------------
        for (int i = tid; i < S * Tm; i += nt) {
            const int s = i / Tm, r = i - s * Tm;
            if (!active[s]) continue;
            float q[MAX_SLOTS], rr[MAX_SLOTS];
            const float* qs = Qs + (size_t)s * TE + r * dc;
            for (int j = 0; j < dc; ++j) q[j] = qs[j];
            q[dc] = Qa[i];
            q[dc + 1] = Qb[i];
            check_rule(q, rr, k, ssyn[i] ? -1.0f : 1.0f, method,
                       alpha, use_alpha, offset, use_offset);
            float* rs = Rs + (size_t)s * TE + r * dc;
            for (int j = 0; j < dc; ++j) rs[j] = rr[j];
            Ra[i] = rr[dc];
            Rb[i] = rr[dc + 1];
        }
        if (tid < S) mismatch[tid] = 0;
        __syncthreads();

        // ---- 2. variable phase: data variables ---------------------------
        for (int i = tid; i < S * Tn; i += nt) {
            const int s = i / Tn, r = i - s * Tn;
            if (!active[s]) continue;
            const int t = r / n, v = r - t * n;
            const int* ve = var_edge + v * dv;
            const float* rs = Rs + (size_t)s * TE + t * E;
            float acc = ve[0] < E ? rs[ve[0]] : 0.0f;
            for (int j = 1; j < dv; ++j) acc = acc + (ve[j] < E ? rs[ve[j]] : 0.0f);
            const float val = acc + prior_sp[r];
            Vs[i] = val;
            hs[i] = val < 0.0f;
            float* qs = Qs + (size_t)s * TE + t * E;
            for (int j = 0; j < dv; ++j) {
                const int e = ve[j];
                if (e >= E) continue;
                qs[e] = message_update(val - rs[e], qs[e], damp_new, damp_old,
                                       use_damping, clip, use_clip);
            }
        }
        // ---- 2'. variable phase: measurement variables (a shift) ---------
        for (int i = tid; i < S * Tm; i += nt) {
            const int s = i / Tm, r = i - s * Tm;
            if (!active[s]) continue;
            const bool last = r >= Tm - m;
            const float ra = Ra[i];
            const float rb_next = last ? 0.0f : Rb[i + m];
            const float val = (ra + rb_next) + prior_u[r];
            Vu[i] = val;
            hu[i] = val < 0.0f;
            Qa[i] = message_update(val - ra, Qa[i], damp_new, damp_old,
                                   use_damping, clip, use_clip);
            if (!last)
                Qb[i + m] = message_update(val - rb_next, Qb[i + m], damp_new,
                                           damp_old, use_damping, clip, use_clip);
        }
        __syncthreads();

        // ---- 3. syndrome phase -------------------------------------------
        for (int i = tid; i < S * Tm; i += nt) {
            const int s = i / Tm, r = i - s * Tm;
            if (!active[s]) continue;
            const int t = r / m, c = r - t * m;
            const int* cv = check_var + c * dc;
            const uint8_t* h = hs + (size_t)s * Tn + t * n;
            int par = hu[i];
            if (t > 0) par ^= hu[i - m];
            for (int j = 0; j < dc; ++j) par ^= h[cv[j]];
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

    const int N = Tn + Tm;
    for (int i = tid; i < S * N; i += nt) {
        const int s = i / N, r = i - s * N, b = b0 + s;
        if (b >= B) continue;
        values_out[(size_t)b * N + r] = r < Tn ? Vs[s * Tn + r] : Vu[s * Tm + r - Tn];
    }
    if (tid < S && b0 + tid < B) {
        conv_out[b0 + tid] = (uint8_t)conv_s[tid];
        iters_out[b0 + tid] = iters_s[tid];
    }
}

extern "C" int st_bp_launch(
    const void* syn, const void* prior_sp, const void* prior_u,
    const void* check_var, const void* var_edge,
    void* values_out, void* conv_out, void* iters_out,
    int B, int T, int m, int n, int dc, int dv, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int max_iter,
    int samples_per_block, int threads, void* stream)
{
    if (dc + 2 > MAX_SLOTS || samples_per_block > MAX_S || samples_per_block < 1)
        return (int)cudaErrorInvalidValue;
    const int S = samples_per_block;
    const size_t Tm = (size_t)T * m, Tn = (size_t)T * n, TE = Tm * dc;
    const size_t smem = (size_t)S * (2 * TE + 5 * Tm + Tn) * sizeof(float)
                        + (size_t)S * (Tn + 2 * Tm);
    // opt in for every size: the static shared memory counts against the
    // same 48 KB default as the dynamic part
    cudaError_t err = cudaFuncSetAttribute(
        st_bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + S - 1) / S;
    if (blocks > 0) {
        st_bp_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)syn, (const float*)prior_sp, (const float*)prior_u,
            (const int*)check_var, (const int*)var_edge,
            (float*)values_out, (uint8_t*)conv_out, (int*)iters_out,
            B, T, m, n, dc, dv, method, alpha, use_alpha, offset, use_offset,
            damp_new, damp_old, use_damping, clip, use_clip, max_iter, S);
    }
    return (int)cudaGetLastError();
}

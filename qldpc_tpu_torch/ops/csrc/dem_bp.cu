// Flooding belief propagation on irregular Tanner graphs, in the check-slot
// layout of detector error models (K3).
//
// Replaces qldpc_tpu/ops/dem_bp_pallas.py::_check_kernel and the variable
// side fold around it (DEMPallasBPKernel._var_sum / _step). It computes what
// the plain torch version ops/dem_bp_cuda.py::dem_bp_plain computes, in the
// same floating-point order: the XLA slot path of qldpc_tpu/decoders/bp.py.
// The TPU kernel consumed streams that XLA had gathered beforehand, because
// Mosaic cannot gather; here every thread gathers its own operands.
//
// What bounds it on the card: device memory. At the [[72,12,6]] DEM
// (432 checks x 316 slots) and B = 1024 one slot-space float32 array is
// 559 MB, so the messages Q and R cannot stay on chip as K1's do; each
// iteration streams them through device memory a few times, and the
// sum-product check rule adds tanhf/logf/expf/atanhf per slot. The layout is
// slot-major with the batch minor (Q[s * B + b]): a warp handles 32
// consecutive samples of one check or variable, so every load and store of a
// message is one coalesced transaction, and the gather tables are read once
// per warp as a broadcast. Samples that have converged are skipped, and
// once a whole iteration leaves no sample active every later launch returns
// at once (per-iteration active counts on the device, no host sync).
//
// Per iteration, four launches:
//   1. check:    one thread per (check, sample): R from Q over the check's
//                real slots (phantom slots are the rule's neutral element,
//                so skipping them is exact);
//   2. variable: one thread per (variable, sample): the posterior as a left
//                fold over the variable's slots plus the prior, the hard
//                decision, then Q = posterior - R (damping, clip) per slot;
//   3. syndrome: one thread per (check, sample): parity of the hard
//                decisions of its slots against the syndrome;
//   4. freeze:   one thread per sample: a sample whose syndrome is
//                reproduced converges at this iteration.

#include <cuda_runtime.h>
#include <stdint.h>

#define LARGE_DC 16
#define TANH_CLIP 0.9999999f

// torch.clamp and torch.min propagate NaN, fminf and fmaxf drop it. A NaN
// arises under min-sum when a check of degree 1 sends an infinite magnitude
// and the variable side computes inf - inf; the plain version (like the JAX
// XLA path) then sends NaN on every slot of the checks that read it. These
// helpers and the explicit test in the min-sum rule keep the kernel equal.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi)
{
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float lo)
{
    return isnan(x) ? x : fmaxf(x, lo);
}

__global__ void dem_init_kernel(
    const float* __restrict__ prior, int ps_v, int ps_b,
    float* __restrict__ values, uint8_t* __restrict__ hard,
    uint8_t* __restrict__ conv, int* __restrict__ iters,
    uint8_t* __restrict__ mismatch, int n, int B, int max_iter)
{
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)n * B) return;
    const int v = (int)(i / B), b = (int)(i - (size_t)v * B);
    values[i] = prior[(size_t)v * ps_v + (size_t)b * ps_b];
    hard[i] = 0;
    if (v == 0) {
        conv[b] = 0;
        iters[b] = max_iter > 0 ? max_iter - 1 : 0;
        mismatch[b] = 0;
    }
}

__global__ void dem_init_q_kernel(
    const float* __restrict__ values, const int* __restrict__ var_of_slot,
    const int* __restrict__ check_deg, float* __restrict__ Q,
    int m, int dc, int B)
{
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)m * dc * B) return;
    const int s = (int)(i / B), b = (int)(i - (size_t)s * B);
    if (s % dc >= check_deg[s / dc]) return;  // phantom slot
    Q[i] = values[(size_t)var_of_slot[s] * B + b];
}

__global__ void dem_check_kernel(
    const float* __restrict__ Q, float* __restrict__ R,
    const uint8_t* __restrict__ syn_t, const int* __restrict__ check_deg,
    const uint8_t* __restrict__ conv, const int* __restrict__ active, int it,
    int m, int dc, int B, int method,
    float alpha, int use_alpha, float offset, int use_offset)
{
    if (it > 0 && active[it - 1] == 0) return;
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)m * B) return;
    const int c = (int)(i / B), b = (int)(i - (size_t)c * B);
    if (conv[b]) return;
    const int d = check_deg[c];
    const float* q = Q + (size_t)c * dc * B + b;  // slot j at q[j * B]
    float* r = R + (size_t)c * dc * B + b;
    const float ss = syn_t[i] ? -1.0f : 1.0f;
    const size_t sB = (size_t)B;

    if (method == 0 && dc > LARGE_DC) {
        // log-domain total-minus-one magnitudes, total-parity signs; the
        // log sum is folded in slot order (decoders/bp.py:250-256)
        int neg = 0;
        float total = 0.0f;
        for (int j = 0; j < d; ++j) {
            const float t = tanhf(q[j * sB] * 0.5f);
            neg += t < 0.0f;
            total = total + logf(max_nan(fabsf(t), 1e-15f));
        }
        const float tsign = (neg & 1) ? -1.0f : 1.0f;
        for (int j = 0; j < d; ++j) {
            const float t = tanhf(q[j * sB] * 0.5f);
            const float lt = logf(max_nan(fabsf(t), 1e-15f));
            const float s = t >= 0.0f ? 1.0f : -1.0f;
            const float others = expf(total - lt) * tsign * s;
            const float x = clamp_nan(others * ss, -TANH_CLIP, TANH_CLIP);
            float rr = 2.0f * atanhf(x);
            if (use_alpha) rr = rr * alpha;
            r[j * sB] = rr;
        }
    } else if (method == 0) {
        // exclusive prefix x exclusive suffix, folded sequentially
        float t[LARGE_DC], suf[LARGE_DC];
        for (int j = 0; j < d; ++j) t[j] = tanhf(q[j * sB] * 0.5f);
        if (d > 0) suf[d - 1] = t[d - 1];
        for (int j = d - 2; j >= 0; --j) suf[j] = suf[j + 1] * t[j];
        float left = 1.0f;
        for (int j = 0; j < d; ++j) {
            const float right = j + 1 < d ? suf[j + 1] : 1.0f;
            float x = (left * right) * ss;
            x = clamp_nan(x, -TANH_CLIP, TANH_CLIP);
            float rr = 2.0f * atanhf(x);
            if (use_alpha) rr = rr * alpha;
            r[j * sB] = rr;
            left = left * t[j];
        }
    } else {
        // min-sum: leave-one-out sign (exact in either form), two minima
        // with the first argmin, optional offset, then alpha. A NaN |Q|
        // makes min1 NaN, so every magnitude of the check is NaN.
        int neg = 0, amin = 0;
        bool has_nan = false;
        float min1 = __int_as_float(0x7f800000);  // +inf, the phantom |Q|
        for (int j = 0; j < d; ++j) {
            const float qj = q[j * sB];
            neg += qj < 0.0f;
            const float a = fabsf(qj);
            has_nan |= isnan(a);
            if (a < min1) { min1 = a; amin = j; }
        }
        if (has_nan) min1 = __int_as_float(0x7fffffff);
        float min2 = __int_as_float(0x7f800000);
        for (int j = 0; j < d; ++j)
            if (j != amin) min2 = fminf(min2, fabsf(q[j * sB]));
        for (int j = 0; j < d; ++j) {
            const float qj = q[j * sB];
            const int own = qj < 0.0f;
            const float sign = ((neg - own) & 1) ? -1.0f : 1.0f;
            float mag = fabsf(qj) == min1 ? min2 : min1;
            if (use_offset) mag = max_nan(mag - offset, 0.0f);
            float rr = (ss * sign) * mag;
            if (use_alpha) rr = rr * alpha;
            r[j * sB] = rr;
        }
    }
}

__global__ void dem_var_kernel(
    float* __restrict__ Q, const float* __restrict__ R,
    const float* __restrict__ prior, int ps_v, int ps_b,
    const int* __restrict__ var_slots, float* __restrict__ values,
    uint8_t* __restrict__ hard, const uint8_t* __restrict__ conv,
    const int* __restrict__ active, int it, int n, int dv, int S, int B,
    float damp_new, float damp_old, int use_damping, float clip, int use_clip)
{
    if (it > 0 && active[it - 1] == 0) return;
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)n * B) return;
    const int v = (int)(i / B), b = (int)(i - (size_t)v * B);
    if (conv[b]) return;
    const int* vs = var_slots + (size_t)v * dv;
    // pads sit at the end of a variable's row; adding their 0.0 is exact
    float acc = vs[0] < S ? R[(size_t)vs[0] * B + b] : 0.0f;
    for (int k = 1; k < dv && vs[k] < S; ++k)
        acc = acc + R[(size_t)vs[k] * B + b];
    const float val = acc + prior[(size_t)v * ps_v + (size_t)b * ps_b];
    values[i] = val;
    hard[i] = val < 0.0f;
    for (int k = 0; k < dv && vs[k] < S; ++k) {
        const size_t e = (size_t)vs[k] * B + b;
        float qn = val - R[e];
        if (use_damping) qn = damp_new * qn + damp_old * Q[e];
        if (use_clip) qn = clamp_nan(qn, -clip, clip);
        Q[e] = qn;
    }
}

__global__ void dem_syndrome_kernel(
    const uint8_t* __restrict__ hard, const uint8_t* __restrict__ syn_t,
    const int* __restrict__ var_of_slot, const int* __restrict__ check_deg,
    const uint8_t* __restrict__ conv, uint8_t* __restrict__ mismatch,
    const int* __restrict__ active, int it, int m, int dc, int B)
{
    if (it > 0 && active[it - 1] == 0) return;
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)m * B) return;
    const int c = (int)(i / B), b = (int)(i - (size_t)c * B);
    if (conv[b]) return;
    const int* vos = var_of_slot + (size_t)c * dc;
    const int d = check_deg[c];
    int par = 0;
    for (int j = 0; j < d; ++j) par ^= hard[(size_t)vos[j] * B + b];
    if (par != syn_t[i]) mismatch[b] = 1;
}

__global__ void dem_freeze_kernel(
    uint8_t* __restrict__ conv, int* __restrict__ iters,
    uint8_t* __restrict__ mismatch, int* __restrict__ active, int it, int B)
{
    if (it > 0 && active[it - 1] == 0) return;
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B || conv[b]) return;
    if (mismatch[b]) {
        mismatch[b] = 0;
        atomicAdd(active + it, 1);
    } else {
        conv[b] = 1;
        iters[b] = it;
    }
}

static unsigned grid_for(size_t count, int threads)
{
    return (unsigned)((count + threads - 1) / threads);
}

extern "C" int dem_bp_launch(
    const void* syn_t, const void* prior, int ps_v, int ps_b,
    const void* var_of_slot, const void* check_deg, const void* var_slots,
    void* values, void* hard, void* Q, void* R,
    void* conv, void* iters, void* mismatch, void* active,
    int B, int m, int n, int dc, int dv, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int max_iter, int threads, void* stream_)
{
    if (threads < 32 || threads > 1024)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    cudaStream_t stream = (cudaStream_t)stream_;
    const int S = m * dc;
    const float* P = (const float*)prior;
    float* fQ = (float*)Q;
    float* fR = (float*)R;
    float* V = (float*)values;
    uint8_t* Hd = (uint8_t*)hard;
    uint8_t* cv = (uint8_t*)conv;
    uint8_t* mm = (uint8_t*)mismatch;
    int* act = (int*)active;

    dem_init_kernel<<<grid_for((size_t)n * B, threads), threads, 0, stream>>>(
        P, ps_v, ps_b, V, Hd, cv, (int*)iters, mm, n, B, max_iter);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dem_init_q_kernel<<<grid_for((size_t)S * B, threads), threads, 0, stream>>>(
        V, (const int*)var_of_slot, (const int*)check_deg, fQ, m, dc, B);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    for (int it = 0; it < max_iter; ++it) {
        dem_check_kernel<<<grid_for((size_t)m * B, threads), threads, 0, stream>>>(
            fQ, fR, (const uint8_t*)syn_t, (const int*)check_deg, cv, act, it,
            m, dc, B, method, alpha, use_alpha, offset, use_offset);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_var_kernel<<<grid_for((size_t)n * B, threads), threads, 0, stream>>>(
            fQ, fR, P, ps_v, ps_b, (const int*)var_slots, V, Hd, cv, act, it,
            n, dv, S, B, damp_new, damp_old, use_damping, clip, use_clip);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_syndrome_kernel<<<grid_for((size_t)m * B, threads), threads, 0, stream>>>(
            Hd, (const uint8_t*)syn_t, (const int*)var_of_slot,
            (const int*)check_deg, cv, mm, act, it, m, dc, B);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_freeze_kernel<<<grid_for((size_t)B, threads), threads, 0, stream>>>(
            cv, (int*)iters, mm, act, it, B);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

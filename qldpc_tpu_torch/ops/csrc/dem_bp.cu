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
// What bounds it on the card: device memory and the transcendentals of the
// sum-product rule. At the [[144,12,12]] DEM (1728 checks, 447,948 edges)
// and B = 1024 one slot-space float32 array is 1.83 GB, so messages cannot
// stay on chip as K1's do and stream through device memory every
// iteration. The layout is slot-major with the batch minor (W[s * B + b]):
// a warp handles consecutive samples of one check or variable, so every
// load and store of a message is coalesced and the gather tables are read
// once per warp as a broadcast. Samples that have converged are skipped, and
// once a whole iteration leaves no sample active every later launch returns
// at once (per-iteration active counts on the device, no host sync).
//
// The summary path (dem_bp_words_launch) is taken under the one-pass check
// rule (dc > 16), except for sum-product with damping. There every
// check-to-variable message R_j is a function of the slot's own word and a
// per-(check, sample) summary, so R is never stored:
//   * the slot word is Q_j itself for min-sum; for sum-product it is
//     |lt_j|, lt_j = logf(max(|tanh(Q_j/2)|, 1e-15)) <= 0, with the float's
//     sign bit set where tanh(Q_j/2) < 0, so tanhf and logf run once per slot
//     (in the variable pass that writes the word) instead of twice;
//   * the summary is (total of lt in slot order, total sign times the
//     syndrome sign) for sum-product and (min1 or NaN, min2 carrying that
//     sign in its sign bit) for min-sum: 8 bytes, an (m, B) pair of planes,
//     14 MB at the [[144]] DEM, which the L2 keeps.
// Per iteration: one read of every word in the check pass, one read and one
// write in the variable pass (evict-first hints on the streamed words), and
// four transcendentals per slot instead of six. Measured on the H100 at the
// [[144]] DEM: the summary pass streams at about 3.1 TB/s with 128-bit
// accesses over four samples a thread; the variable pass is the slower one
// and runs fastest with two samples a thread (it holds dv x 2 messages in
// registers; four cost occupancy, one costs index work per sample). An L2
// persisting window on the summaries, an evict-last hint on their loads and a
// variable-major word layout were each measured and gained nothing, so the
// kernel has none of them. TMA and the tensor cores have no work here: the
// accesses are row segments of a slot-major array, already coalesced, and
// there is no product to feed.
//   1. summary:  one thread per (check, 4 samples): the check's words once,
//                folded in slot order, into its summary;
//   2. variable: one thread per (variable, 2 samples): each slot's R from
//                its word and its check's summary (the expressions of the
//                message path, kept in registers), the posterior as a left
//                fold plus the prior, the hard decision, then per slot
//                Q = posterior - R (damping for min-sum, clip) and its word;
//   3. syndrome (4 samples a thread) and 4. freeze as below.
// (One sample a thread where B is odd, and for dv > 16.)
//
// The message path (dem_bp_launch; the prefix x suffix rule at dc <= 16,
// which has no per-check summary, and sum-product with damping, which needs
// the old Q) keeps Q and R in device memory, four launches per iteration:
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
// Both paths evaluate the same expressions on the same operands in the same
// order, so on the summary path's configurations they agree bit for bit.
//
// bf16 streams (stream_dtype="bfloat16", qldpc_tpu/ops/dem_bp_pallas.py:34-41)
// are a compile-time flag (BF) of every kernel that touches a message. The
// messages round where the TPU kernel's streams round them, rd(x) being
// round-to-nearest-even to bf16 and back: R = rd(rule(Q) * alpha), and Q =
// clip(rd(posterior) - R) from the first iteration on (the posterior starts
// at the prior, R at 0); the posteriors, decisions and convergence stay
// float32, the posterior a left fold of the rounded R's plus the prior.
//   * The message path keeps the TPU kernel's 16-bit R carry and no Q: its
//     check pass gathers the posteriors (float32, n x B) and forms each Q
//     itself, and its variable pass reads the 16-bit R's. Per real slot and
//     iteration it moves 2 + 2 bytes of R in the check pass, 2 in the
//     variable pass and the gathered posterior, against 20 bytes of Q and R
//     in float32.
//   * The summary path keeps its 32-bit words: a word holds Q or its
//     sum-product encoding, and Q = rd(posterior) - rd(R) does not fit 16
//     bits. Its variable pass rounds each R in registers and forms Q from
//     the rounded posterior, so it moves the bytes of float32. (Storing rd(R)
//     in 16 bits in place of the word, and forming Q again from rd(posterior)
//     in both passes, would halve the word traffic for a second gather of
//     the posteriors and, for sum-product, a second tanhf and logf a slot.)
// Damping takes no bf16 streams, as in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

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

// x rounded to nearest even in bf16, back in float32
__device__ __forceinline__ float rd(float x)
{
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The message path's stored R: float32, or the bf16 carry under BF.
template <bool BF>
using Msg = typename std::conditional<BF, __nv_bfloat16, float>::type;

__device__ __forceinline__ float msg_f32(float x) { return x; }
__device__ __forceinline__ float msg_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool BF>
__device__ __forceinline__ Msg<BF> msg_of(float x)
{
    if constexpr (BF) return __float2bfloat16_rn(x); else return x;
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

// Under BF there is no Q array: slot j's Q is clip(rd(posterior) - R_j),
// from the posteriors and the R carry, and each R_j is read before it is
// overwritten.
template <bool BF>
__global__ void dem_check_kernel(
    const float* __restrict__ Q, Msg<BF>* __restrict__ R,
    const float* __restrict__ values, const int* __restrict__ var_of_slot,
    const uint8_t* __restrict__ syn_t, const int* __restrict__ check_deg,
    const uint8_t* __restrict__ conv, const int* __restrict__ active, int it,
    int m, int dc, int B, int method,
    float alpha, int use_alpha, float offset, int use_offset, float clip, int use_clip)
{
    if (it > 0 && active[it - 1] == 0) return;
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)m * B) return;
    const int c = (int)(i / B), b = (int)(i - (size_t)c * B);
    if (conv[b]) return;
    const int d = check_deg[c];
    const float ss = syn_t[i] ? -1.0f : 1.0f;
    const size_t sB = (size_t)B;
    Msg<BF>* r = R + (size_t)c * dc * B + b;  // slot j at r[j * B]
    auto q_at = [&](int j) -> float {
        if constexpr (BF) {
            const int v = var_of_slot[(size_t)c * dc + j];
            const float x = rd(values[(size_t)v * B + b]) - msg_f32(r[j * sB]);
            return use_clip ? clamp_nan(x, -clip, clip) : x;
        } else {
            return Q[(size_t)c * dc * B + b + j * sB];
        }
    };
    auto put = [&](int j, float x) { r[j * sB] = msg_of<BF>(x); };

    if (method == 0 && dc > LARGE_DC) {
        // log-domain total-minus-one magnitudes, total-parity signs; the
        // log sum is folded in slot order (decoders/bp.py:250-256)
        int neg = 0;
        float total = 0.0f;
        for (int j = 0; j < d; ++j) {
            const float t = tanhf(q_at(j) * 0.5f);
            neg += t < 0.0f;
            total = total + logf(max_nan(fabsf(t), 1e-15f));
        }
        const float tsign = (neg & 1) ? -1.0f : 1.0f;
        for (int j = 0; j < d; ++j) {
            const float t = tanhf(q_at(j) * 0.5f);
            const float lt = logf(max_nan(fabsf(t), 1e-15f));
            const float s = t >= 0.0f ? 1.0f : -1.0f;
            const float others = expf(total - lt) * tsign * s;
            const float x = clamp_nan(others * ss, -TANH_CLIP, TANH_CLIP);
            float rr = 2.0f * atanhf(x);
            if (use_alpha) rr = rr * alpha;
            put(j, rr);
        }
    } else if (method == 0) {
        // exclusive prefix x exclusive suffix, folded sequentially
        float t[LARGE_DC], suf[LARGE_DC];
        for (int j = 0; j < d; ++j) t[j] = tanhf(q_at(j) * 0.5f);
        if (d > 0) suf[d - 1] = t[d - 1];
        for (int j = d - 2; j >= 0; --j) suf[j] = suf[j + 1] * t[j];
        float left = 1.0f;
        for (int j = 0; j < d; ++j) {
            const float right = j + 1 < d ? suf[j + 1] : 1.0f;
            float x = (left * right) * ss;
            x = clamp_nan(x, -TANH_CLIP, TANH_CLIP);
            float rr = 2.0f * atanhf(x);
            if (use_alpha) rr = rr * alpha;
            put(j, rr);
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
            const float qj = q_at(j);
            neg += qj < 0.0f;
            const float a = fabsf(qj);
            has_nan |= isnan(a);
            if (a < min1) { min1 = a; amin = j; }
        }
        if (has_nan) min1 = __int_as_float(0x7fffffff);
        float min2 = __int_as_float(0x7f800000);
        for (int j = 0; j < d; ++j)
            if (j != amin) min2 = fminf(min2, fabsf(q_at(j)));
        for (int j = 0; j < d; ++j) {
            const float qj = q_at(j);
            const int own = qj < 0.0f;
            const float sign = ((neg - own) & 1) ? -1.0f : 1.0f;
            float mag = fabsf(qj) == min1 ? min2 : min1;
            if (use_offset) mag = max_nan(mag - offset, 0.0f);
            float rr = (ss * sign) * mag;
            if (use_alpha) rr = rr * alpha;
            put(j, rr);
        }
    }
}

template <bool BF>
__global__ void dem_var_kernel(
    float* __restrict__ Q, const Msg<BF>* __restrict__ R,
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
    float acc = vs[0] < S ? msg_f32(R[(size_t)vs[0] * B + b]) : 0.0f;
    for (int k = 1; k < dv && vs[k] < S; ++k)
        acc = acc + msg_f32(R[(size_t)vs[k] * B + b]);
    const float val = acc + prior[(size_t)v * ps_v + (size_t)b * ps_b];
    values[i] = val;
    hard[i] = val < 0.0f;
    if constexpr (!BF) {  // under BF the check pass forms Q from the posteriors
        for (int k = 0; k < dv && vs[k] < S; ++k) {
            const size_t e = (size_t)vs[k] * B + b;
            float qn = val - R[e];
            if (use_damping) qn = damp_new * qn + damp_old * Q[e];
            if (use_clip) qn = clamp_nan(qn, -clip, clip);
            Q[e] = qn;
        }
    }
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

// ---- the summary path (its Q initialisation and syndrome test serve both) --

#define MAX_DV 64
#define SIGN_BIT ((int)0x80000000)

// The sum-product slot word of Q: |lt| with the sign bit of t < 0 (a NaN t
// gives a NaN word without the bit; its messages are NaN either way).
__device__ __forceinline__ float sp_word(float q)
{
    const float t = tanhf(q * 0.5f);
    const float lt = logf(max_nan(fabsf(t), 1e-15f));
    return __int_as_float(__float_as_int(fabsf(lt)) | (t < 0.0f ? SIGN_BIT : 0));
}

// lt back from a word: lt <= 0, so -|word| (an lt of +0 comes back as -0,
// which neither the slot-order fold nor total - lt can tell apart)
__device__ __forceinline__ float word_lt(float w)
{
    return __int_as_float(__float_as_int(w) | SIGN_BIT);
}

__device__ __forceinline__ bool sign_set(float w)
{
    return __float_as_int(w) < 0;
}

// V consecutive samples of one slot or check, V in {1, 2, 4}: 64- and
// 128-bit accesses. "cs" loads and stores are evict-first (the streamed slot
// words).
template <int V>
__device__ __forceinline__ void load_cs(const float* p, float (&x)[V])
{
    if constexpr (V == 4) {
        const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else if constexpr (V == 2) {
        const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
        x[0] = t.x; x[1] = t.y;
    } else {
        x[0] = __ldcs(p);
    }
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V])
{
    if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else if constexpr (V == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        x[0] = t.x; x[1] = t.y;
    } else {
        x[0] = *p;
    }
}

template <int V>
__device__ __forceinline__ void store_cs(float* p, const float (&x)[V])
{
    if constexpr (V == 4)
        __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
    else if constexpr (V == 2)
        __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
    else
        __stcs(p, x[0]);
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V])
{
    if constexpr (V == 4)
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    else if constexpr (V == 2)
        *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    else
        *p = x[0];
}

// bit u set where sample b + u has converged
template <int V>
__device__ __forceinline__ unsigned converged_lanes(const uint8_t* conv)
{
    unsigned bits = 0;
#pragma unroll
    for (int u = 0; u < V; ++u) bits |= (conv[u] ? 1u : 0u) << u;
    return bits;
}

// R_j of the message path's sum-product rule (dem_check_kernel, dc > 16):
// others = expf(total - lt) * tsign * s, then * ss; here csign = tsign * ss,
// and products of +-1 are exact.
__device__ __forceinline__ float sp_message(float w, float total, float csign,
                                            float alpha, int use_alpha)
{
    const float s = sign_set(w) ? -1.0f : 1.0f;
    const float others = expf(total - word_lt(w)) * csign * s;
    const float x = clamp_nan(others, -TANH_CLIP, TANH_CLIP);
    float rr = 2.0f * atanhf(x);
    if (use_alpha) rr = rr * alpha;
    return rr;
}

// R_j of the message path's min-sum rule: (ss * leave-one-out sign) * mag
__device__ __forceinline__ float ms_message(float q, float min1, float smin2,
                                            float alpha, int use_alpha,
                                            float offset, int use_offset)
{
    const bool neg = sign_set(smin2) != (q < 0.0f);
    float mag = fabsf(q) == min1 ? fabsf(smin2) : min1;
    if (use_offset) mag = max_nan(mag - offset, 0.0f);
    float rr = (neg ? -1.0f : 1.0f) * mag;
    if (use_alpha) rr = rr * alpha;
    return rr;
}

// The first Q of every real slot, the prior of its variable (no clip; under
// BF clip(rd(prior))), or its sum-product word where sp_words is set.
template <bool BF>
__global__ void dem_init_q_kernel(
    const float* __restrict__ prior, int ps_v, int ps_b,
    const int* __restrict__ var_of_slot, const int* __restrict__ check_deg,
    float* __restrict__ Q, int m, int dc, int B, int sp_words, float clip, int use_clip)
{
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)m * dc * B) return;
    const int s = (int)(i / B), b = (int)(i - (size_t)s * B);
    if (s % dc >= check_deg[s / dc]) return;  // phantom slot
    float q = prior[(size_t)var_of_slot[s] * ps_v + (size_t)b * ps_b];
    if constexpr (BF) {
        q = rd(q);
        if (use_clip) q = clamp_nan(q, -clip, clip);
    }
    Q[i] = sp_words ? sp_word(q) : q;
}

template <int V>
__global__ void dem_summary_kernel(
    const float* __restrict__ W, float* __restrict__ SA, float* __restrict__ SB,
    const uint8_t* __restrict__ syn_t, const int* __restrict__ check_deg,
    const uint8_t* __restrict__ conv, const int* __restrict__ active, int it,
    int m, int dc, int B, int method)
{
    if (it > 0 && active[it - 1] == 0) return;
    const int BV = B / V;
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)m * BV) return;
    const int c = (int)(i / BV), b = (int)(i - (size_t)c * BV) * V;
    if (converged_lanes<V>(conv + b) == (1u << V) - 1) return;
    const int d = check_deg[c];
    const float* w = W + (size_t)c * dc * B + b;
    const size_t sB = (size_t)B, o = (size_t)c * B + b;
    float a[V], s[V];
    int neg[V];
    if (method == 0) {
        // the log sum folded in slot order, the parity of the negative t
        float total[V];
#pragma unroll
        for (int u = 0; u < V; ++u) { total[u] = 0.0f; neg[u] = 0; }
        for (int j = 0; j < d; ++j) {
            float x[V];
            load_cs<V>(w + j * sB, x);
#pragma unroll
            for (int u = 0; u < V; ++u) {
                neg[u] += sign_set(x[u]);
                total[u] = total[u] + word_lt(x[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
            a[u] = total[u];
            s[u] = ((neg[u] & 1) ? -1.0f : 1.0f) * (syn_t[o + u] ? -1.0f : 1.0f);
        }
    } else {
        // min1 with its first argmin and min2 over the other slots in one
        // pass: min2 is the message path's fminf over j != argmin (ties give
        // min2 == min1, a NaN |Q| is skipped by both); a NaN makes min1 NaN
        float min1[V], min2[V];
        bool has_nan[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {
            min1[u] = min2[u] = __int_as_float(0x7f800000);
            neg[u] = 0;
            has_nan[u] = false;
        }
        for (int j = 0; j < d; ++j) {
            float x[V];
            load_cs<V>(w + j * sB, x);
#pragma unroll
            for (int u = 0; u < V; ++u) {
                neg[u] += x[u] < 0.0f;
                const float q = fabsf(x[u]);
                has_nan[u] |= isnan(q);
                if (q < min1[u]) { min2[u] = min1[u]; min1[u] = q; }
                else if (q < min2[u]) min2[u] = q;
            }
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
            a[u] = has_nan[u] ? __int_as_float(0x7fffffff) : min1[u];
            const bool flip = (neg[u] & 1) != (syn_t[o + u] != 0);
            s[u] = __int_as_float(__float_as_int(min2[u]) | (flip ? SIGN_BIT : 0));
        }
    }
    store<V>(SA + o, a);
    store<V>(SB + o, s);
}

// M is the method (0 sum-product, 1 min-sum), fixed at compile time so that
// each kernel holds one rule's registers; BF rounds each R, and the
// posterior that each next Q starts from, to bf16 (no damping).
template <int DV, int V, int M, bool BF>
__global__ void dem_word_var_kernel(
    float* __restrict__ W, const float* __restrict__ SA, const float* __restrict__ SB,
    const float* __restrict__ prior, int ps_v, int ps_b,
    const int* __restrict__ var_slots, float* __restrict__ values,
    uint8_t* __restrict__ hard, const uint8_t* __restrict__ conv,
    const int* __restrict__ active, int it, int n, int dv, unsigned dc_magic, int S,
    int B, float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping, float clip, int use_clip)
{
    if (it > 0 && active[it - 1] == 0) return;
    const int BV = B / V;
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)n * BV) return;
    const int v = (int)(i / BV), b = (int)(i - (size_t)v * BV) * V;
    const unsigned done = converged_lanes<V>(conv + b);
    if (done == (1u << V) - 1) return;
    // the variable's slots in edge order, pads (S) after
    const int* vs = var_slots + (size_t)v * dv;

    // each R once, kept in registers; the posterior as a left fold over the
    // slots, then the prior; a variable in no check keeps its bare prior
    // (check = slot / dc by a multiply-high, exact for slot < 2^32 / dc)
    float r[DV][V], acc[V];
    int deg = 0;
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.0f;
#pragma unroll
    for (int k = 0; k < DV; ++k) {
        const int slot = k < dv ? vs[k] : S;
        if (slot >= S) break;
        const size_t o = (size_t)__umulhi((unsigned)slot, dc_magic) * B + b;
        float x[V], a[V], s[V];
        load_cs<V>(W + (size_t)slot * B + b, x);
        load<V>(SA + o, a);
        load<V>(SB + o, s);
#pragma unroll
        for (int u = 0; u < V; ++u) {
            r[k][u] = M == 0
                ? sp_message(x[u], a[u], s[u], alpha, use_alpha)
                : ms_message(x[u], a[u], s[u], alpha, use_alpha, offset, use_offset);
            if constexpr (BF) r[k][u] = rd(r[k][u]);
            acc[u] = k == 0 ? r[k][u] : acc[u] + r[k][u];
        }
        deg = k + 1;
    }
    float val[V];
#pragma unroll
    for (int u = 0; u < V; ++u)
        val[u] = acc[u] + prior[(size_t)v * ps_v + (size_t)(b + u) * ps_b];
    const size_t vo = (size_t)v * B + b;
    if (done == 0) store_cs<V>(values + vo, val);
#pragma unroll
    for (int u = 0; u < V; ++u) {
        if (done & (1u << u)) continue;
        if (done) values[vo + u] = val[u];
        hard[vo + u] = val[u] < 0.0f;
    }
    // the next words; min-sum damping mixes in the old Q, the word still in
    // memory. A converged lane's words are never read again.
#pragma unroll
    for (int k = 0; k < DV; ++k) {
        if (k >= deg) break;
        float* w = W + (size_t)vs[k] * B + b;
        float old[V], nw[V];
        if (use_damping) load<V>(w, old);
#pragma unroll
        for (int u = 0; u < V; ++u) {
            float qn = (BF ? rd(val[u]) : val[u]) - r[k][u];
            if (use_damping) qn = damp_new * qn + damp_old * old[u];
            if (use_clip) qn = clamp_nan(qn, -clip, clip);
            nw[u] = M == 0 ? sp_word(qn) : qn;
        }
        store_cs<V>(w, nw);
    }
}

template <int V>
__global__ void dem_syndrome_kernel(
    const uint8_t* __restrict__ hard, const uint8_t* __restrict__ syn_t,
    const int* __restrict__ var_of_slot, const int* __restrict__ check_deg,
    const uint8_t* __restrict__ conv, uint8_t* __restrict__ mismatch,
    const int* __restrict__ active, int it, int m, int dc, int B)
{
    if (it > 0 && active[it - 1] == 0) return;
    const int BV = B / V;
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)m * BV) return;
    const int c = (int)(i / BV), b = (int)(i - (size_t)c * BV) * V;
    const unsigned done = converged_lanes<V>(conv + b);
    if (done == (1u << V) - 1) return;
    const int* vos = var_of_slot + (size_t)c * dc;
    const int d = check_deg[c];
    // the V samples' 0/1 bytes side by side: one XOR folds them all
    using Word = typename std::conditional<V == 4, uint32_t, uint8_t>::type;
    Word par = 0;
    for (int j = 0; j < d; ++j)
        par ^= *reinterpret_cast<const Word*>(hard + (size_t)vos[j] * B + b);
    par ^= *reinterpret_cast<const Word*>(syn_t + (size_t)c * B + b);
#pragma unroll
    for (int u = 0; u < V; ++u)
        if (((par >> (8 * u)) & 1) && !(done & (1u << u))) mismatch[b + u] = 1;
}

// One call of the summary path: the check-side kernels take VC samples a
// thread, the variable kernel VV (measured on the H100: four samples a
// thread stream the summary pass at full rate, while the variable kernel,
// which holds DV x VV messages in registers, runs fastest with two).
template <int DV, int VC, int VV, int M, bool BF>
static int run_words(
    cudaStream_t stream, int threads, const uint8_t* syn_t, const float* P, int ps_v,
    int ps_b, const int* vos, const int* deg, const int* vslots, float* values,
    uint8_t* Hd, float* W, float* SA, float* SB, uint8_t* cv, int* iters, uint8_t* mm,
    int* act, int B, int m, int n, int dc, int dv, float alpha, int use_alpha,
    float offset, int use_offset, float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int max_iter)
{
    const int S = m * dc;
    const size_t BC = (size_t)(B / VC), BW = (size_t)(B / VV);
    const unsigned magic = (unsigned)((0x100000000ull + dc - 1) / dc);
    dem_init_kernel<<<grid_for((size_t)n * B, threads), threads, 0, stream>>>(
        P, ps_v, ps_b, values, Hd, cv, iters, mm, n, B, max_iter);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dem_init_q_kernel<BF><<<grid_for((size_t)S * B, threads), threads, 0, stream>>>(
        P, ps_v, ps_b, vos, deg, W, m, dc, B, M == 0, clip, use_clip);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int it = 0; it < max_iter; ++it) {
        dem_summary_kernel<VC><<<grid_for(m * BC, threads), threads, 0, stream>>>(
            W, SA, SB, syn_t, deg, cv, act, it, m, dc, B, M);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_word_var_kernel<DV, VV, M, BF><<<grid_for(n * BW, threads), threads, 0, stream>>>(
            W, SA, SB, P, ps_v, ps_b, vslots, values, Hd, cv, act, it, n, dv, magic, S, B,
            alpha, use_alpha, offset, use_offset, damp_new, damp_old, use_damping,
            clip, use_clip);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_syndrome_kernel<VC><<<grid_for(m * BC, threads), threads, 0, stream>>>(
            Hd, syn_t, vos, deg, cv, mm, act, it, m, dc, B);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_freeze_kernel<<<grid_for((size_t)B, threads), threads, 0, stream>>>(
            cv, iters, mm, act, it, B);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

template <int M, bool BF>
static int run_words_for(int B, int dv, cudaStream_t stream, int threads,
                         const uint8_t* syn_t, const float* P, int ps_v, int ps_b,
                         const int* vos, const int* deg, const int* vslots, float* values,
                         uint8_t* Hd, float* W, float* SA, float* SB, uint8_t* cv,
                         int* iters, uint8_t* mm, int* act, int m, int n, int dc,
                         float alpha, int use_alpha, float offset, int use_offset,
                         float damp_new, float damp_old, int use_damping, float clip,
                         int use_clip, int max_iter)
{
#define RUN(DVT, VCT, VVT)                                                               \
    return run_words<DVT, VCT, VVT, M, BF>(                                               \
        stream, threads, syn_t, P, ps_v, ps_b, vos, deg, vslots, values, Hd, W, SA, SB, \
        cv, iters, mm, act, B, m, n, dc, dv, alpha, use_alpha, offset, use_offset,      \
        damp_new, damp_old, use_damping, clip, use_clip, max_iter)
    if (dv > 16) RUN(MAX_DV, 1, 1);
    if (B % 4 == 0) RUN(16, 4, 2);
    if (B % 2 == 0) RUN(16, 1, 2);
    RUN(16, 1, 1);
#undef RUN
}

// The summary path. ``summary`` holds 2 * m * B floats (the two planes).
// Refuses dv > MAX_DV, dc <= 16 and sum-product with damping (the message
// path's cases), and bf16 with damping.
extern "C" int dem_bp_words_launch(
    const void* syn_t, const void* prior, int ps_v, int ps_b,
    const void* var_of_slot, const void* check_deg, const void* var_slots,
    void* values, void* hard, void* W, void* summary,
    void* conv, void* iters, void* mismatch, void* active,
    int B, int m, int n, int dc, int dv, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int bf16, int max_iter, int threads, void* stream_)
{
    if (threads < 32 || threads > 1024 || dv < 1 || dv > MAX_DV || dc <= LARGE_DC
        || (method == 0 && use_damping) || (bf16 && use_damping))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
    float* SA = (float*)summary;
    auto run = method == 0 ? (bf16 ? &run_words_for<0, true> : &run_words_for<0, false>)
                           : (bf16 ? &run_words_for<1, true> : &run_words_for<1, false>);
    return run(B, dv, (cudaStream_t)stream_, threads, (const uint8_t*)syn_t,
               (const float*)prior, ps_v, ps_b, (const int*)var_of_slot,
               (const int*)check_deg, (const int*)var_slots, (float*)values,
               (uint8_t*)hard, (float*)W, SA, SA + (size_t)m * B, (uint8_t*)conv,
               (int*)iters, (uint8_t*)mismatch, (int*)active, m, n, dc, alpha, use_alpha,
               offset, use_offset, damp_new, damp_old, use_damping, clip, use_clip,
               max_iter);
}

template <bool BF>
static int run_messages(
    cudaStream_t stream, int threads, const uint8_t* syn_t, const float* P, int ps_v,
    int ps_b, const int* vos, const int* deg, const int* vslots, float* V, uint8_t* Hd,
    float* fQ, Msg<BF>* R, uint8_t* cv, int* iters, uint8_t* mm, int* act, int B, int m,
    int n, int dc, int dv, int method, float alpha, int use_alpha, float offset,
    int use_offset, float damp_new, float damp_old, int use_damping, float clip,
    int use_clip, int max_iter)
{
    const int S = m * dc;
    dem_init_kernel<<<grid_for((size_t)n * B, threads), threads, 0, stream>>>(
        P, ps_v, ps_b, V, Hd, cv, iters, mm, n, B, max_iter);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if constexpr (BF) {  // R starts at 0 (bf16 zero is all bits clear)
        err = cudaMemsetAsync(R, 0, (size_t)S * B * sizeof(Msg<BF>), stream);
    } else {
        dem_init_q_kernel<false><<<grid_for((size_t)S * B, threads), threads, 0, stream>>>(
            P, ps_v, ps_b, vos, deg, fQ, m, dc, B, 0, clip, use_clip);
        err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;

    for (int it = 0; it < max_iter; ++it) {
        dem_check_kernel<BF><<<grid_for((size_t)m * B, threads), threads, 0, stream>>>(
            fQ, R, V, vos, syn_t, deg, cv, act, it,
            m, dc, B, method, alpha, use_alpha, offset, use_offset, clip, use_clip);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_var_kernel<BF><<<grid_for((size_t)n * B, threads), threads, 0, stream>>>(
            fQ, R, P, ps_v, ps_b, vslots, V, Hd, cv, act, it,
            n, dv, S, B, damp_new, damp_old, use_damping, clip, use_clip);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_syndrome_kernel<1><<<grid_for((size_t)m * B, threads), threads, 0, stream>>>(
            Hd, syn_t, vos, deg, cv, mm, act, it, m, dc, B);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dem_freeze_kernel<<<grid_for((size_t)B, threads), threads, 0, stream>>>(
            cv, iters, mm, act, it, B);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

// The message path. ``Q`` and ``R`` are (S, B) float32; under bf16 ``R`` is
// (S, B) bf16 and ``Q`` is not read. Refuses bf16 with damping.
extern "C" int dem_bp_launch(
    const void* syn_t, const void* prior, int ps_v, int ps_b,
    const void* var_of_slot, const void* check_deg, const void* var_slots,
    void* values, void* hard, void* Q, void* R,
    void* conv, void* iters, void* mismatch, void* active,
    int B, int m, int n, int dc, int dv, int method,
    float alpha, int use_alpha, float offset, int use_offset,
    float damp_new, float damp_old, int use_damping,
    float clip, int use_clip, int bf16, int max_iter, int threads, void* stream_)
{
    if (threads < 32 || threads > 1024 || (bf16 && use_damping))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaSuccess;
#define RUN(BFT)                                                                          \
    return run_messages<BFT>(                                                            \
        (cudaStream_t)stream_, threads, (const uint8_t*)syn_t, (const float*)prior, ps_v, \
        ps_b, (const int*)var_of_slot, (const int*)check_deg, (const int*)var_slots,      \
        (float*)values, (uint8_t*)hard, (float*)Q, (Msg<BFT>*)R, (uint8_t*)conv,          \
        (int*)iters, (uint8_t*)mismatch, (int*)active, B, m, n, dc, dv, method, alpha,    \
        use_alpha, offset, use_offset, damp_new, damp_old, use_damping, clip, use_clip,   \
        max_iter)
    if (bf16) RUN(true);
    RUN(false);
#undef RUN
}
